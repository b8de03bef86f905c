"""Config registry: ``get_config(arch_id)`` + reduced smoke variants.

Mirrors ``repro/configs/__init__.py``: every arch id of the reference has
a config module here (its copy), as do the shape cells (``shapes.py``)
and HALF's own search-space defaults (``half_ecg.py``).
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Dict, List

from repro_torch.configs.base import ModelConfig

ARCH_MODULES: Dict[str, str] = {
    "qwen2-0.5b": "qwen2_0_5b",
    "qwen3-4b": "qwen3_4b",
    "granite-34b": "granite_34b",
    "mistral-large-123b": "mistral_large_123b",
    "qwen2-vl-2b": "qwen2_vl_2b",
    "dbrx-132b": "dbrx_132b",
    "kimi-k2-1t-a32b": "kimi_k2_1t",
    "mamba2-780m": "mamba2_780m",
    "zamba2-7b": "zamba2_7b",
    "whisper-tiny": "whisper_tiny",
}

ALL_ARCHS: List[str] = list(ARCH_MODULES)


def get_config(arch: str) -> ModelConfig:
    if arch not in ARCH_MODULES:
        raise KeyError(f"unknown arch {arch!r}; choose from {ALL_ARCHS}")
    mod = importlib.import_module(
        f"repro_torch.configs.{ARCH_MODULES[arch]}")
    return mod.CONFIG


def reduced_config(arch: str, dtype: str = "float32") -> ModelConfig:
    """Same-family reduced config for CPU smoke tests: few layers, narrow
    widths, tiny vocab — exercises every code path the full config uses.
    Field for field the reduction of ``repro.configs.reduced_config``."""
    cfg = get_config(arch)
    n_groups = 2 if cfg.attn_period else 0
    changes = dict(
        name=cfg.name + "-smoke",
        n_layers=min(cfg.n_layers, (n_groups * cfg.attn_period + 1)
                     if cfg.attn_period else 3),
        n_dec_layers=min(cfg.n_dec_layers, 2),
        d_model=128,
        n_heads=min(cfg.n_heads, 4) if cfg.n_heads else 0,
        n_kv_heads=0,
        head_dim=32 if cfg.head_dim else 0,
        d_ff=192 if cfg.d_ff else 0,
        vocab_size=min(cfg.vocab_size, 512),
        n_experts=min(cfg.n_experts, 8),
        experts_per_token=min(cfg.experts_per_token, 2),
        moe_d_ff=64 if cfg.moe_d_ff else 0,
        ssm_state=min(cfg.ssm_state, 16),
        ssm_head_dim=16 if cfg.ssm_state else 64,
        ssm_chunk=16,
        attn_chunk=64,
        dtype=dtype,
        remat="none",
        microbatches=1,
        mrope_sections=(4, 6, 6) if cfg.mrope else cfg.mrope_sections,
    )
    if cfg.n_heads:
        # preserve the GQA ratio class: MQA stays MQA, MHA stays MHA
        if cfg.n_kv_heads == 1:
            changes["n_kv_heads"] = 1
        elif cfg.n_kv_heads == cfg.n_heads:
            changes["n_kv_heads"] = changes["n_heads"]
        else:
            changes["n_kv_heads"] = max(changes["n_heads"] // 2, 1)
    return dataclasses.replace(cfg, **changes)
