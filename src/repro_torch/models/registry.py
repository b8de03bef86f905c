"""ModelBundle: one functional API over the ported architecture families.

Counterpart of ``repro/models/registry.py``, holding only the fields the
serving path reads.  Family dispatch happens once, here: the dense and
MoE LM families, and the SSM and hybrid families (mamba2, zamba2).

* ``init(seed, device) -> params``
* ``apply_train(params, batch) -> (logits, aux)`` — full teacher-forced pass
* ``prefill(params, batch) -> (last_logits, cache)``
* ``decode_step(params, cache, batch) -> (logits, cache)``
* ``make_cache(batch, cache_len, device)`` / ``make_slot_cache(...)``
* ``prefill_slotted`` / ``decode_slotted`` — per-slot lengths (serving)
* ``prefill_paged`` / ``decode_paged`` / ``make_paged_cache(slots,
  cache_len, n_blocks, block_size, device)`` / ``paged_cache_specs`` — the
  paged KV cache (a block pool shared by every slot)
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import hybrid as M_hybrid
from repro_torch.models import transformer as M_lm


@dataclasses.dataclass
class ModelBundle:
    cfg: ModelConfig
    init: Callable[..., Any]
    apply_train: Callable[[Any, Dict[str, Any]],
                          Tuple[torch.Tensor, torch.Tensor]]
    prefill: Callable[[Any, Dict[str, Any]], Tuple[torch.Tensor, Any]]
    decode_step: Callable[[Any, Any, Dict[str, Any]],
                          Tuple[torch.Tensor, Any]]
    make_cache: Callable[..., Any]
    cache_specs: Callable[[], Any]
    # slot-cache serving path: ``prefill_slotted(params, {"tokens": (B, L),
    # "lens": (B,), "cache_len": int})``, ``decode_slotted(params, cache,
    # {"tokens": (B, 1), "active": (B,) bool})``; ``prefill_pads`` says
    # whether prefill_slotted accepts right-padded prompts.
    prefill_slotted: Optional[Callable[[Any, Dict[str, Any]],
                                       Tuple[torch.Tensor, Any]]] = None
    decode_slotted: Optional[Callable[[Any, Any, Dict[str, Any]],
                                      Tuple[torch.Tensor, Any]]] = None
    make_slot_cache: Optional[Callable[..., Any]] = None
    prefill_pads: bool = False
    # paged serving path: ``prefill_paged(params, {"tokens", "lens"})``
    # returns unpadded K/V rows; ``decode_paged(params, cache, {"tokens",
    # "active"})`` reads and writes the block pool through cache["tables"]
    prefill_paged: Optional[Callable] = None
    decode_paged: Optional[Callable] = None
    make_paged_cache: Optional[Callable] = None
    paged_cache_specs: Optional[Callable] = None


def _lm_bundle(cfg: ModelConfig) -> ModelBundle:
    def apply_train(params, batch):
        return M_lm.lm_forward(params, cfg, tokens=batch["tokens"],
                               positions=batch.get("positions"))

    def prefill(params, batch):
        return M_lm.lm_prefill(params, cfg, tokens=batch["tokens"],
                               positions=batch.get("positions"),
                               cache_len=batch["cache_len"])

    def decode_step(params, cache, batch):
        return M_lm.lm_decode_step(params, cache, batch["tokens"], cfg)

    def prefill_slotted(params, batch):
        return M_lm.lm_prefill_slotted(params, cfg, tokens=batch["tokens"],
                                       lens=batch["lens"],
                                       cache_len=batch["cache_len"])

    def decode_slotted(params, cache, batch):
        return M_lm.lm_decode_step_slotted(params, cache, batch["tokens"],
                                           batch["active"], cfg)

    def prefill_paged(params, batch):
        return M_lm.lm_prefill_paged(params, cfg, tokens=batch["tokens"],
                                     lens=batch["lens"])

    def decode_paged(params, cache, batch):
        return M_lm.lm_decode_step_paged(params, cache, batch["tokens"],
                                         batch["active"], cfg)

    def make_paged_cache(slots, cache_len, n_blocks, block_size,
                         device=None):
        return M_lm.init_paged_cache(cfg, slots, cache_len, n_blocks,
                                     block_size, device=device)

    return ModelBundle(
        cfg=cfg,
        init=lambda seed=0, device=None: M_lm.init_lm(seed, cfg, device),
        apply_train=apply_train,
        prefill=prefill,
        decode_step=decode_step,
        make_cache=lambda b, s, device=None: M_lm.init_cache(
            cfg, b, s, device=device),
        cache_specs=lambda: M_lm.cache_specs(cfg),
        prefill_slotted=prefill_slotted,
        decode_slotted=decode_slotted,
        make_slot_cache=lambda b, s, device=None: M_lm.init_slot_cache(
            cfg, b, s, device=device),
        prefill_pads=True,
        prefill_paged=prefill_paged,
        decode_paged=decode_paged,
        make_paged_cache=make_paged_cache,
        paged_cache_specs=lambda: M_lm.paged_cache_specs(cfg),
    )


def _hybrid_bundle(cfg: ModelConfig) -> ModelBundle:
    def apply_train(params, batch):
        return M_hybrid.hybrid_forward(params, cfg, tokens=batch["tokens"])

    def prefill(params, batch):
        return M_hybrid.hybrid_prefill(params, cfg, tokens=batch["tokens"],
                                       cache_len=batch["cache_len"])

    def decode_step(params, cache, batch):
        return M_hybrid.hybrid_decode_step(params, cache, batch["tokens"],
                                           cfg)

    def prefill_slotted(params, batch):
        return M_hybrid.hybrid_prefill_slotted(
            params, cfg, tokens=batch["tokens"], lens=batch["lens"],
            cache_len=batch["cache_len"])

    def decode_slotted(params, cache, batch):
        return M_hybrid.hybrid_decode_step_slotted(
            params, cache, batch["tokens"], batch["active"], cfg)

    def prefill_paged(params, batch):
        return M_hybrid.hybrid_prefill_paged(
            params, cfg, tokens=batch["tokens"], lens=batch["lens"])

    def decode_paged(params, cache, batch):
        return M_hybrid.hybrid_decode_step_paged(
            params, cache, batch["tokens"], batch["active"], cfg)

    def make_paged_cache(slots, cache_len, n_blocks, block_size,
                         device=None):
        return M_hybrid.init_hybrid_paged_cache(
            cfg, slots, cache_len, n_blocks, block_size, device=device)

    return ModelBundle(
        cfg=cfg,
        init=lambda seed=0, device=None: M_hybrid.init_hybrid(seed, cfg,
                                                              device),
        apply_train=apply_train,
        prefill=prefill,
        decode_step=decode_step,
        make_cache=lambda b, s, device=None: M_hybrid.init_hybrid_cache(
            cfg, b, s, device=device),
        cache_specs=lambda: M_hybrid.hybrid_cache_specs(cfg),
        prefill_slotted=prefill_slotted,
        decode_slotted=decode_slotted,
        make_slot_cache=lambda b, s, device=None:
            M_hybrid.init_hybrid_slot_cache(cfg, b, s, device=device),
        prefill_pads=False,
        prefill_paged=prefill_paged,
        decode_paged=decode_paged,
        make_paged_cache=make_paged_cache,
        paged_cache_specs=lambda: M_hybrid.hybrid_paged_cache_specs(cfg),
    )


def build_model(cfg: ModelConfig) -> ModelBundle:
    if cfg.family in ("ssm", "hybrid"):
        return _hybrid_bundle(cfg)
    M_lm.check_family(cfg)
    return _lm_bundle(cfg)
