"""Unified model configuration covering all assigned architecture families.

One dataclass describes dense / MoE / SSM / hybrid / enc-dec / VLM configs;
family-specific fields are zero/None when unused.  Every assigned arch gets a
``configs/<id>.py`` exporting ``CONFIG`` built from the published numbers
(sources cited in the file).

A copy of ``repro/configs/base.py``: the port imports nothing of ``repro``,
and keeping the dataclass field for field lets one config describe a model
to both packages.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                  # dense | moe | ssm | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int = 0
    n_kv_heads: int = 0
    head_dim: int = 0            # 0 -> d_model // n_heads
    d_ff: int = 0
    vocab_size: int = 0

    # --- attention details ---------------------------------------------
    qk_norm: bool = False        # qwen3
    qkv_bias: bool = False       # qwen2
    rope_theta: float = 1e4
    mrope: bool = False          # qwen2-vl M-RoPE (3-section rotary)
    mrope_sections: Tuple[int, int, int] = (16, 24, 24)  # t/h/w halves
    attn_chunk: int = 512        # KV block size of the chunked reference

    # --- MoE -------------------------------------------------------------
    n_experts: int = 0
    experts_per_token: int = 0
    moe_d_ff: int = 0            # per-expert hidden width
    n_shared_experts: int = 0
    capacity_factor: float = 1.25
    moe_impl: str = "sort"       # sort (pjit) | ep_a2a (shard_map a2a EP)

    # --- SSM (mamba2 / SSD) ----------------------------------------------
    ssm_state: int = 0           # N
    ssm_head_dim: int = 64       # P
    ssm_expand: int = 2          # d_inner = expand * d_model
    ssm_groups: int = 1          # B/C groups G
    ssm_chunk: int = 256         # SSD chunk length Q
    conv_kernel: int = 4

    # --- hybrid (zamba2) ---------------------------------------------------
    attn_period: int = 0         # shared attn block every `attn_period` SSM layers

    # --- enc-dec (whisper) --------------------------------------------------
    n_dec_layers: int = 0        # encoder gets n_layers
    dec_ratio: int = 8           # train/prefill decoder len = seq // dec_ratio

    # --- frontend stubs -----------------------------------------------------
    frontend: str = "none"       # none | audio | vision  (stub embeddings)

    # --- numerics / norms ----------------------------------------------------
    norm: str = "rmsnorm"        # rmsnorm | layernorm
    act: str = "swiglu"          # swiglu | gelu
    tie_embeddings: bool = False
    dtype: str = "bfloat16"      # activation/param dtype
    norm_eps: float = 1e-5

    # --- training-time knobs (per-arch defaults; launcher may override) ------
    remat: str = "full"          # full | dots | none
    chunked_loss: bool = False   # fused chunked unembed+xent (§Perf C2' —
                                 # numerically equivalent; OFF by default:
                                 # on the CPU-backend metrics the plain path
                                 # measured better; re-evaluate on TPU)
    microbatches: int = 1        # gradient-accumulation splits of global batch
    optimizer: str = "adamw"     # adamw | adafactor
    fsdp_axes: Tuple[str, ...] = ("data",)   # axes params are FSDP-sharded over
    grad_acc_dtype: str = "float32"  # microbatch grad accumulator dtype

    # ------------------------------------------------------------------ utils
    @property
    def resolved_head_dim(self) -> int:
        if self.head_dim:
            return self.head_dim
        return self.d_model // max(self.n_heads, 1)

    @property
    def d_inner(self) -> int:            # SSM inner width
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    @property
    def attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def sub_quadratic(self) -> bool:
        """Eligible for the long_500k cell (assignment rule)."""
        return self.family in ("ssm", "hybrid")

    def param_count(self) -> int:
        """Analytic parameter count (embeddings included once if tied)."""
        d, hd = self.d_model, self.resolved_head_dim
        n = 0
        if self.family in ("dense", "moe", "vlm", "hybrid"):
            # attention stack
            if self.family == "hybrid":
                n_attn = 1  # shared block counted once
                n_ssm = self.n_layers
            else:
                n_attn = self.n_layers
                n_ssm = 0
            attn = (d * self.n_heads * hd + 2 * d * self.n_kv_heads * hd
                    + self.n_heads * hd * d)
            if self.qkv_bias:
                attn += (self.n_heads + 2 * self.n_kv_heads) * hd
            n += n_attn * (attn + 2 * d)  # + norms
            if self.family == "moe":
                expert = 3 * d * self.moe_d_ff
                mlp = (self.n_experts + self.n_shared_experts) * expert \
                    + d * self.n_experts
                n += self.n_layers * (mlp + d)
            elif self.family == "hybrid":
                n += n_attn * 3 * d * self.d_ff  # shared MLP
                n += n_ssm * self._ssm_block_params()
            else:
                mults = 3 if self.act == "swiglu" else 2
                n += self.n_layers * (mults * d * self.d_ff + d)
        elif self.family == "ssm":
            n += self.n_layers * (self._ssm_block_params() + d)
        elif self.family == "encdec":
            attn = 4 * d * self.n_heads * hd
            mults = 3 if self.act == "swiglu" else 2
            enc = self.n_layers * (attn + mults * d * self.d_ff + 2 * d)
            dec = self.n_dec_layers * (2 * attn + mults * d * self.d_ff + 3 * d)
            n += enc + dec
        n += self.vocab_size * d  # embed
        if not self.tie_embeddings:
            n += self.vocab_size * d
        n += d  # final norm
        return n

    def _ssm_block_params(self) -> int:
        d, di = self.d_model, self.d_inner
        g, ns, h = self.ssm_groups, self.ssm_state, self.ssm_heads
        in_proj = d * (2 * di + 2 * g * ns + h)
        conv = self.conv_kernel * (di + 2 * g * ns)
        extra = 3 * h  # A_log, D, dt_bias
        out_proj = di * d
        return in_proj + conv + extra + out_proj + di  # + gated norm

    def active_param_count(self) -> int:
        """Active params per token (== param_count for non-MoE)."""
        if self.family != "moe":
            return self.param_count()
        total = self.param_count()
        inactive_experts = self.n_experts - self.experts_per_token
        per_expert = 3 * self.d_model * self.moe_d_ff
        return total - self.n_layers * inactive_experts * per_expert
