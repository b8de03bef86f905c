"""Routed mixture-of-experts with sort-based, capacity-bounded dispatch.

Counterpart of ``repro/models/moe.py``, its sort path (``moe_block``
without a mesh; ``moe_block_ep``'s shard_map all-to-all waits for the
TPU-pod tooling):

1. top-k routing per token (ties to the lower expert id, as XLA's top_k);
2. stable-sort the (token, expert) pairs by expert id;
3. position-in-segment gives each pair a slot in a fixed ``(E, capacity,
   D)`` buffer; pairs past an expert's capacity are dropped (their
   contribution falls back to the residual stream);
4. the expert FFN: ``gmm`` (the hand-written grouped-matmul kernel on the
   card) for gate, up and down, where ``repro`` writes
   ``einsum('ecd,edf->ecf')``;
5. combine, weighted by the renormalised router gates.

On the card, ``repro``'s scatter-adds would be atomics, so bf16 sums would
change from run to run.  Here dispatch is an assignment (each kept slot
receives one row; dropped pairs go to a spare row past the buffer), and
the combine gathers each token's k rows and sums them over k in a fixed
order.  Nothing in the block syncs with the host: ``cap`` is a Python int
from the token count.
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.moe_gmm import gmm
from repro_torch.models.common import dense_init


def init_moe(gen: torch.Generator, cfg: ModelConfig,
             dtype: torch.dtype = torch.float32) -> Dict[str, torch.Tensor]:
    """The reference's draws (fan-in truncated normals), each matrix cast
    to ``dtype`` as soon as it is drawn: one f32 expert matrix of
    dbrx-132b is 4.2 GB."""
    d, f, e = cfg.d_model, cfg.moe_d_ff, cfg.n_experts

    def draw(shape, fan_in):
        return dense_init(gen, shape, fan_in).to(dtype)
    p = {
        "router": draw((d, e), d),
        "gate": draw((e, d, f), d),
        "up": draw((e, d, f), d),
        "down": draw((e, f, d), f),
    }
    if cfg.n_shared_experts:
        fs = cfg.moe_d_ff * cfg.n_shared_experts
        p["shared_gate"] = draw((d, fs), d)
        p["shared_up"] = draw((d, fs), d)
        p["shared_down"] = draw((fs, d), fs)
    return p


def moe_specs(cfg: ModelConfig, prefix: Tuple = ()) -> Dict[str, Tuple]:
    """Logical axis names of each MoE param, as ``repro``'s."""
    p = {
        "router": prefix + ("embed", None),
        "gate": prefix + ("experts", "embed", "expert_mlp"),
        "up": prefix + ("experts", "embed", "expert_mlp"),
        "down": prefix + ("experts", "expert_mlp", "embed"),
    }
    if cfg.n_shared_experts:
        p["shared_gate"] = prefix + ("embed", "mlp")
        p["shared_up"] = prefix + ("embed", "mlp")
        p["shared_down"] = prefix + ("mlp", "embed")
    return p


def expert_capacity(n_tokens: int, cfg: ModelConfig) -> int:
    cap = math.ceil(n_tokens * cfg.experts_per_token / cfg.n_experts
                    * cfg.capacity_factor)
    return max(8, -(-cap // 8) * 8)  # round up to a multiple of 8


def route(p: Dict[str, torch.Tensor], xf: torch.Tensor, cfg: ModelConfig
          ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """xf: (T, D) -> (probs (T, E) f32, gates (T, k) f32 renormalised,
    experts (T, k) int64).  A stable descending sort keeps the lower
    expert id first among equal probabilities, as XLA's top_k does."""
    logits = (xf @ p["router"].to(xf.dtype)).float()
    probs = torch.softmax(logits, dim=-1)
    top, experts = torch.sort(probs, dim=-1, descending=True, stable=True)
    k = cfg.experts_per_token
    gates, experts = top[:, :k], experts[:, :k]
    gates = gates / gates.sum(-1, keepdim=True).clamp_min(1e-9)
    return probs, gates, experts


def moe_block(p: Dict[str, torch.Tensor], x: torch.Tensor, cfg: ModelConfig
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, D) -> (out (B, S, D), aux_loss scalar f32)."""
    b, s, d = x.shape
    e, k = cfg.n_experts, cfg.experts_per_token
    t = b * s
    xf = x.reshape(t, d)
    probs, gates, experts = route(p, xf, cfg)

    # Switch-style load-balance auxiliary loss; counts by comparison, not
    # by scatter, so the block stays free of atomics.
    flat_e = experts.reshape(-1)                            # (T*k,)
    counts = (flat_e[:, None] == torch.arange(e, device=x.device)).sum(0)
    aux = e * torch.sum(probs.mean(dim=0) * (counts.float() / (t * k)))

    # ---- sort-based dispatch -------------------------------------------
    cap = expert_capacity(t, cfg)
    order = torch.argsort(flat_e, stable=True)
    sorted_e = flat_e[order]
    seg_start = torch.cumsum(counts, 0) - counts            # (E,)
    pos = torch.arange(t * k, device=x.device) - seg_start[sorted_e]
    keep = pos < cap
    # each kept pair's row of the flattened (E*cap, D) buffer; dropped
    # pairs all land on the spare row E*cap, which is cut off
    slot = torch.where(keep, sorted_e * cap + pos, e * cap)
    buf = torch.zeros((e * cap + 1, d), dtype=x.dtype, device=x.device)
    buf.index_put_((slot,), xf[order // k])
    buf = buf[:e * cap].view(e, cap, d)

    # ---- expert FFN (the moe_gmm contraction) ---------------------------
    h = F.silu(gmm(buf, p["gate"].to(x.dtype))) \
        * gmm(buf, p["up"].to(x.dtype))
    out_buf = gmm(h, p["down"].to(x.dtype)).view(e * cap, d)

    # ---- combine: each pair's row in (token, k) order, summed over k ---
    slot_of = torch.empty_like(slot).scatter_(0, order, slot)
    kept = slot_of < e * cap
    vals = out_buf[torch.where(kept, slot_of, 0)]          # (T*k, D)
    contrib = vals * gates.reshape(-1, 1).to(x.dtype)
    contrib = torch.where(kept[:, None], contrib, torch.zeros_like(contrib))
    y = contrib.view(t, k, d).sum(dim=1)

    if cfg.n_shared_experts:
        hs = F.silu(xf @ p["shared_gate"].to(x.dtype)) \
            * (xf @ p["shared_up"].to(x.dtype))
        y = y + hs @ p["shared_down"].to(x.dtype)
    return y.reshape(b, s, d), aux
