"""A decoder layer's glue, fused where the call allows it.

The glue is the elementwise work between a layer's products: each
residual add and the RMSNorm after it, RoPE on q and k (and, in the paged
decode step, the K/V rows' write to the pool), and SwiGLU.  Run as PyTorch
ops it is about 76 kernels a layer; ``kernels/glue`` does it in one launch
a site.  Every site is one call here, and each call picks its path from
what it sees (:func:`fused`): the fused op on CUDA bf16 tensors of an
RMSNorm model with plain RoPE, under no mesh and where no gradient flows
through the site; PyTorch's ops, exactly as before, anywhere else (the
CPU, training, the mesh paths, a LayerNorm family, M-RoPE).  In inference
every site of a forward sees the same, so a layer runs fused whole or not
at all.

Sites are counted through ``kernels/_launches.py``'s counters
(:data:`SITES`, by path ``fused`` and ``torch``), so that a CUDA graph's
replay counts the sites its capture saw.  :func:`recorded` wraps an entry
point so that each call records a ``model.glue`` span, attrs ``(fused,
torch)``: the sites of that call on each path (``trace.py``;
``models/decode_graph.py`` records it for the paged decode step).
"""
from __future__ import annotations

import functools
from types import SimpleNamespace
from typing import Callable, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.sharding import (
    current_mesh,
    is_dtensor,
    logical_constraint,
)
from repro_torch.kernels import glue as ops
from repro_torch.kernels._launches import count_launch, is_fake
from repro_torch.models.common import apply_norm, rope_freqs
from repro_torch.trace import TRACER

# The device type whose tensors take the fused ops (a test may point it at
# the CPU, where the ops run their plain versions).
DEVICE = "cuda"


# The glue sites' counter, by path
SITES = SimpleNamespace(launches=0, launches_by_path={"fused": 0, "torch": 0})


def grad_taken(*ts: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in ts)


def fused(cfg: ModelConfig, x: torch.Tensor,
          *more: Optional[torch.Tensor]) -> bool:
    """Whether a glue site over the activation ``x`` (and the other
    tensors it reads, ``more``) runs the fused op."""
    if x.device.type != DEVICE or x.dtype != torch.bfloat16 \
            or cfg.norm != "rmsnorm" or cfg.mrope \
            or current_mesh() is not None:
        return False
    ts = (x, *(t for t in more if t is not None))
    return not (grad_taken(*ts) or any(is_dtensor(t) for t in ts)
                or is_fake(*ts))


def site(path: str) -> None:
    """One glue site run on ``path`` (``fused`` or ``torch``)."""
    count_launch(SITES, path)


def site_counts() -> Tuple[int, int]:
    """(fused, torch) sites counted so far."""
    by = SITES.launches_by_path
    return by["fused"], by["torch"]


def record_span(t0: int, before: Tuple[int, int]) -> None:
    """A ``model.glue`` span from ``t0`` (``TRACER.now()``) to now, with
    the sites counted since ``before`` (:func:`site_counts`)."""
    fused_n, torch_n = site_counts()
    TRACER.record("model.glue", t0, (fused_n - before[0],
                                     torch_n - before[1]))


def recorded(fn: Callable) -> Callable:
    """``fn``, each call recording a ``model.glue`` span (tracer on)."""
    @functools.wraps(fn)
    def call(*args, **kwargs):
        if not TRACER.on:
            return fn(*args, **kwargs)
        t0, before = TRACER.now(), site_counts()
        out = fn(*args, **kwargs)
        record_span(t0, before)
        return out
    return call


@functools.lru_cache(maxsize=None)
def _freqs(head_dim: int, theta: float, device: torch.device
           ) -> torch.Tensor:
    """:func:`rope_freqs` once a (head_dim, theta, device): the same ops
    on the same device, so the same f32 values as every call's own."""
    return rope_freqs(head_dim, theta, device=device)


# ---------------------------------------------------------------------------
# The sites
# ---------------------------------------------------------------------------


def add_norm(x: torch.Tensor, a: Optional[torch.Tensor],
             p: Dict[str, torch.Tensor], cfg: ModelConfig, *,
             constrain: bool = False,
             pick: Optional[Callable] = None
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """A sublayer boundary: (h, its norm by ``p``), h = x + a (x where
    ``a`` is None), placed as the rules place the residual stream where
    ``constrain``; ``pick`` (where given) keeps only some rows of h, as
    ``pick(h)``, before the norm."""
    if fused(cfg, x, a, p["scale"]):
        site("fused")
        if pick is not None:
            x = pick(x).contiguous()
            a = None if a is None else pick(a).contiguous()
        return ops.add_rmsnorm(x, a, p["scale"], cfg.norm_eps)
    site("torch")
    h = x if a is None else x + a
    if constrain:
        h = logical_constraint(h, "batch", "seq", None)
    if pick is not None:
        h = pick(h)
    return h, apply_norm(cfg.norm, h, p, cfg.norm_eps)


def rope(q: torch.Tensor, k: torch.Tensor,
         positions: Optional[torch.Tensor], cfg: ModelConfig
         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The fused RoPE of q and k at ``positions`` (B, S), or at 0..S-1
    where None (a site :func:`fused` chose)."""
    site("fused")
    hd = q.shape[-1]
    return ops.rope(q, k, positions, _freqs(hd, cfg.rope_theta, q.device))


def rope_write(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               kv_lens: torch.Tensor, write, dst, cfg: ModelConfig
               ) -> torch.Tensor:
    """A paged decode step's fused RoPE at ``kv_lens`` (B,) less one that
    writes the rotated k and the v to the pools ``dst`` where ``write``
    (``attention.paged_write_index``) says; returns the rotated q (B, 1,
    H, hd)."""
    site("fused")
    rows, blk, off = write
    if not isinstance(rows, slice):   # only the rows kept write
        b = q.shape[0]
        blk = blk.new_full((b,), -1).index_copy_(0, rows, blk)
        off = off.new_zeros((b,)).index_copy_(0, rows, off)
    return ops.rope_write(q, k, v, kv_lens,
                          _freqs(q.shape[-1], cfg.rope_theta, q.device),
                          dst[0], dst[1], blk, off)


def swiglu(g: torch.Tensor, u: torch.Tensor, cfg: ModelConfig
           ) -> torch.Tensor:
    """``F.silu(g) * u``."""
    if fused(cfg, g, u):
        site("fused")
        return ops.swiglu(g, u)
    site("torch")
    return F.silu(g) * u

