"""Shared building blocks: norms, RoPE, init.

Counterpart of ``repro/models/common.py`` (norms, ``rope_freqs``,
``apply_rope``, init), and of ``repro/models/transformer.py: _remat``.
Parameters are plain nested dicts of tensors with the reference's ``(in,
out)`` matrix layout, so ``x @ W`` reads the same in both packages.
M-RoPE, the sinusoidal tables and the logical-axis specs belong to
families a later slice ports.
"""
from __future__ import annotations

import functools
import math
from typing import Any, Callable, Dict, Tuple

import torch
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
)

# ---------------------------------------------------------------------------
# Norms (f32 inside, cast back to the input dtype)
# ---------------------------------------------------------------------------


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-5
            ) -> torch.Tensor:
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * scale.float()).to(x.dtype)


def layernorm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
              eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = (xf - mu).square().mean(dim=-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * scale.float() + bias.float()).to(x.dtype)


def apply_norm(kind: str, x: torch.Tensor, p: Dict[str, torch.Tensor],
               eps: float) -> torch.Tensor:
    if kind == "rmsnorm":
        return rmsnorm(x, p["scale"], eps)
    return layernorm(x, p["scale"], p["bias"], eps)


def init_norm(kind: str, d: int, device: torch.device
              ) -> Dict[str, torch.Tensor]:
    p = {"scale": torch.ones((d,), dtype=torch.float32, device=device)}
    if kind == "layernorm":
        p["bias"] = torch.zeros((d,), dtype=torch.float32, device=device)
    return p


# ---------------------------------------------------------------------------
# Rotary embeddings (half-split convention, as the reference)
# ---------------------------------------------------------------------------


def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float
               ) -> torch.Tensor:
    """x: (B, S, H, hd); positions: (B, S) int. Half-split, not interleaved:
    the first half of ``hd`` rotates against the second half."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, device=x.device)            # (hd/2,)
    angles = positions.to(torch.float32)[..., None] * freqs    # (B,S,hd/2)
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Init helpers (torch.Generator in place of jax.random keys)
# ---------------------------------------------------------------------------


def _trunc_normal(shape: Tuple[int, ...], std: float,
                  gen: torch.Generator) -> torch.Tensor:
    # jax.random.truncated_normal(-2, 2) * std truncates at +-2 sigma;
    # trunc_normal_ takes absolute bounds, hence a/b scaled by std.
    t = torch.empty(shape, dtype=torch.float32, device=gen.device)
    return torch.nn.init.trunc_normal_(t, mean=0.0, std=std, a=-2.0 * std,
                                       b=2.0 * std, generator=gen)


def dense_init(gen: torch.Generator, shape: Tuple[int, ...],
               in_axis_size: int) -> torch.Tensor:
    return _trunc_normal(shape, 1.0 / math.sqrt(max(in_axis_size, 1)), gen)


def embed_init(gen: torch.Generator, shape: Tuple[int, ...]) -> torch.Tensor:
    return _trunc_normal(shape, 0.02, gen)


def cast_tree(tree: Any, dtype: torch.dtype) -> Any:
    """Cast every floating leaf of a nested dict/list tree to ``dtype``."""
    if isinstance(tree, dict):
        return {k: cast_tree(v, dtype) for k, v in tree.items()}
    if isinstance(tree, list):
        return [cast_tree(v, dtype) for v in tree]
    return tree.to(dtype) if tree.is_floating_point() else tree


# ---------------------------------------------------------------------------
# Rematerialisation (cfg.remat), taken only where a gradient is taken
# ---------------------------------------------------------------------------

# Products with no batch dimension, the ops whose outputs the reference's
# ``checkpoint_dots_with_no_batch_dims`` policy saves: ``x @ W`` dispatches
# to these; attention's batched einsums (bmm) and the grouped matmul are
# recomputed.
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _save_dots(ctx, op, *args, **kwargs) -> CheckpointPolicy:
    return CheckpointPolicy.MUST_SAVE if op in _DOTS \
        else CheckpointPolicy.PREFER_RECOMPUTE


def remat_call(mode: str, fn: Callable, *args) -> Any:
    """``fn(*args)`` under ``cfg.remat``: ``"full"`` saves only the inputs
    and recomputes the rest in the backward (``jax.checkpoint``),
    ``"dots"`` also saves the products without batch dims, ``"none"``
    saves everything.  Without a gradient (serving, ``no_grad``) it is a
    plain call whatever the mode."""
    if mode == "none" or not torch.is_grad_enabled():
        return fn(*args)
    if mode == "dots":
        return checkpoint(fn, *args, use_reentrant=False,
                          context_fn=functools.partial(
                              create_selective_checkpoint_contexts,
                              _save_dots))
    if mode != "full":
        raise ValueError(f"unknown remat mode {mode!r}")
    return checkpoint(fn, *args, use_reentrant=False)
