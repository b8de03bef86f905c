"""Shared building blocks: norms, RoPE, init.

Counterpart of ``repro/models/common.py`` (norms, ``rope_freqs``,
``apply_rope``, ``apply_mrope``, ``sinusoidal_positions``, init), and of
``repro/models/transformer.py: _remat``.  Parameters are plain nested
dicts of tensors with the reference's ``(in, out)`` matrix layout, so
``x @ W`` reads the same in both packages.  ``norm_specs`` gives a norm's
logical axes, as the reference's.
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

from repro_torch.distributed.sharding import (
    axis_rules,
    current_mesh,
    current_rules,
)
from repro_torch.kernels._launches import is_fake

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


def norm_specs(kind: str) -> Dict[str, Tuple]:
    """Logical axis names of a norm's params, as ``repro``'s."""
    p = {"scale": (None,)}
    if kind == "layernorm":
        p["bias"] = (None,)
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
    return rope_at(x, positions, rope_freqs(x.shape[-1], theta,
                                            device=x.device))


def rope_at(x: torch.Tensor, positions: torch.Tensor, freqs: torch.Tensor
            ) -> torch.Tensor:
    """:func:`apply_rope` by the frequencies ``freqs`` (hd/2,) f32 that
    :func:`rope_freqs` made."""
    angles = positions.to(torch.float32)[..., None] * freqs    # (B,S,hd/2)
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


@functools.lru_cache(maxsize=None)
def _mrope_components(sections: Tuple[int, int, int], device: torch.device
                      ) -> torch.Tensor:
    """The position component (0 t, 1 h, 2 w) of each rotary frequency,
    made once a device: ``repeat_interleave`` with repeats on the card
    would wait for them on the host at every call."""
    return torch.repeat_interleave(torch.arange(3),
                                   torch.tensor(sections)).to(device)


def apply_mrope(x: torch.Tensor, positions: torch.Tensor, theta: float,
                sections: Tuple[int, int, int]) -> torch.Tensor:
    """Qwen2-VL multimodal RoPE.  x: (B, S, H, hd); positions: (3, B, S),
    the temporal, height and width position ids.  The rotary half-dim is
    split into three sections, each rotated by its own position component
    (arXiv:2409.12191 section 2.1); half-split as :func:`apply_rope`."""
    hd = x.shape[-1]
    half = hd // 2
    if sum(sections) != half:
        raise ValueError(f"M-RoPE sections {sections} do not sum to "
                         f"head_dim / 2 = {half}")
    freqs = rope_freqs(hd, theta, device=x.device)            # (half,)
    sec_id = _mrope_components(tuple(sections), x.device)     # (half,)
    pos = positions.to(torch.float32).index_select(0, sec_id)  # (half,B,S)
    angles = pos.movedim(0, -1) * freqs                        # (B,S,half)
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def sinusoid(pos: torch.Tensor, d_model: int) -> torch.Tensor:
    """Whisper-style sinusoidal embeddings of f32 positions ``pos`` (...,)
    -> (..., d_model): sines of ``pos * exp(-ln(10000) * 2i / d_model)`` in
    the first half, cosines in the second."""
    dim = torch.arange(0, d_model, 2, dtype=torch.float32, device=pos.device)
    inv = torch.exp(-math.log(10000.0) * dim / d_model)
    ang = pos[..., None] * inv
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def sinusoidal_positions(length: int, d_model: int, device=None
                         ) -> torch.Tensor:
    """:func:`sinusoid` of positions 0..length-1: (length, d_model), f32."""
    return sinusoid(torch.arange(length, dtype=torch.float32, device=device),
                    d_model)


# ---------------------------------------------------------------------------
# Init helpers (torch.Generator in place of jax.random keys)
# ---------------------------------------------------------------------------


def _trunc_normal(shape: Tuple[int, ...], std: float,
                  gen: torch.Generator) -> torch.Tensor:
    # jax.random.truncated_normal(-2, 2) * std truncates at +-2 sigma;
    # trunc_normal_ takes absolute bounds, hence a/b scaled by std.
    t = torch.empty(shape, dtype=torch.float32, device=gen.device)
    if is_fake(t):      # shapes only, under FakeTensorMode (the dry run)
        return t
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


def _under_rules(rules, mesh, fn: Callable, *args) -> Any:
    with axis_rules(rules, mesh):
        return fn(*args)


def remat_call(mode: str, fn: Callable, *args) -> Any:
    """``fn(*args)`` under ``cfg.remat``: ``"full"`` saves only the inputs
    and recomputes the rest in the backward (``jax.checkpoint``),
    ``"dots"`` also saves the products without batch dims, ``"none"``
    saves everything.  Without a gradient (serving, ``no_grad``) it is a
    plain call whatever the mode.  The recomputation runs under the
    sharding rules of the call (it may run on autograd's own thread, where
    the thread-local rules are not installed)."""
    if mode == "none" or not torch.is_grad_enabled():
        return fn(*args)
    rules, mesh = current_rules(), current_mesh()
    if mesh is not None:
        fn = functools.partial(_under_rules, rules, mesh, fn)
    if mode == "dots":
        return checkpoint(fn, *args, use_reentrant=False,
                          context_fn=functools.partial(
                              create_selective_checkpoint_contexts,
                              _save_dots))
    if mode != "full":
        raise ValueError(f"unknown remat mode {mode!r}")
    return checkpoint(fn, *args, use_reentrant=False)
