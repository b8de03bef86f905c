"""Public ops: a decoder layer's glue, fused (hand-written CUDA kernels on
the card, the plain PyTorch versions on the CPU).

``add_rmsnorm`` (a residual add and the next RMSNorm), ``rope`` and
``rope_write`` (RoPE on q and k; the decode step's form also writes the
rotated k and the v to a paged pool) and ``swiglu``.  They replace no
kernel of ``repro``: XLA fuses these ops there.  The tensor's device picks
the path: a CPU tensor goes to the plain versions (the models' own ops,
``ref.py`` for the pool write), a CUDA tensor to the kernels in
``csrc/glue.cu`` or the call raises.  There is no
fallback from a kernel to a plain version.  Each op counts its launches in
``launches``, ``rope`` and ``add_rmsnorm`` also by path.  Where the models
call them is ``models/glue.py``.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch import _build
from repro_torch.kernels._launches import count_launch
from repro_torch.kernels.glue.ref import rope_write_ref
from repro_torch.models.common import rmsnorm, rope_at

_SCALE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_POS_CODE = {torch.int32: 0, torch.int64: 1}


@functools.cache
def _launchers():
    """The C entry points (norm, rope, swiglu) of the built library."""
    lib = _build.load("glue")
    norm, rope, swiglu = (lib.glue_add_rmsnorm_launch, lib.glue_rope_launch,
                          lib.glue_swiglu_launch)
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    norm.argtypes = [p] * 5 + [i, i, ctypes.c_float, i, p]
    rope.argtypes = [p] * 4 + [i, ll, ll, i] + [p] * 7 + [i] * 6 + [p]
    swiglu.argtypes = [p] * 3 + [ll, p]
    for fn in (norm, rope, swiglu):
        fn.restype = ctypes.c_int
    return norm, rope, swiglu


def _bf16(name: str, *ts: torch.Tensor) -> None:
    for t in ts:
        if t.dtype != torch.bfloat16 or not t.is_contiguous():
            raise ValueError(f"{name}: want contiguous bfloat16 tensors, got "
                             f"{t.dtype} {tuple(t.shape)} "
                             f"{'' if t.is_contiguous() else 'strided'}")


def _one_device(name: str, *ts: Optional[torch.Tensor]) -> torch.device:
    devs = {t.device for t in ts if t is not None}
    if len(devs) != 1:
        raise ValueError(f"{name}: tensors on {sorted(map(str, devs))}")
    return devs.pop()


def _launch(name: str, fn, device: torch.device, *args) -> None:
    with torch.cuda.device(device):
        err = fn(*args, torch.cuda.current_stream(device).cuda_stream)
    if err:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")


def _ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


def add_rmsnorm(x: torch.Tensor, a: Optional[torch.Tensor],
                scale: torch.Tensor, eps: float
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(h, y): h = x + a (``x`` itself where ``a`` is None) and h's
    RMSNorm, f32 inside, times ``scale`` (d,) f32 or bf16, in bf16.  x and
    a (..., d) contiguous bf16.  On the card one launch; y may differ from
    the plain version by one bf16 ulp (the sum of squares' order)."""
    d = x.shape[-1]
    _bf16("add_rmsnorm", x, *(() if a is None else (a,)))
    if a is not None and a.shape != x.shape:
        raise ValueError(f"add_rmsnorm: x {tuple(x.shape)} and a "
                         f"{tuple(a.shape)} differ")
    if scale.shape != (d,) or scale.dtype not in _SCALE_CODE \
            or not scale.is_contiguous():
        raise ValueError(f"add_rmsnorm: want a contiguous ({d},) f32 or "
                         f"bf16 scale, got {scale.dtype} "
                         f"{tuple(scale.shape)}")
    dev = _one_device("add_rmsnorm", x, a, scale)
    if dev.type == "cpu":
        h = x if a is None else x + a
        return h, rmsnorm(h, scale, eps)
    h = x if a is None else torch.empty_like(x)
    y = torch.empty_like(x)
    rows = x.numel() // d if d else 0
    if rows:
        _launch("add_rmsnorm", _launchers()[0], dev, x.data_ptr(), _ptr(a),
                scale.data_ptr(), _ptr(None if a is None else h),
                y.data_ptr(), rows, d, eps, _SCALE_CODE[scale.dtype])
        count_launch(add_rmsnorm, "norm" if a is None else "add")
    return h, y


add_rmsnorm.launches = 0
add_rmsnorm.launches_by_path = {"add": 0, "norm": 0}


def _rope_check(q: torch.Tensor, k: torch.Tensor,
                positions: Optional[torch.Tensor],
                inv_freq: torch.Tensor) -> None:
    _bf16("rope", q, k)
    if q.dim() != 4 or k.dim() != 4 or q.shape[:2] != k.shape[:2] \
            or q.shape[3] != k.shape[3] or q.shape[3] % 2:
        raise ValueError(f"rope: want q (B,S,H,hd) and k (B,S,KVH,hd), hd "
                         f"even; got {tuple(q.shape)}, {tuple(k.shape)}")
    if positions is not None and (positions.shape != q.shape[:2]
                                  or positions.dtype not in _POS_CODE):
        raise ValueError(f"rope: want positions {tuple(q.shape[:2])} int32 "
                         f"or int64, got {positions.dtype} "
                         f"{tuple(positions.shape)}")
    if inv_freq.shape != (q.shape[3] // 2,) \
            or inv_freq.dtype != torch.float32 \
            or not inv_freq.is_contiguous():
        raise ValueError(f"rope: want contiguous ({q.shape[3] // 2},) f32 "
                         f"frequencies, got {inv_freq.dtype} "
                         f"{tuple(inv_freq.shape)}")


def _rope_launch(q, k, v, positions, pos_add, inv_freq, q_out, k_out,
                 pools, blk, off) -> None:
    b, s, h, hd = q.shape
    pos = (None, 0, 0, 0, 0) if positions is None else (
        positions.data_ptr(), _POS_CODE[positions.dtype],
        positions.stride(0), positions.stride(1), pos_add)
    k_pool, v_pool = pools
    _launch("rope", _launchers()[1], q.device, q.data_ptr(), k.data_ptr(),
            _ptr(v), *pos, inv_freq.data_ptr(), q_out.data_ptr(),
            _ptr(k_out), _ptr(k_pool), _ptr(v_pool), _ptr(blk), _ptr(off),
            b, s, h, k.shape[2], hd,
            0 if k_pool is None else k_pool.shape[1])


def rope(q: torch.Tensor, k: torch.Tensor,
         positions: Optional[torch.Tensor], inv_freq: torch.Tensor
         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """q (B,S,H,hd) and k (B,S,KVH,hd) rotated half-split at ``positions``
    (B,S) int32 or int64, any strides, or at 0..S-1 where None, by the f32
    frequencies ``inv_freq`` (hd/2,); new tensors.  On the card one
    launch, equal to the plain version bit for bit."""
    _rope_check(q, k, positions, inv_freq)
    dev = _one_device("rope", q, k, positions, inv_freq)
    if dev.type == "cpu":
        if positions is None:
            positions = torch.arange(q.shape[1])[None].expand(q.shape[:2])
        return rope_at(q, positions, inv_freq), \
            rope_at(k, positions, inv_freq)
    q_out, k_out = torch.empty_like(q), torch.empty_like(k)
    if q.numel():
        _rope_launch(q, k, None, positions, 0, inv_freq, q_out, k_out,
                     (None, None), None, None)
        count_launch(rope, "rotate")
    return q_out, k_out


def rope_write(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               kv_lens: torch.Tensor, inv_freq: torch.Tensor,
               k_pool: torch.Tensor, v_pool: torch.Tensor,
               blk: torch.Tensor, off: torch.Tensor) -> torch.Tensor:
    """A decode step's :func:`rope` (q, k, v (B,1,heads,hd)) at the
    step's positions, ``kv_lens`` (B,) int32 or int64 less one, that writes
    row b's rotated k and its v into the pools (P,BS,KVH,hd) at block
    ``blk[b]``, offset ``off[b]`` (int64 (B,)), and nothing where
    ``blk[b] < 0``; no two rows may name one position, and a block past the
    pool is not checked on the card.  Returns the rotated q.  On the card
    one launch, equal to the plain version bit for bit."""
    positions = kv_lens[:, None]
    _rope_check(q, k, positions, inv_freq)
    _bf16("rope_write", v, k_pool, v_pool)
    b = q.shape[0]
    if q.shape[1] != 1 or v.shape != k.shape or k_pool.shape != v_pool.shape \
            or k_pool.dim() != 4 or k_pool.shape[2:] != k.shape[2:]:
        raise ValueError(f"rope_write: want q (B,1,H,hd), k and v "
                         f"(B,1,KVH,hd), pools (P,BS,KVH,hd); got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}, {tuple(k_pool.shape)}")
    for t in (blk, off):
        if t.shape != (b,) or t.dtype != torch.int64 \
                or not t.is_contiguous():
            raise ValueError(f"rope_write: want ({b},) int64 blocks and "
                             f"offsets, got {t.dtype} {tuple(t.shape)}")
    dev = _one_device("rope_write", q, k, v, kv_lens, inv_freq, k_pool,
                      v_pool, blk, off)
    if dev.type == "cpu":
        return rope_write_ref(q, k, v, kv_lens, inv_freq, k_pool, v_pool,
                              blk, off)
    q_out = torch.empty_like(q)
    if b:
        _rope_launch(q, k, v, positions, -1, inv_freq, q_out, None,
                     (k_pool, v_pool), blk, off)
        count_launch(rope, "write")
    return q_out


rope.launches = 0
rope.launches_by_path = {"rotate": 0, "write": 0}


def swiglu(g: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """``F.silu(g) * u`` of two contiguous bf16 tensors of one shape.  On
    the card one launch, equal to the plain version bit for bit."""
    _bf16("swiglu", g, u)
    if g.shape != u.shape:
        raise ValueError(f"swiglu: g {tuple(g.shape)} and u "
                         f"{tuple(u.shape)} differ")
    dev = _one_device("swiglu", g, u)
    if dev.type == "cpu":
        return F.silu(g) * u
    out = torch.empty_like(g)
    if g.numel():
        _launch("swiglu", _launchers()[2], dev, g.data_ptr(), u.data_ptr(),
                out.data_ptr(), g.numel())
        count_launch(swiglu)
    return out


swiglu.launches = 0
