"""Public ops: decode attention over a dense cache and over a paged block
pool (hand-written CUDA kernel on the card, the plain PyTorch version on
the CPU).

Counterparts of ``repro/kernels/decode_attention/ops.py:
decode_attention`` and ``paged_decode_attention``.  The tensor's device
picks the path: a CPU tensor goes to the plain version in ``ref.py``, a
CUDA tensor to the kernel in ``csrc/decode_attention.cu`` or the call
raises.  There is no fallback from the kernel to the plain version.  The
reference's ``paged_decode_attention_chunked`` is its CPU/GPU speed path,
not a kernel, and has no counterpart here.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch import _build
from repro_torch.kernels._launches import (
    count_launch,
    is_fake,
    record_fake_call,
)
from repro_torch.kernels.decode_attention.ref import (
    decode_attention_ref,
    paged_decode_attention_ref,
)

HEAD_DIMS = (32, 64, 112, 128)
MAX_TABLE_BLOCKS = 2048     # kMaxTableBlocks in csrc/decode_attention.cu
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


@functools.cache
def _launcher():
    fn = _build.load("decode_attention").decode_attention_launch
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _paged_launcher():
    fn = _build.load("decode_attention").paged_decode_attention_launch
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 8 \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _check(q, k, v, kv_len, rows: int) -> None:
    """What both kernels take: q (B, H, hd) and k/v (rows, *, KVH, hd) of
    one dtype and a head dim the kernel is built for, any GQA ratio H / KVH
    (on the card one cluster reads a KV head's cache once for all of its
    group's rows, up to 64), kv_len (B,) int32; all contiguous on one
    device."""
    if q.dim() != 3 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"want q (B,H,hd), k/v 4-d of one shape; got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    b, h, hd = q.shape
    kvh = k.shape[2]
    if k.shape[0] != rows or k.shape[3] != hd or h % kvh:
        raise ValueError(f"q {tuple(q.shape)} does not match k/v "
                         f"{tuple(k.shape)}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"head_dim {hd} (supported {HEAD_DIMS})")
    if kv_len.shape != (b,) or kv_len.dtype != torch.int32:
        raise ValueError(f"kv_len must be ({b},) int32, got "
                         f"{tuple(kv_len.shape)} {kv_len.dtype}")
    if q.dtype not in _DTYPE_CODE or k.dtype != q.dtype \
            or v.dtype != q.dtype:
        raise ValueError(f"dtypes {q.dtype}/{k.dtype}/{v.dtype}: want one "
                         f"of float32, bfloat16 for q, k and v alike")
    if len({t.device for t in (q, k, v, kv_len)}) != 1:
        raise ValueError("q, k, v and kv_len must share one device")
    if not all(t.is_contiguous() for t in (q, k, v, kv_len)):
        raise ValueError("q, k, v and kv_len must be contiguous")


def _record_fake(name: str, q, kvh: int, span: int, blocks: int = 0
                 ) -> None:
    """A fake call's work by the bound's formula (chip_smoke.py:
    ``bound_ms``): kv_len has no values here, so every row attends to all
    ``span`` positions of its cache; 4 H hd flops a position; q read and
    the output written, K and V read at those positions, kv_len and the
    ``blocks`` table entries a row read."""
    b, h, hd = q.shape
    item = q.element_size()
    record_fake_call(name, 4 * h * hd * b * span,
                     2 * q.numel() * item + 2 * b * span * kvh * hd * item
                     + 4 * b + 4 * b * blocks)


def _cuda_ready(name: str, q, k, v) -> None:
    if q.device.type != "cuda":
        raise ValueError(f"no {name} for device {q.device}")
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("q, k and v must be 16-byte aligned")


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     kv_len: torch.Tensor) -> torch.Tensor:
    """Single-token GQA attention. q: (B,H,hd); k/v: (B,S,KVH,hd);
    kv_len: (B,) int32 valid prefix lengths (>= 1).  Returns (B,H,hd) in
    q's dtype.  ``decode_attention.launches`` counts kernel launches."""
    _check(q, k, v, kv_len, q.shape[0])
    if is_fake(q, k, v, kv_len):
        _record_fake("decode_attention", q, k.shape[2], k.shape[1])
        return torch.empty_like(q)
    if q.device.type == "cpu":
        return decode_attention_ref(q, k, v, kv_len)
    _cuda_ready("decode_attention", q, k, v)
    b, h, hd = q.shape
    s, kvh = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    if b == 0:
        return out
    launch = _launcher()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = launch(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                     kv_len.data_ptr(), out.data_ptr(), b, s, h, kvh, hd,
                     _DTYPE_CODE[q.dtype], stream)
    if err:
        raise RuntimeError(f"decode_attention kernel launch failed: CUDA "
                           f"error {err}")
    count_launch(decode_attention)
    return out


decode_attention.launches = 0


def paged_decode_attention(q: torch.Tensor, k_pages: torch.Tensor,
                           v_pages: torch.Tensor, tables: torch.Tensor,
                           kv_len: torch.Tensor) -> torch.Tensor:
    """Single-token GQA attention over a block pool. q: (B,H,hd);
    k/v_pages: (P,BS,KVH,hd); tables: (B,NB) int32 block tables (entries
    >= P are sentinels, clamped and never read); kv_len: (B,) int32 valid
    logical prefix lengths (clamped to NB*BS).  Returns (B,H,hd) in q's
    dtype.  ``paged_decode_attention.launches`` counts kernel launches."""
    _check(q, k_pages, v_pages, kv_len, k_pages.shape[0])
    b = q.shape[0]
    if tables.dim() != 2 or tables.shape[0] != b \
            or tables.dtype != torch.int32:
        raise ValueError(f"tables must be ({b}, NB) int32, got "
                         f"{tuple(tables.shape)} {tables.dtype}")
    if tables.device != q.device or not tables.is_contiguous():
        raise ValueError("tables must be contiguous on q's device")
    if not 0 < tables.shape[1] <= MAX_TABLE_BLOCKS:
        raise ValueError(f"{tables.shape[1]} table blocks a row (supported "
                         f"1..{MAX_TABLE_BLOCKS})")
    if is_fake(q, k_pages, v_pages, tables, kv_len):
        _record_fake("paged_decode_attention", q, k_pages.shape[2],
                     tables.shape[1] * k_pages.shape[1], tables.shape[1])
        return torch.empty_like(q)
    if q.device.type == "cpu":
        return paged_decode_attention_ref(q, k_pages, v_pages, tables,
                                          kv_len)
    _cuda_ready("paged_decode_attention", q, k_pages, v_pages)
    _, h, hd = q.shape
    n_pages, bs, kvh = k_pages.shape[:3]
    out = torch.empty_like(q)
    if b == 0:
        return out
    launch = _paged_launcher()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = launch(q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
                     tables.data_ptr(), kv_len.data_ptr(), out.data_ptr(),
                     b, h, kvh, hd, n_pages, bs, tables.shape[1],
                     _DTYPE_CODE[q.dtype], stream)
    if err:
        raise RuntimeError(f"paged_decode_attention kernel launch failed: "
                           f"CUDA error {err}")
    count_launch(paged_decode_attention)
    return out


paged_decode_attention.launches = 0
