"""Public op: decode attention (hand-written CUDA kernel on the card, the
plain PyTorch version on the CPU).

Counterpart of ``repro/kernels/decode_attention/ops.py: decode_attention``.
The tensor's device picks the path: a CPU tensor goes to
:func:`decode_attention_ref`, a CUDA tensor to the kernel in
``csrc/decode_attention.cu`` or the call raises.  There is no fallback
from the kernel to the plain version.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch import _build
from repro_torch.kernels.decode_attention.ref import decode_attention_ref

HEAD_DIMS = (32, 64, 128)
MAX_REP = 8
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


@functools.cache
def _launcher():
    fn = _build.load("decode_attention").decode_attention_launch
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _check(q, k, v, kv_len) -> None:
    if q.dim() != 3 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"want q (B,H,hd), k/v (B,S,KVH,hd); got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    b, h, hd = q.shape
    kvh = k.shape[2]
    if k.shape[0] != b or k.shape[3] != hd or h % kvh:
        raise ValueError(f"q {tuple(q.shape)} does not match k/v "
                         f"{tuple(k.shape)}")
    if hd not in HEAD_DIMS or h // kvh > MAX_REP:
        raise ValueError(f"head_dim {hd} (supported {HEAD_DIMS}) or GQA "
                         f"ratio {h // kvh} (supported <= {MAX_REP})")
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


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     kv_len: torch.Tensor) -> torch.Tensor:
    """Single-token GQA attention. q: (B,H,hd); k/v: (B,S,KVH,hd);
    kv_len: (B,) int32 valid prefix lengths (>= 1).  Returns (B,H,hd) in
    q's dtype.  ``decode_attention.launches`` counts kernel launches."""
    _check(q, k, v, kv_len)
    if q.device.type == "cpu":
        return decode_attention_ref(q, k, v, kv_len)
    if q.device.type != "cuda":
        raise ValueError(f"no decode_attention for device {q.device}")
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("q, k and v must be 16-byte aligned")
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
    decode_attention.launches += 1
    return out


decode_attention.launches = 0
