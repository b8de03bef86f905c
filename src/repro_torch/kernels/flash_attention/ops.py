"""Public op: causal GQA flash attention for prefill (hand-written CUDA
kernel on the card, the plain PyTorch version on the CPU).

Counterpart of ``repro/kernels/flash_attention/ops.py: flash_attention``
with ``causal=True`` over a full sequence (Sq == Sk, q_offset 0), the
product ``attention_prefill`` needs.  The tensor's device picks the path:
a CPU tensor goes to the plain version in ``ref.py``, a CUDA tensor to the
kernel in ``csrc/flash_attention.cu`` or the call raises.  There is no
fallback from the kernel to the plain version.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch import _build
from repro_torch.kernels._launches import count_launch
from repro_torch.kernels.flash_attention.ref import flash_attention_ref

HEAD_DIMS = (32, 64, 112, 128)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
# what the C entry point reports it launched: the CUDA-core kernel (f32)
# or the tensor-core kernel (bf16)
PATHS = ("fma", "wgmma")
# TMA, which feeds the tensor-core kernel, takes 16-byte aligned bases only
_TMA_ALIGN = 16


@functools.cache
def _launcher():
    fn = _build.load("flash_attention").flash_attention_launch
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 \
        + [ctypes.c_void_p, ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int
    return fn


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor
                    ) -> torch.Tensor:
    """Causal GQA attention. q: (B, S, H, hd); k/v: (B, S, KVH, hd), one
    dtype, H % KVH == 0.  Returns (B, S, H, hd) in q's dtype, computed in
    f32.  ``flash_attention.launches`` counts kernel launches, and
    ``flash_attention.launches_by_path`` counts them by the path the
    kernel's entry point took (``PATHS``).  Both paths refuse what the
    kernel does not take, so what runs on the CPU runs on the card."""
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"want q (B,S,H,hd), k/v (B,S,KVH,hd) of one shape;"
                         f" got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    b, s, h, hd = q.shape
    kvh = k.shape[2]
    if k.shape[:2] != (b, s) or k.shape[3] != hd or kvh < 1 or h % kvh:
        raise ValueError(f"q {tuple(q.shape)} does not match k/v "
                         f"{tuple(k.shape)} (causal prefill: Sq == Sk)")
    if hd not in HEAD_DIMS:
        raise ValueError(f"head_dim {hd} (supported {HEAD_DIMS})")
    if s < 1:
        raise ValueError("empty sequence")
    if q.dtype not in _DTYPE_CODE or k.dtype != q.dtype \
            or v.dtype != q.dtype:
        raise ValueError(f"dtypes {q.dtype}/{k.dtype}/{v.dtype}: want one "
                         f"of float32, bfloat16 for q, k and v alike")
    if k.device != q.device or v.device != q.device:
        raise ValueError("q, k and v must share one device")
    if not all(t.is_contiguous() for t in (q, k, v)):
        raise ValueError("q, k and v must be contiguous")
    if q.dtype == torch.bfloat16 and any(
            t.data_ptr() % _TMA_ALIGN for t in (q, k, v)):
        raise ValueError(f"bfloat16 q, k and v must start on a "
                         f"{_TMA_ALIGN}-byte boundary")
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v)
    if q.device.type != "cuda":
        raise ValueError(f"no flash_attention for device {q.device}")
    out = torch.empty_like(q)
    launch = _launcher()
    path = ctypes.c_int(-1)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = launch(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                     out.data_ptr(), b, s, h, kvh, hd, _DTYPE_CODE[q.dtype],
                     stream, ctypes.byref(path))
    if err:
        raise RuntimeError(f"flash_attention kernel launch failed: CUDA "
                           f"error {err}")
    count_launch(flash_attention, PATHS[path.value])
    return out


flash_attention.launches = 0
flash_attention.launches_by_path = dict.fromkeys(PATHS, 0)
