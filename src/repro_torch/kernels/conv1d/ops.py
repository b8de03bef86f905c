"""Public op: fused depthwise-separable conv1d (hand-written CUDA kernel on
the card, the plain PyTorch version on the CPU).

Counterpart of ``repro/kernels/conv1d/ops.py: dwsep_conv1d``.  The
tensor's device picks the path: a CPU tensor goes to the plain version in
``ref.py``, a CUDA tensor to the kernel in ``csrc/dwsep_conv1d.cu`` or the
call raises.  There is no fallback from the kernel to the plain version.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch import _build
from repro_torch.kernels._launches import count_launch
from repro_torch.kernels.conv1d.ref import dwsep_conv1d_ref

KERNEL_SIZES = (1, 3, 5, 7)
STRIDES = (1, 2, 4)
MAX_C_IN = 32          # kMaxCin in csrc/dwsep_conv1d.cu
MAX_C_OUT = 1024       # kMaxCout in csrc/dwsep_conv1d.cu
TILE = 128             # positions a tile (kTile in csrc/dwsep_conv1d.cu)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


@functools.cache
def _launcher():
    fn = _build.load("dwsep_conv1d").dwsep_conv1d_launch
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 9 \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def dwsep_conv1d(x: torch.Tensor, dw: torch.Tensor, pw: torch.Tensor,
                 b: torch.Tensor, *, stride: int = 1,
                 relu: bool = True) -> torch.Tensor:
    """Fused depthwise-separable 1D convolution, VALID padding.

    x: (B, L, C_in); dw: (K, C_in); pw: (C_in, C_out); b: (C_out,), all of
    one dtype.  Returns (B, (L - K) // stride + 1, C_out) in x's dtype,
    accumulated in f32.  ``dwsep_conv1d.launches`` counts kernel launches.
    Both paths refuse what the kernel does not take (K, stride, widths,
    dtypes, layout), so what runs on the CPU runs on the card.
    """
    if x.dim() != 3 or dw.dim() != 2 or pw.dim() != 2:
        raise ValueError("bad ranks")
    if dw.shape[1] != x.shape[2] or pw.shape[0] != x.shape[2] \
            or b.shape[0] != pw.shape[1]:
        raise ValueError("inconsistent channel dims")
    bsz, length, c_in = x.shape
    k, c_out = dw.shape[0], pw.shape[1]
    if k not in KERNEL_SIZES or stride not in STRIDES:
        raise ValueError(f"kernel size {k} (supported {KERNEL_SIZES}) or "
                         f"stride {stride} (supported {STRIDES})")
    if not (0 < c_in <= MAX_C_IN and 0 < c_out <= MAX_C_OUT):
        raise ValueError(f"C_in {c_in} (supported 1..{MAX_C_IN}) or C_out "
                         f"{c_out} (supported 1..{MAX_C_OUT})")
    if length < k:
        raise ValueError(f"input length {length} < kernel {k}")
    if x.dtype not in _DTYPE_CODE or any(t.dtype != x.dtype
                                         for t in (dw, pw, b)):
        raise ValueError(f"dtypes {x.dtype}/{dw.dtype}/{pw.dtype}/{b.dtype}:"
                         f" want one of float32, bfloat16 for all four")
    if any(t.device != x.device for t in (dw, pw, b)):
        raise ValueError("x, dw, pw and b must share one device")
    if not all(t.is_contiguous() for t in (x, dw, pw, b)):
        raise ValueError("x, dw, pw and b must be contiguous")
    if x.device.type == "cpu":
        return dwsep_conv1d_ref(x, dw, pw, b, stride=stride, relu=relu)
    if x.device.type != "cuda":
        raise ValueError(f"no dwsep_conv1d for device {x.device}")
    l_out = (length - k) // stride + 1
    out = torch.empty((bsz, l_out, c_out), dtype=x.dtype, device=x.device)
    if bsz == 0:
        return out
    launch = _launcher()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = launch(x.data_ptr(), dw.data_ptr(), pw.data_ptr(), b.data_ptr(),
                     out.data_ptr(), bsz, length, c_in, c_out, k, stride,
                     int(relu), _DTYPE_CODE[x.dtype], l_out, stream)
    if err:
        raise RuntimeError(f"dwsep_conv1d kernel launch failed: CUDA error "
                           f"{err}")
    count_launch(dwsep_conv1d)
    return out


dwsep_conv1d.launches = 0
