"""Public op: the Mamba-2 SSD scan (hand-written CUDA kernel on the card,
the plain PyTorch version on the CPU).

Counterpart of ``repro/kernels/ssd/ops.py: ssd``, with the output of
``repro/models/mamba2.py: ssd_chunked``, which is what ``repro`` runs:
``(y, final_state)``.  The tensor's device picks the path: a CPU tensor
goes to the plain version in ``ref.py``, a CUDA tensor to the kernel in
``csrc/ssd.cu`` or the call raises.  There is no fallback from the kernel
to the plain version.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from repro_torch import _build
from repro_torch.kernels._launches import count_launch
from repro_torch.kernels.ssd.ref import ssd_chunked

STATE_SIZES = (8, 16, 32, 64, 128)   # N the kernel is built for
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
# what the C entry point reports it launched (csrc/ssd.cu's note): the
# recurrence step by step on the CUDA cores (f32, and bf16 at other
# widths), or the chunked form on the tensor cores (bf16, N 64 or 128, P a
# multiple of 64, x, B, C and y on 16-byte boundaries)
PATHS = ("step", "chunked")
CHUNK = 64   # steps a chunk of the chunked path (kQ in csrc/ssd.cu)


@functools.cache
def _launcher():
    fn = _build.load("ssd").ssd_scan_launch
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 7 \
        + [ctypes.c_void_p, ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int
    return fn


def _check(x, dt, a_neg, b_mat, c_mat, chunk) -> None:
    """What the kernel takes, checked on every device: x (B,L,H,P), dt
    (B,L,H) f32, a_neg (H,) f32, B/C (B,L,G,N) of x's dtype with H % G == 0
    and N the kernel is built for; all contiguous on one device."""
    if x.dim() != 4 or dt.dim() != 3 or a_neg.dim() != 1 \
            or b_mat.dim() != 4 or c_mat.shape != b_mat.shape:
        raise ValueError(f"want x (B,L,H,P), dt (B,L,H), a_neg (H,), b/c "
                         f"(B,L,G,N) alike; got {tuple(x.shape)}, "
                         f"{tuple(dt.shape)}, {tuple(a_neg.shape)}, "
                         f"{tuple(b_mat.shape)}, {tuple(c_mat.shape)}")
    bsz, length, h, p = x.shape
    g, n = b_mat.shape[2], b_mat.shape[3]
    if dt.shape != (bsz, length, h) or a_neg.shape != (h,) \
            or b_mat.shape[:2] != (bsz, length) or g < 1 or h % g:
        raise ValueError(f"x {tuple(x.shape)} does not match dt "
                         f"{tuple(dt.shape)}, a_neg {tuple(a_neg.shape)} or "
                         f"b/c {tuple(b_mat.shape)}")
    if length < 1 or chunk < 1:
        raise ValueError(f"sequence length {length} and chunk {chunk} must "
                         f"be >= 1")
    if n not in STATE_SIZES:
        raise ValueError(f"state size {n} (supported {STATE_SIZES})")
    if x.dtype not in _DTYPE_CODE or b_mat.dtype != x.dtype \
            or c_mat.dtype != x.dtype:
        raise ValueError(f"dtypes {x.dtype}/{b_mat.dtype}/{c_mat.dtype}: "
                         f"want one of float32, bfloat16 for x, b and c")
    if dt.dtype != torch.float32 or a_neg.dtype != torch.float32:
        raise ValueError(f"dt and a_neg must be float32, got {dt.dtype}, "
                         f"{a_neg.dtype}")
    ts = [x, dt, a_neg, b_mat, c_mat]
    if len({t.device for t in ts}) != 1:
        raise ValueError("the inputs of ssd_scan must share one device")
    if not all(t.is_contiguous() for t in ts):
        raise ValueError("the inputs of ssd_scan must be contiguous")


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, a_neg: torch.Tensor,
             b_mat: torch.Tensor, c_mat: torch.Tensor, chunk: int
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mamba-2 SSD scan. x: (B,L,H,P); dt: (B,L,H) f32 after the softplus;
    a_neg: (H,) f32; b/c: (B,L,G,N).  The scan starts from a zero state
    and returns (y (B,L,H,P) in x's dtype, final state (B,H,N,P) f32).
    ``chunk`` is the plain version's chunk length; the kernel picks its
    own (``CHUNK`` steps on its chunked path, one step on its step path)
    and gives the same function.  ``ssd_scan.launches`` counts kernel
    launches, one a call, and ``ssd_scan.launches_by_path`` counts them by
    the path the kernel's entry point took (``PATHS``).  Both paths refuse
    what the kernel does not take, so what runs on the CPU runs on the
    card."""
    _check(x, dt, a_neg, b_mat, c_mat, chunk)
    if x.device.type == "cpu":
        return ssd_chunked(x, dt, a_neg, b_mat, c_mat, chunk)
    if x.device.type != "cuda":
        raise ValueError(f"no ssd_scan for device {x.device}")
    bsz, length, h, p = x.shape
    g, n = b_mat.shape[2], b_mat.shape[3]
    y = torch.empty_like(x)
    state = torch.empty((bsz, h, n, p), dtype=torch.float32, device=x.device)
    launch = _launcher()
    path = ctypes.c_int(-1)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = launch(x.data_ptr(), dt.data_ptr(), a_neg.data_ptr(),
                     b_mat.data_ptr(), c_mat.data_ptr(), y.data_ptr(),
                     state.data_ptr(), bsz, length, h, p, g, n,
                     _DTYPE_CODE[x.dtype], stream, ctypes.byref(path))
    if err:
        raise RuntimeError(f"ssd_scan kernel launch failed: CUDA error {err}")
    count_launch(ssd_scan, PATHS[path.value])
    return y, state


ssd_scan.launches = 0
ssd_scan.launches_by_path = dict.fromkeys(PATHS, 0)
