"""Public op: grouped matmul ``out[e] = x[e] @ w[e]`` (hand-written CUDA
kernel on the card, the plain PyTorch version on the CPU).

Counterpart of ``repro/kernels/moe_gmm/ops.py: gmm``, the contraction
``repro/models/moe.py: moe_block`` spells as ``einsum('ecd,edf->ecf')``.
The tensor's device picks the path: a CPU tensor goes to the plain version
in ``ref.py``, a CUDA tensor to the kernel in ``csrc/moe_gmm.cu`` or the
call raises.  There is no fallback from the kernel to the plain version.

``gmm`` is a ``torch.autograd.Function`` on both devices: its backward is
two more grouped matmuls on the same path over contiguous per-expert
transposes (the kernel takes any C, D and F): ``dW = gmm(X^T, dY)``, and
``dX = gmm(W, dY^T)^T``, the transpose of ``W dY^T`` rather than
``dY W^T``, so that only the activations are transposed, never the
weights (at dbrx-132b's prefill shape on an H100 80GB HBM3 at 700 W,
dX through a transposed copy of the weights took 8.78 ms, this way 0.88
ms: ``chip_smoke.py`` phase 14a).  The reference differentiates its
einsum; its Pallas kernel has no VJP.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch import _build
from repro_torch.kernels._launches import count_launch
from repro_torch.kernels.moe_gmm.ref import gmm_ref

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
# what the C entry point reports it launched (csrc/moe_gmm.cu's note):
# f32 FMAs; bf16 at C <= 16 (decode); bf16 wgmma with a TMA ring (C > 16,
# D and F multiples of 8, aligned); bf16 WMMA (C > 16, TMA cannot take it)
PATHS = ("f32", "decode", "wgmma", "wmma")


@functools.cache
def _launcher():
    fn = _build.load("moe_gmm").moe_gmm_launch
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5 \
        + [ctypes.c_void_p, ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int
    return fn


def _check(x: torch.Tensor, w: torch.Tensor) -> None:
    if x.dim() != 3 or w.dim() != 3:
        raise ValueError(f"want x (E,C,D) and w (E,D,F); got ranks "
                         f"{x.dim()} and {w.dim()}")
    if w.shape[0] != x.shape[0] or w.shape[1] != x.shape[2]:
        raise ValueError(f"x {tuple(x.shape)} does not match w "
                         f"{tuple(w.shape)}: want equal E and D")
    if x.dtype not in _DTYPE_CODE or w.dtype != x.dtype:
        raise ValueError(f"dtypes {x.dtype}/{w.dtype}: want one of float32, "
                         f"bfloat16 for x and w alike")
    if w.device != x.device:
        raise ValueError("x and w must share one device")
    if not (x.is_contiguous() and w.is_contiguous()):
        raise ValueError("x and w must be contiguous")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no gmm for device {x.device}")


def _product(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """One grouped matmul of checked operands: the plain version for CPU
    tensors, one launch of the kernel for CUDA tensors."""
    if x.device.type == "cpu":
        return gmm_ref(x, w)
    e, c, _ = x.shape
    out = torch.empty((e, c, w.shape[2]), dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out
    launch = _launcher()
    path = ctypes.c_int(-1)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = launch(x.data_ptr(), w.data_ptr(), out.data_ptr(), e, c,
                     x.shape[2], w.shape[2], _DTYPE_CODE[x.dtype], stream,
                     ctypes.byref(path))
    if err:
        raise RuntimeError(f"gmm kernel launch failed: CUDA error {err}")
    count_launch(gmm, PATHS[path.value])
    return out


def _transposed(t: torch.Tensor) -> torch.Tensor:
    """Each expert's matrix transposed, contiguous: (E, A, B) -> (E, B, A)."""
    return t.transpose(1, 2).contiguous()


class GroupedMatmul(torch.autograd.Function):
    """``out[e] = x[e] @ w[e]`` with its gradient through the same op."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        return _product(x, w)

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        dy = dy.contiguous()
        dx = _transposed(_product(w, _transposed(dy))) \
            if ctx.needs_input_grad[0] else None
        dw = _product(_transposed(x), dy) if ctx.needs_input_grad[1] \
            else None
        return dx, dw


def gmm(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Grouped matmul. x: (E, C, D), w: (E, D, F) of one dtype (float32 or
    bfloat16), contiguous, on one device.  Returns (E, C, F) in x's dtype,
    accumulated in f32; under autograd its ``grad_fn`` is
    :class:`GroupedMatmul`'s, whose backward launches the kernel twice
    (once where only one operand needs a gradient).  ``gmm.launches``
    counts kernel launches, forward and backward, and
    ``gmm.launches_by_path`` counts them by the path the kernel's entry
    point took (``PATHS``).  Both paths refuse what the kernel does not
    take, so what runs on the CPU runs on the card."""
    _check(x, w)
    return GroupedMatmul.apply(x, w)


gmm.launches = 0
gmm.launches_by_path = dict.fromkeys(PATHS, 0)
