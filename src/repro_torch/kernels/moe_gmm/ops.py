"""Public op: grouped matmul ``out[e] = x[e] @ w[e]`` (hand-written CUDA
kernel on the card, the plain PyTorch version on the CPU).

Counterpart of ``repro/kernels/moe_gmm/ops.py: gmm``, the contraction
``repro/models/moe.py: moe_block`` spells as ``einsum('ecd,edf->ecf')``.
The tensor's device picks the path: a CPU tensor goes to the plain versions
in ``ref.py``, a CUDA tensor to the kernels in ``csrc/moe_gmm.cu`` or the
call raises.  There is no fallback from a kernel to a plain version.

``gmm`` is a ``torch.autograd.Function`` on both devices.  Its backward
is two products on the operands as they lie, with no transposed copies:
``dX = dY W^T`` (``gmm_dx_ref`` on the CPU) and ``dW = X^T dY``
(``gmm_dw_ref``).  On the card each is one launch of
``moe_gmm_backward_launch``, whose kernels read W, X and dY through their
strides or through TMA and the wgmma descriptors' transpose bits.  The
reference differentiates its einsum; its Pallas kernel has no VJP.
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
from repro_torch.kernels.moe_gmm.ref import gmm_dw_ref, gmm_dx_ref, gmm_ref

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
# what the C entry points report they launched (csrc/moe_gmm.cu's note):
# the forward's f32 FMAs; bf16 at C <= 16 (decode); bf16 wgmma with a TMA
# ring (C > 16, D and F multiples of 8, aligned); bf16 WMMA (C > 16, TMA
# cannot take it); then the backward's dX = dY W^T and dW = X^T dY, each on
# f32 FMAs, bf16 wgmma where TMA takes the tensors, or bf16 WMMA
PATHS = ("f32", "decode", "wgmma", "wmma", "dx_f32", "dx_wgmma", "dx_wmma",
         "dw_f32", "dw_wgmma", "dw_wmma")
_DX, _DW = 0, 1


@functools.cache
def _launchers():
    """(forward, backward) C entry points of the built library."""
    lib = _build.load("moe_gmm")
    forward, backward = lib.moe_gmm_launch, lib.moe_gmm_backward_launch
    tail = [ctypes.c_int] * 5 + [ctypes.c_void_p,
                                 ctypes.POINTER(ctypes.c_int)]
    forward.argtypes = [ctypes.c_void_p] * 3 + tail
    backward.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 3 + tail
    forward.restype = backward.restype = ctypes.c_int
    return forward, backward


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
    if x.device.type not in ("cpu", "cuda") and not is_fake(x, w):
        raise ValueError(f"no gmm for device {x.device}")


def _launch(shape, like: torch.Tensor, call) -> torch.Tensor:
    """An empty output of ``shape`` like ``like``, filled by ``call(out,
    stream, path)`` (one kernel launch), counted by the path it took."""
    out = torch.empty(shape, dtype=like.dtype, device=like.device)
    if out.numel() == 0:
        return out
    path = ctypes.c_int(-1)
    with torch.cuda.device(like.device):
        err = call(out, torch.cuda.current_stream(like.device).cuda_stream,
                   ctypes.byref(path))
    if err:
        raise RuntimeError(f"gmm kernel launch failed: CUDA error {err}")
    count_launch(gmm, PATHS[path.value])
    return out


def _fake(shape, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """A fake call (the forward, dX or dW): 2 E C D F flops; its two
    operands read and its output of ``shape`` written once, which for
    each of the three is one X (E, C, D), one W (E, D, F) and one Y (E, C,
    F) (chip_smoke.py: gmm_bound_ms, gmm_grad_bound_ms)."""
    e, c, d = x.shape
    f = w.shape[2]
    record_fake_call("gmm", 2 * e * c * d * f,
                     (e * c * d + e * d * f + e * c * f) * x.element_size())
    return torch.empty(shape, dtype=x.dtype, device=x.device)


def _product(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """One grouped matmul of checked operands: the plain version for CPU
    tensors, one launch of the kernel for CUDA tensors."""
    e, c, d = x.shape
    f = w.shape[2]
    if is_fake(x, w):
        return _fake((e, c, f), x, w)
    if x.device.type == "cpu":
        return gmm_ref(x, w)
    forward, _ = _launchers()
    return _launch((e, c, f), x, lambda out, stream, path: forward(
        x.data_ptr(), w.data_ptr(), out.data_ptr(), e, c, d, f,
        _DTYPE_CODE[x.dtype], stream, path))


def _grad(which: int, x: torch.Tensor, w: torch.Tensor,
          dy: torch.Tensor) -> torch.Tensor:
    """dX = dY W^T (``_DX``) or dW = X^T dY (``_DW``) of contiguous
    operands: the plain version for CPU tensors, one launch for CUDA."""
    e, c, d = x.shape
    f = w.shape[2]
    if is_fake(x, w, dy):
        return _fake((e, c, d) if which == _DX else (e, d, f), x, w)
    if dy.device.type == "cpu":
        return gmm_dx_ref(dy, w) if which == _DX else gmm_dw_ref(x, dy)
    a, b = (dy, w) if which == _DX else (x, dy)
    _, backward = _launchers()
    return _launch((e, c, d) if which == _DX else (e, d, f), x,
                   lambda out, stream, path: backward(
                       which, a.data_ptr(), b.data_ptr(), out.data_ptr(), e,
                       c, d, f, _DTYPE_CODE[x.dtype], stream, path))


class GroupedMatmul(torch.autograd.Function):
    """``out[e] = x[e] @ w[e]`` with its gradient as two more products."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        return _product(x, w)

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        dy = dy.contiguous()
        dx = _grad(_DX, x, w, dy) if ctx.needs_input_grad[0] else None
        dw = _grad(_DW, x, w, dy) if ctx.needs_input_grad[1] else None
        return dx, dw


def gmm(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Grouped matmul. x: (E, C, D), w: (E, D, F) of one dtype (float32 or
    bfloat16), contiguous, on one device.  Returns (E, C, F) in x's dtype,
    accumulated in f32; under autograd its ``grad_fn`` is
    :class:`GroupedMatmul`'s, whose backward launches the kernels twice
    (once where only one operand needs a gradient).  ``gmm.launches``
    counts kernel launches, forward and backward, and
    ``gmm.launches_by_path`` counts them by the path the kernels' entry
    points took (``PATHS``).  Both devices refuse what the kernels do not
    take, so what runs on the CPU runs on the card."""
    _check(x, w)
    return GroupedMatmul.apply(x, w)


gmm.launches = 0
gmm.launches_by_path = dict.fromkeys(PATHS, 0)
