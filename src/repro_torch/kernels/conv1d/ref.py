"""Plain PyTorch version of the depthwise-separable 1D convolution.

Counterpart of ``repro/kernels/conv1d/ref.py``; the oracle the CUDA kernel
is held against on the card, and the CPU path of the wrapper.
"""
from __future__ import annotations

import torch


def dwsep_conv1d_ref(x: torch.Tensor, dw: torch.Tensor, pw: torch.Tensor,
                     b: torch.Tensor, *, stride: int = 1,
                     relu: bool = True) -> torch.Tensor:
    """x: (B, L, C_in), dw: (K, C_in), pw: (C_in, C_out), b: (C_out,).

    VALID padding: L_out = (L - K) // stride + 1.  The depthwise taps
    accumulate in f32, each product and sum rounded, as the kernel does
    them.  The pointwise product accumulates in f64 and is rounded once to
    x's dtype: as the oracle, it carries no summation-order error of its
    own, so the kernel's f32 sums make the whole difference.  (With an
    f32 GEMM here, the kernel's widest ECG layer on an H100 came within
    1.1% of the 1e-5 tolerance: chip_smoke.py phase 8.)
    """
    k = dw.shape[0]
    l_out = (x.shape[1] - k) // stride + 1
    acc = torch.zeros((x.shape[0], l_out, x.shape[2]), dtype=torch.float32,
                      device=x.device)
    for i in range(k):
        sl = x[:, i: i + (l_out - 1) * stride + 1: stride]
        acc = acc + sl.float() * dw[i].float()
    y = acc.double() @ pw.double() + b.double()
    if relu:
        y = torch.clamp_min(y, 0.0)
    return y.to(x.dtype)
