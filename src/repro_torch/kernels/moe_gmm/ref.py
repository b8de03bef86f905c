"""Plain PyTorch versions of the grouped matmul and its two gradients.

Counterpart of ``repro/kernels/moe_gmm/ref.py: gmm_ref``: the CPU path of
the wrapper in ``ops.py`` and the oracle the CUDA kernel is held against on
the card.  The reference takes the gradient of its einsum by autodiff;
``gmm_dx_ref`` and ``gmm_dw_ref`` are that gradient written out, each an
f32 sum rounded once to the operands' dtype, as autograd through
``gmm_ref`` computes it.
"""
from __future__ import annotations

import torch


def gmm_ref(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x: (E, C, D), w: (E, D, F) -> (E, C, F): both upcast to f32 for the
    product, the result cast to x's dtype."""
    return torch.einsum("ecd,edf->ecf", x.float(), w.float()).to(x.dtype)


def gmm_dx_ref(dy: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """dX = dY W^T: dy (E, C, F), w (E, D, F) -> (E, C, D) in dy's dtype."""
    return torch.einsum("ecf,edf->ecd", dy.float(), w.float()).to(dy.dtype)


def gmm_dw_ref(x: torch.Tensor, dy: torch.Tensor) -> torch.Tensor:
    """dW = X^T dY: x (E, C, D), dy (E, C, F) -> (E, D, F) in x's dtype."""
    return torch.einsum("ecd,ecf->edf", x.float(), dy.float()).to(x.dtype)
