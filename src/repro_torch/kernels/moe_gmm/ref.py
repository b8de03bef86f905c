"""Plain PyTorch version of the grouped matmul.

Counterpart of ``repro/kernels/moe_gmm/ref.py: gmm_ref``: the CPU path of
the wrapper in ``ops.py`` and the oracle the CUDA kernel is held against on
the card.
"""
from __future__ import annotations

import torch


def gmm_ref(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x: (E, C, D), w: (E, D, F) -> (E, C, F): both upcast to f32 for the
    product, the result cast to x's dtype."""
    return torch.einsum("ecd,edf->ecf", x.float(), w.float()).to(x.dtype)
