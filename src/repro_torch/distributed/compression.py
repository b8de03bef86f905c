"""Gradient compression.

Counterpart of ``repro/distributed/compression.py``:

* **bf16 gradient cast** — each gradient rounded to bf16 and back, the
  bytes a cross-host reduce in the narrower type would carry;
* **error-feedback top-k sparsification** — keeps a residual so dropped
  coordinates are re-injected next step (Stich et al. '18).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Tuple

import torch

from repro_torch.optim.adamw import tree_map


@dataclasses.dataclass(frozen=True)
class CompressionConfig:
    mode: str = "bf16"       # "bf16" | "topk" | "none"
    topk_frac: float = 0.01  # fraction of coordinates kept in topk mode


def compress_grads(grads: Any, cfg: CompressionConfig) -> Any:
    if cfg.mode == "none":
        return grads
    if cfg.mode == "bf16":
        return tree_map(lambda g: g.to(torch.bfloat16).float(), grads)
    raise ValueError(f"compress_grads only handles stateless modes, "
                     f"got {cfg.mode!r}; use EFTopK for topk")


class EFTopK:
    """Error-feedback top-k: ``compress`` returns the sparsified gradient and
    the updated residual state (a tree matching the grads)."""

    def __init__(self, frac: float = 0.01):
        self.frac = frac

    def init(self, grads: Any) -> Any:
        return tree_map(torch.zeros_like, grads)

    def compress(self, grads: Any, residual: Any) -> Tuple[Any, Any]:
        def one(g, r):
            acc = g + r
            k = max(1, int(acc.numel() * self.frac))
            thresh = torch.topk(acc.reshape(-1).abs(), k).values[-1]
            sent = torch.where(acc.abs() >= thresh, acc,
                               torch.zeros_like(acc))
            return sent, acc - sent

        pairs = tree_map(one, grads, residual)
        return (tree_map(lambda t: t[0], pairs),
                tree_map(lambda t: t[1], pairs))
