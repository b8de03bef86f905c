"""Accumulator-precision profiler (paper §III-B).

Counterpart of ``repro/hwlib/profiler.py``.  "While the quantization of
weights and activations is provided by the NAS, the quantization for the
internal accumulators is found by profiling."  A calibration pass: run a
calibration batch through the model, record per-layer accumulator ranges,
and derive fixed-point formats ``Q(int_bits, frac_bits)`` that cover the
observed range.  No gradient is taken, so the convs run through the conv
kernel on the card.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Sequence

import torch

from repro_torch.hwlib.layers import DENSE, DWSEP_CONV, LayerSpec, apply_layer


@dataclasses.dataclass(frozen=True)
class AccumulatorFormat:
    """Fixed-point format of one layer's accumulator."""

    int_bits: int    # integer bits incl. sign
    frac_bits: int

    @property
    def total_bits(self) -> int:
        return self.int_bits + self.frac_bits


def _format_for_range(max_abs: float, frac_bits: int) -> AccumulatorFormat:
    # bits to represent +-max_abs: ceil(log2(max_abs + 1)) + sign
    int_bits = max(1, int(math.ceil(math.log2(max(max_abs, 1e-8) + 1.0))) + 1)
    return AccumulatorFormat(int_bits=int_bits, frac_bits=frac_bits)


@torch.no_grad()
def profile_accumulators(
    params_list: Sequence[Dict[str, Any]],
    specs: Sequence[LayerSpec],
    x_calib: torch.Tensor,
    *,
    frac_bits: int = 8,
) -> List[AccumulatorFormat]:
    """Run the calibration batch, return one format per layer.

    Only layers with accumulators (convs and dense) get a real profile; pools
    get the pass-through format of their input.
    """
    formats: List[AccumulatorFormat] = []
    h = x_calib
    prev = _format_for_range(float(h.abs().max()), frac_bits)
    for p, s in zip(params_list, specs):
        h = apply_layer(p, s, h, train=False)
        if s.kind in (DWSEP_CONV, DENSE):
            fmt = _format_for_range(float(h.abs().max()), frac_bits)
        else:
            fmt = prev
        formats.append(fmt)
        prev = fmt
    return formats


def accumulator_report(formats: Sequence[AccumulatorFormat],
                       specs: Sequence[LayerSpec]) -> str:
    lines = ["layer,kind,int_bits,frac_bits,total_bits"]
    for i, (f, s) in enumerate(zip(formats, specs)):
        lines.append(f"{i},{s.kind},{f.int_bits},{f.frac_bits},{f.total_bits}")
    return "\n".join(lines)
