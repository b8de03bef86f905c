"""Model "compilation" for deployment (paper §III-A last ¶ and §III-B).

Counterpart of ``repro/core/compile_model.py``.  Takes a trained candidate
and produces the deployable artifact: batchnorm-folded, weight-quantized
parameters plus the per-layer implementation plan (unrolling factors,
accumulator formats) that the hardware generator would consume.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Sequence

import torch

from repro_torch.core.genome import Genome
from repro_torch.core.hw_model import (
    FPGA_ZU,
    HardwareProfile,
    HwEstimate,
    estimate,
    layer_costs_for,
    resolve_alphas,
)
from repro_torch.core.search_space import DEFAULT_SPACE, SearchSpace
from repro_torch.hwlib.layers import LayerSpec
from repro_torch.hwlib.profiler import AccumulatorFormat, profile_accumulators
from repro_torch.hwlib.quant import fold_model, quantize_layer_params


@dataclasses.dataclass
class CompiledModel:
    """The deployable artifact the implementation framework emits."""

    genome: Genome
    specs: List[LayerSpec]
    params: List[Dict[str, Any]]        # BN-folded, fake-quantized
    alphas: List[int]                   # per-layer parallelization plan
    acc_formats: List[AccumulatorFormat]
    estimate_min: HwEstimate
    estimate_max: HwEstimate

    def report(self) -> str:
        lines = ["layer,spec,alpha,acc_bits,params"]
        costs = layer_costs_for(self.genome)
        for i, (s, a, f, c) in enumerate(zip(self.specs, self.alphas,
                                             self.acc_formats, costs)):
            lines.append(f"{i},{s.short()},{a},{f.total_bits},{c.params}")
        return "\n".join(lines)


@torch.no_grad()
def compile_candidate(
    genome: Genome,
    params: Sequence[Dict[str, Any]],
    x_calib: torch.Tensor,
    *,
    strategy: str = "max",
    profile: HardwareProfile = FPGA_ZU,
    space: SearchSpace = DEFAULT_SPACE,
) -> CompiledModel:
    """Fold BN, then quantize the weights, then profile the accumulators
    on ``x_calib`` (the order of the reference); the unrolling plan and
    the estimates are the cost model's."""
    specs = genome.phenotype(space)
    quant = genome.quant(space)

    folded = fold_model(list(params), specs)
    quantized = [quantize_layer_params(p, s, quant)
                 for p, s in zip(folded, specs)]
    acc_formats = profile_accumulators(quantized, specs, x_calib)

    costs = layer_costs_for(genome, space)
    alphas = resolve_alphas(costs, strategy, profile)
    return CompiledModel(
        genome=genome,
        specs=specs,
        params=quantized,
        alphas=list(alphas),
        acc_formats=acc_formats,
        estimate_min=estimate(genome, strategy="min", profile=profile,
                              space=space),
        estimate_max=estimate(genome, strategy="max", profile=profile,
                              space=space),
    )
