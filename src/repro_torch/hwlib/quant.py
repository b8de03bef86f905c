"""Quantization utilities: fake-quant, batchnorm folding.

Counterpart of ``repro/hwlib/quant.py``.  The paper's NAS search space
includes the quantization of inputs, weights and feature maps (§III-A);
accumulator precision is set post-hoc by the profiler (§III-B,
:mod:`repro_torch.hwlib.profiler`).  Symmetric fixed-point fake
quantization with straight-through gradients: trainable (QAT) and directly
interpretable as bit widths of the hardware datapath.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import numpy as np
import torch

from repro_torch.hwlib.layers import DWSEP_CONV, LayerSpec


@dataclasses.dataclass(frozen=True)
class QuantConfig:
    """Bit widths for the three fake-quantized tensor classes."""

    weight_bits: int = 8
    act_bits: int = 8
    input_bits: int = 8

    def short(self) -> str:
        return f"w{self.weight_bits}a{self.act_bits}i{self.input_bits}"


def fake_quant(x: torch.Tensor, bits, *,
               per_channel_axis: Optional[int] = None) -> torch.Tensor:
    """Symmetric fake quantization with a straight-through estimator.

    ``bits <= 0`` or ``bits >= 32`` disables quantization (identity).

    ``bits`` may be a Python int (the disable rule resolves on the host)
    or a tensor (per-candidate bit widths of a batched trainer): the tensor
    path computes the same f32 values as the int path for the searchable
    widths and realises the disable rule with ``torch.where``.
    ``torch.round`` rounds half to even, as ``jnp.round`` does.
    """
    if isinstance(bits, (int, np.integer)):
        if bits <= 0 or bits >= 32:
            return x
        qmax = 2.0 ** (int(bits) - 1) - 1.0
        disabled = None
    else:
        b = torch.as_tensor(bits, device=x.device).to(torch.float32)
        qmax = 2.0 ** (b - 1.0) - 1.0
        disabled = (b <= 0.0) | (b >= 32.0)
    if per_channel_axis is None:
        scale = torch.clamp_min(x.abs().amax(), 1e-8) / qmax
    else:
        axes = tuple(i for i in range(x.dim()) if i != per_channel_axis)
        scale = torch.clamp_min(x.abs().amax(dim=axes, keepdim=True),
                                1e-8) / qmax
    q = torch.clamp(torch.round(x / scale), -qmax - 1.0, qmax) * scale
    # straight-through: forward q, backward identity
    out = x + (q - x).detach()
    if disabled is not None:
        out = torch.where(disabled, x, out)
    return out


def quantize_layer_params(params: Dict[str, Any], spec: LayerSpec,
                          cfg: QuantConfig) -> Dict[str, Any]:
    """Apply weight fake-quant to a layer's parameter dict (per output
    channel: the last axis)."""
    out = dict(params)
    for name in ("dw", "pw", "w"):
        if name in out:
            out[name] = fake_quant(out[name], cfg.weight_bits,
                                   per_channel_axis=out[name].dim() - 1)
    return out


def fold_batchnorm(params: Dict[str, Any], spec: LayerSpec) -> Dict[str, Any]:
    """Fold BN running stats into the pointwise conv weights + bias.

    Paper §III-A: batchnorm folding compresses the model before the
    topology is handed to the implementation framework.  After folding the
    layer computes ``relu(dw/pw conv + b')`` with no BN at inference.
    """
    if spec.kind != DWSEP_CONV or "bn_scale" not in params:
        return params
    scale = params["bn_scale"] * torch.rsqrt(params["bn_var"] + 1e-5)
    return {
        "dw": params["dw"],
        "pw": params["pw"] * scale[None, :],
        "b": (params["b"] - params["bn_mean"]) * scale + params["bn_bias"],
    }


def fold_model(params_list, specs) -> list:
    """Fold BN for every layer of a decoded candidate."""
    return [fold_batchnorm(p, s) for p, s in zip(params_list, specs)]
