"""Fused depthwise-separable 1D convolution + bias + optional ReLU."""
from repro_torch.kernels.conv1d.ops import dwsep_conv1d
from repro_torch.kernels.conv1d.ref import dwsep_conv1d_ref

__all__ = ["dwsep_conv1d", "dwsep_conv1d_ref"]
