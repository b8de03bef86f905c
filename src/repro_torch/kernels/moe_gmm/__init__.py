"""Grouped (expert-batched) matmul of the MoE expert FFN."""
from repro_torch.kernels.moe_gmm.ops import gmm
from repro_torch.kernels.moe_gmm.ref import gmm_dw_ref, gmm_dx_ref, gmm_ref

__all__ = ["gmm", "gmm_dw_ref", "gmm_dx_ref", "gmm_ref"]
