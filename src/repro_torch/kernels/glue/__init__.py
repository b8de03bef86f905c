"""A decoder layer's glue (residual add + RMSNorm, RoPE and the paged K/V
write, SwiGLU), fused."""
from repro_torch.kernels.glue.ops import add_rmsnorm, rope, rope_write, swiglu
from repro_torch.kernels.glue.ref import rope_write_ref

__all__ = ["add_rmsnorm", "rope", "rope_write", "rope_write_ref", "swiglu"]
