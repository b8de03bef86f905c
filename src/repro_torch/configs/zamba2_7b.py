"""Zamba2-7B [arXiv:2411.15242; hf:Zyphra/Zamba2-7B] — simplified.

81 Mamba-2 layers, d_model 3584, ssm_state 64; a SHARED attention+MLP block
(32 heads, MHA kv=32, head_dim 112, d_ff 14336) applied after every 6 SSM
layers (13 applications + 3 tail layers).  vocab 32000.
Simplifications documented in models/hybrid.py.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-7b", family="hybrid",
    n_layers=81, d_model=3584, n_heads=32, n_kv_heads=32,
    d_ff=14336, vocab_size=32000,
    ssm_state=64, ssm_head_dim=64, ssm_expand=2, ssm_groups=1,
    ssm_chunk=256, conv_kernel=4,
    attn_period=6,
    norm="rmsnorm", act="swiglu",
    remat="full", microbatches=4,
)
