"""Mamba2-780m [arXiv:2405.21060; hf:state-spaces/mamba2-780m].

48L, d_model 1536 (attention-free), vocab 50280, ssm_state 128.
d_inner = 2*d_model = 3072, head_dim 64 -> 48 SSD heads, 1 B/C group.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-780m", family="ssm",
    n_layers=48, d_model=1536, n_heads=0, n_kv_heads=0,
    d_ff=0, vocab_size=50280,
    ssm_state=128, ssm_head_dim=64, ssm_expand=2, ssm_groups=1,
    ssm_chunk=256, conv_kernel=4,
    attn_period=0,
    norm="rmsnorm",
    remat="full", microbatches=2,
)
