"""Qwen3-4B [hf:Qwen/Qwen3-4B; config per assignment].

36L, d_model 2560, 32 heads (GQA kv=8), head_dim 128 (decoupled from
d_model), d_ff 9728, vocab 151936.  qk_norm per head, no QKV bias.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-4b", family="dense",
    n_layers=36, d_model=2560, n_heads=32, n_kv_heads=8, head_dim=128,
    d_ff=9728, vocab_size=151936,
    qk_norm=True, rope_theta=1e6,
    norm="rmsnorm", act="swiglu",
    remat="full", microbatches=4,
)
