"""Qwen2-0.5B [arXiv:2407.10671; hf:Qwen/Qwen2-0.5B].

24L, d_model 896, 14 heads (GQA kv=2), d_ff 4864, vocab 151936.
QKV bias, tied embeddings, rope theta 1e6.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-0.5b", family="dense",
    n_layers=24, d_model=896, n_heads=14, n_kv_heads=2,
    d_ff=4864, vocab_size=151936,
    qkv_bias=True, rope_theta=1e6, tie_embeddings=True,
    norm="rmsnorm", act="swiglu",
    remat="full", microbatches=2,
)
