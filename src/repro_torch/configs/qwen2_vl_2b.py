"""Qwen2-VL-2B backbone [arXiv:2409.12191; hf:Qwen/Qwen2-VL-2B].

28L, d_model 1536, 12 heads (GQA kv=2), d_ff 8960, vocab 151936.
M-RoPE (3-section rotary over t/h/w position ids); the vision frontend is a
STUB — input_specs() provides precomputed patch embeddings per assignment.
head_dim 128; mrope sections (16,24,24) over the rotary half-dim.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-vl-2b", family="vlm",
    n_layers=28, d_model=1536, n_heads=12, n_kv_heads=2,
    d_ff=8960, vocab_size=151936,
    qkv_bias=True, mrope=True, mrope_sections=(16, 24, 24),
    rope_theta=1e6, tie_embeddings=True,
    frontend="vision",
    norm="rmsnorm", act="swiglu",
    remat="full", microbatches=2,
)
