"""Whisper-tiny [arXiv:2212.04356; hf:openai/whisper-tiny].

Encoder 4L + decoder 4L, d_model 384, 6 heads (MHA kv=6), d_ff 1536,
vocab 51865.  Conv frontend is a STUB: input_specs() provides post-conv
frame embeddings.  GELU MLP, LayerNorm, sinusoidal positions, tied decoder
embeddings.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-tiny", family="encdec",
    n_layers=4, n_dec_layers=4, d_model=384, n_heads=6, n_kv_heads=6,
    d_ff=1536, vocab_size=51865,
    frontend="audio", dec_ratio=8,
    norm="layernorm", act="gelu", tie_embeddings=True,
    remat="none", microbatches=1,
)
