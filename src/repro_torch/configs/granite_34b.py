"""Granite-34B-Code [arXiv:2405.04324; hf:ibm-granite/granite-34b-code].

88L, d_model 6144, 48 heads, MQA (kv=1), d_ff 24576, vocab 49152.
llama-style blocks per the assignment.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="granite-34b", family="dense",
    n_layers=88, d_model=6144, n_heads=48, n_kv_heads=1,
    d_ff=24576, vocab_size=49152,
    norm="rmsnorm", act="swiglu",
    remat="full", microbatches=16,
)
