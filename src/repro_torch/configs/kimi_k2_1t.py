"""Kimi K2 — trillion-parameter MoE [arXiv:2501.kimi2 per assignment].

61L, d_model 7168, 64 heads (GQA kv=8), vocab 163840.
MoE: 384 experts, top-8, per-expert d_ff 2048, +1 shared expert
(DeepSeek-style).  Adafactor + bf16 params: AdamW state (12 B/param) cannot
fit 512 x 16 GB for 1T params (DESIGN.md §5).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="kimi-k2-1t-a32b", family="moe",
    n_layers=61, d_model=7168, n_heads=64, n_kv_heads=8,
    d_ff=2048, vocab_size=163840,
    n_experts=384, experts_per_token=8, moe_d_ff=2048,
    n_shared_experts=1,
    rope_theta=5e4,
    norm="rmsnorm", act="swiglu",
    remat="full", microbatches=4,  # B3: halves FSDP weight AG/RS rounds
    optimizer="adafactor",
    grad_acc_dtype="bfloat16",  # f32 accumulators would add 4 TB
    fsdp_axes=("pod", "data"),
    moe_impl="ep_a2a",
)
