"""DBRX (132B total) [hf:databricks/dbrx-base].

40L, d_model 6144, 48 heads (GQA kv=8), vocab 100352.
Fine-grained MoE: 16 experts, top-4, per-expert d_ff 10752.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="dbrx-132b", family="moe",
    n_layers=40, d_model=6144, n_heads=48, n_kv_heads=8,
    d_ff=10752, vocab_size=100352,
    n_experts=16, experts_per_token=4, moe_d_ff=10752,
    rope_theta=5e5,
    norm="rmsnorm", act="swiglu",
    remat="full", microbatches=8,
    moe_impl="ep_a2a",
)
