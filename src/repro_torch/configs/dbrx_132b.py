"""DBRX-132B — fine-grained MoE, 16 experts top-4.

[hf:databricks/dbrx-base; unverified]
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="dbrx-132b",
    family="moe",
    n_layers=40,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_head=128,
    d_ff=10752,
    vocab_size=100_352,
    n_experts=16,
    top_k=4,
    rope_theta=500_000.0,
    source="hf:databricks/dbrx-base",
))
