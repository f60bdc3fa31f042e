"""Kimi K2 — trillion-parameter fine-grained MoE, 384 experts top-8.

[arXiv:2501.kimi2; unverified] — paper-table config: 61L, d_model=7168,
64 query heads (GQA kv=8), per-expert d_ff=2048, vocab 163840.
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="kimi-k2-1t-a32b",
    family="moe",
    n_layers=61,
    d_model=7168,
    n_heads=64,
    n_kv_heads=8,
    d_head=112,           # d_model // n_heads (spec-exact; kernels pad to 128)
    d_ff=2048,            # per-expert (fine-grained)
    vocab_size=163_840,
    n_experts=384,
    top_k=8,
    rope_theta=50_000.0,
    source="arXiv:2501.kimi2",
))
