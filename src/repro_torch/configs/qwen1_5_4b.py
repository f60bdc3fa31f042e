"""Qwen1.5-4B — dense MHA (kv == q heads) with QKV bias.

[hf:Qwen/Qwen1.5-0.5B family; hf]
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="qwen1.5-4b",
    family="dense",
    n_layers=40,
    d_model=2560,
    n_heads=20,
    n_kv_heads=20,
    d_head=128,
    d_ff=6912,
    vocab_size=151_936,
    attn_bias=True,
    rope_theta=1_000_000.0,
    source="hf:Qwen/Qwen1.5-4B",
))
