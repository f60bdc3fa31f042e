"""RWKV6-3B (Finch) — attention-free, data-dependent decay.

[arXiv:2404.05892; hf] — internal wkv heads of size 64 (40 heads at
d_model=2560); the assignment lists the arch as attention-free.
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="rwkv6-3b",
    family="ssm",
    n_layers=32,
    d_model=2560,
    n_heads=40,            # wkv heads (head_size 64), not attention heads
    n_kv_heads=40,
    d_head=64,
    d_ff=8960,
    vocab_size=65_536,
    source="arXiv:2404.05892",
))
