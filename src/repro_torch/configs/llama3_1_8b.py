"""LLaMA3.1-8B — paper evaluation model (GQA). [arXiv:2407.21783]"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="llama3.1-8b",
    family="dense",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_head=128,
    d_ff=14336,
    vocab_size=128_256,
    rope_theta=500_000.0,
    source="arXiv:2407.21783 (paper eval model)",
))
