"""LLaMA2-7B — paper evaluation model (MHA). [arXiv:2307.09288]"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="llama2-7b",
    family="dense",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=32,
    d_head=128,
    d_ff=11008,
    vocab_size=32_000,
    source="arXiv:2307.09288 (paper eval model)",
))
