"""OPT-30B — paper evaluation model (MHA). [arXiv:2205.01068]"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="opt-30b",
    family="dense",
    n_layers=48,
    d_model=7168,
    n_heads=56,
    n_kv_heads=56,
    d_head=128,
    d_ff=28672,
    vocab_size=50_272,
    gated_mlp=False,
    tie_embeddings=True,
    source="arXiv:2205.01068 (paper eval model)",
))
