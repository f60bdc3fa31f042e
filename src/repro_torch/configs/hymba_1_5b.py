"""Hymba-1.5B — hybrid-head: parallel attention + Mamba heads per layer.

[arXiv:2411.13676; hf] — 25 query heads (GQA kv=5), ssm_state=16, sliding
window attention on most layers with a few global layers, 128 meta tokens.
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="hymba-1.5b",
    family="hybrid",
    n_layers=32,
    d_model=1600,
    n_heads=25,
    n_kv_heads=5,
    d_head=64,
    d_ff=5504,
    vocab_size=32_001,
    ssm_state=16,
    window=1024,
    global_every=16,        # sparse global layers
    n_meta_tokens=128,
    source="arXiv:2411.13676",
))
