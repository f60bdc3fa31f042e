"""Gemma3-12B — 5:1 local:global attention, 128K context.

[hf:google/gemma-3-1b-pt family; unverified] — every 6th layer is global
(full) attention; the rest use a 1024-token sliding window.
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="gemma3-12b",
    family="dense",
    n_layers=48,
    d_model=3840,
    n_heads=16,
    n_kv_heads=8,
    d_head=256,
    d_ff=15360,
    vocab_size=262_144,
    window=1024,
    global_every=6,        # 5 local : 1 global
    rope_theta=1_000_000.0,
    tie_embeddings=True,
    source="hf:google/gemma-3-12b-pt",
))
