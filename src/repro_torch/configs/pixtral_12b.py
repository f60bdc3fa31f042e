"""Pixtral-12B — pixtral-ViT frontend (stub) + Mistral-Nemo text backbone.

[hf:mistralai/Pixtral-12B-2409; unverified] — the assignment specifies the
transformer BACKBONE only; ``input_specs()`` supplies precomputed patch
embeddings (frontend_stub=True).
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="pixtral-12b",
    family="vlm",
    n_layers=40,
    d_model=5120,
    n_heads=32,
    n_kv_heads=8,
    d_head=160,
    d_ff=14336,
    vocab_size=131_072,
    rope_theta=1_000_000.0,
    frontend_stub=True,
    source="hf:mistralai/Pixtral-12B-2409",
))
