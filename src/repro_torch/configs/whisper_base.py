"""Whisper-base — encoder-decoder audio backbone; conv frontend stubbed.

[arXiv:2212.04356; unverified] — ``input_specs()`` supplies precomputed frame
embeddings (frontend_stub=True); encoder is bidirectional (no KV cache), the
decoder autoregresses with self- + cross-attention.
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="whisper-base",
    family="audio",
    n_layers=6,                 # decoder layers
    d_model=512,
    n_heads=8,
    n_kv_heads=8,
    d_head=64,
    d_ff=2048,
    vocab_size=51_865,
    is_encoder_decoder=True,
    encoder_layers=6,
    gated_mlp=False,
    tie_embeddings=True,
    frontend_stub=True,
    source="arXiv:2212.04356",
))
