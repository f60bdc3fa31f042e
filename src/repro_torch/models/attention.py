"""Attention projections (port of `repro.models.attention`).

Weight layout is the reference's head-group-major one: wq [K, D, G·dh],
wk/wv [K, D, dh], so head h = k·G + g and the kv head of h is h // G.
Only the split phases the decode engine interposes the paged KV cache
between (`project_qkv` / `project_out`) and a plain full-sequence
attention for the reference forward are ported.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.quant import QuantizedWeight, dequantize
from repro_torch.models.layers import ParamInit, apply_rope, dense

NEG_INF = -1e30


def init_attention(b: ParamInit, cfg: ModelConfig):
    d = cfg.d_model
    K, G, dh = cfg.n_kv_heads, cfg.group_size, cfg.d_head
    b.param("wq_w", (K, d, G * dh))
    b.param("wk_w", (K, d, dh))
    b.param("wv_w", (K, d, dh))
    if cfg.attn_bias:
        b.param("wq_b", (K, G * dh), init="zeros")
        b.param("wk_b", (K, dh), init="zeros")
        b.param("wv_b", (K, dh), init="zeros")
    b.param("wo_w", (cfg.q_dim, d))


def _proj(p, name: str, x: torch.Tensor) -> torch.Tensor:
    """x: [B, S, D] -> [B, S, K, f] via the head-group-major weight.  A
    quantized [K, D, f] weight is dequantized first, as in the reference
    (a plain product outside any kernel)."""
    w = p[f"{name}_w"]
    if isinstance(w, QuantizedWeight):
        w = dequantize(w, x.dtype)
    y = torch.einsum("bsd,kdf->bskf", x, w.to(x.dtype))
    b = p.get(f"{name}_b")
    if b is not None:
        y = y + b.to(y.dtype)
    return y


def project_qkv(params: Dict[str, Any], cfg: ModelConfig, x: torch.Tensor,
                positions: Optional[torch.Tensor]
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """x: [B, S, D] -> q [B, S, H, dh], k/v [B, S, K, dh] (RoPE applied)."""
    B, S, _ = x.shape
    K, G, dh = cfg.n_kv_heads, cfg.group_size, cfg.d_head
    q = _proj(params, "wq", x).reshape(B, S, K * G, dh)
    k = _proj(params, "wk", x)
    v = _proj(params, "wv", x)
    if positions is None:
        positions = torch.arange(S, device=x.device)[None, :]
    return (apply_rope(q, positions, cfg.rope_theta),
            apply_rope(k, positions, cfg.rope_theta), v)


def project_out(params: Dict[str, Any], cfg: ModelConfig,
                attn: torch.Tensor, *, impl: str = "auto") -> torch.Tensor:
    """attn: [B, S, H, dh] -> [B, S, D]."""
    B, S = attn.shape[:2]
    return dense(params, "wo", attn.reshape(B, S, cfg.q_dim), impl=impl)


def causal_attention(q: torch.Tensor, k: torch.Tensor,
                     v: torch.Tensor) -> torch.Tensor:
    """Plain causal softmax attention in float32 (the counterpart of the
    reference's `flash_attention_ref`): q [B, S, H, dh], k/v [B, S, K, dh]
    -> [B, S, H, dh].  Used by the reference forward only."""
    B, S, H, dh = q.shape
    K = k.shape[2]
    G = H // K
    qf = q.float().reshape(B, S, K, G, dh) * dh ** -0.5
    s = torch.einsum("bqkgd,bskd->bkgqs", qf, k.float())
    pos = torch.arange(S, device=q.device)
    mask = pos[None, :] <= pos[:, None]
    s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    p = p / p.sum(dim=-1, keepdim=True)
    o = torch.einsum("bkgqs,bskd->bqkgd", p, v.float())
    return o.reshape(B, S, H, dh).to(q.dtype)
