"""Attention projections (port of `repro.models.attention`).

Weight layout is the reference's head-group-major one: wq [K, D, G·dh],
wk/wv [K, D, dh], so head h = k·G + g and the kv head of h is h // G.
The split phases the decode engine interposes the paged KV cache
between (`project_qkv` / `project_out`; for the discrete variant
`project_kv` and one head group's `project_q_group`) and the
full-sequence attention of the one-shot prefill, training and the
reference forward (`attention_train` through `sharded_flash_attention`:
ring attention over the ambient mesh's `model` axis, else kernel B4)
are ported.
Cross-attention (`attention_train(kv_x=...)`, an encoder-decoder
decoder's) projects q from x and k/v from the encoder output, with no
RoPE on either side, and attends non-causally; its two halves,
`project_cross_kv` and `cross_attention`, let the engine keep the
projected encoder K/V as cache leaves.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.quant import QuantizedWeight, dequantize
from repro_torch.distributed.sharding import (current_manual, effective_mesh,
                                              get_current_mesh)
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.models.layers import ParamInit, apply_rope, dense


def init_attention(b: ParamInit, cfg: ModelConfig, *, cross: bool = False):
    """The projections of one attention block; a cross-attention block
    (`cross`) has the same leaves, as in the reference."""
    d = cfg.d_model
    K, G, dh = cfg.n_kv_heads, cfg.group_size, cfg.d_head
    b.param("wq_w", (K, d, G * dh), (None, "embed", "heads"))
    b.param("wk_w", (K, d, dh), (None, "embed", "head_dim"))
    b.param("wv_w", (K, d, dh), (None, "embed", "head_dim"))
    if cfg.attn_bias:
        b.param("wq_b", (K, G * dh), (None, "heads"), init="zeros")
        b.param("wk_b", (K, dh), (None, "head_dim"), init="zeros")
        b.param("wv_b", (K, dh), (None, "head_dim"), init="zeros")
    b.param("wo_w", (cfg.q_dim, d), ("heads", "embed"))


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


def _positions(x: torch.Tensor, positions: Optional[torch.Tensor]):
    if positions is None:
        return torch.arange(x.shape[1], device=x.device)[None, :]
    return positions


def project_kv(params: Dict[str, Any], cfg: ModelConfig, x: torch.Tensor,
               positions: Optional[torch.Tensor]
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: [B, S, D] -> k/v [B, S, K, dh] (RoPE applied to k)."""
    k = apply_rope(_proj(params, "wk", x), _positions(x, positions),
                   cfg.rope_theta)
    return k, _proj(params, "wv", x)


def project_qkv(params: Dict[str, Any], cfg: ModelConfig, x: torch.Tensor,
                positions: Optional[torch.Tensor]
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """x: [B, S, D] -> q [B, S, H, dh], k/v [B, S, K, dh] (RoPE applied)."""
    B, S, _ = x.shape
    q = _proj(params, "wq", x).reshape(B, S, cfg.n_heads, cfg.d_head)
    k, v = project_kv(params, cfg, x, positions)
    return apply_rope(q, _positions(x, positions), cfg.rope_theta), k, v


def project_q_group(params: Dict[str, Any], cfg: ModelConfig,
                    x_tok: torch.Tensor, group: int,
                    positions: torch.Tensor) -> torch.Tensor:
    """One head group's q projection (the KVNAND-D pipelined GEMV):
    x_tok [B, D] (one decode token a row) -> [B, G, dh], roped at
    `positions` [B].  Group i's weight is the contiguous [D, G·dh] slice
    wq[i]; a quantized weight dequantizes that slice only (the reference
    dequantizes the whole weight first, with the same numbers)."""
    w = params["wq_w"][group]
    if isinstance(w, QuantizedWeight):
        w = dequantize(w, x_tok.dtype)
    # the compact projection's contraction, over one group: "bsd,kdf"
    q = torch.einsum("bsd,df->bsf", x_tok[:, None], w.to(x_tok.dtype))
    b = params.get("wq_b")
    if b is not None:
        q = q + b[group].to(q.dtype)
    q = q.reshape(x_tok.shape[0], 1, cfg.group_size, cfg.d_head)
    return apply_rope(q, positions[:, None], cfg.rope_theta)[:, 0]


def project_out(params: Dict[str, Any], cfg: ModelConfig,
                attn: torch.Tensor, *, impl: str = "auto") -> torch.Tensor:
    """attn: [B, S, H, dh] -> [B, S, D]."""
    B, S = attn.shape[:2]
    return dense(params, "wo", attn.reshape(B, S, cfg.q_dim), impl=impl)


def project_cross_kv(params: Dict[str, Any], enc_out: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Cross-attention k/v [B, Senc, K, dh] from the encoder output
    enc_out [B, Senc, D], no RoPE."""
    return _proj(params, "wk", enc_out), _proj(params, "wv", enc_out)


def cross_attention(params: Dict[str, Any], cfg: ModelConfig,
                    x: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    impl: str = "auto") -> torch.Tensor:
    """Cross-attention of x [B, S, D] over the encoder's projected k/v
    [B, Senc, K, dh] (`project_cross_kv`): q without RoPE, non-causal
    flash attention (kernel B4 on a card, Sq = S against Sk = Senc), the
    output projection.  -> [B, S, D]."""
    B, S, _ = x.shape
    q = _proj(params, "wq", x).reshape(B, S, cfg.n_heads, cfg.d_head)
    out = sharded_flash_attention(q, k, v, causal=False, impl=impl)
    return project_out(params, cfg, out, impl=impl)


def attention_train(params: Dict[str, Any], cfg: ModelConfig,
                    x: torch.Tensor, *, window: Optional[int] = None,
                    is_global=None, causal: bool = True, impl: str = "auto",
                    positions: Optional[torch.Tensor] = None,
                    kv_x: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Full-sequence attention (prefill, and the reference forward):
    x [B, S, D] -> [B, S, D].  `impl` picks the flash-attention path and
    the quantized output projection's alike ("ref": the plain versions on
    any device).  With `kv_x` (an encoder's output) it is
    cross-attention, non-causal and without RoPE, whatever `causal`,
    `window` and `positions` say."""
    if kv_x is not None:
        return cross_attention(params, cfg, x,
                               *project_cross_kv(params, kv_x), impl=impl)
    q, k, v = project_qkv(params, cfg, x, positions)
    out = sharded_flash_attention(q, k, v, causal=causal, window=window,
                                  is_global=is_global, impl=impl)
    return project_out(params, cfg, out, impl=impl)


def sharded_flash_attention(q, k, v, *, causal=True, window=None,
                            is_global=None, impl="auto"):
    """Mesh-adaptive attention: ring attention (sequence parallel,
    `seqpar.ring_attention`) when the ambient mesh has a `model` axis of
    more than one, not fixed by an enclosing `manual_axes` (the
    compressed train step's pod/data), with q's and k's lengths
    dividing it; `flash_attention` (kernel B4 on a card) otherwise.  The
    batch is split over the free pod/data axes that divide it."""
    mesh = get_current_mesh()
    manual = current_manual()
    if (mesh is not None and "model" in mesh.shape
            and mesh.shape["model"] > 1 and "model" not in manual
            and q.shape[1] % mesh.shape["model"] == 0
            and k.shape[1] % mesh.shape["model"] == 0 and q.shape[1] > 1):
        from repro_torch.core.seqpar import ring_attention
        batch_axes, rem = [], q.shape[0]
        for a in ("pod", "data"):
            if a in mesh.shape and a not in manual \
                    and rem % mesh.shape[a] == 0:
                batch_axes.append(a)
                rem //= mesh.shape[a]
        return ring_attention(q, k, v, effective_mesh(mesh), causal=causal,
                              window=window, is_global=is_global,
                              batch_axes=tuple(batch_axes), seq_axis="model")
    return flash_attention(q, k, v, causal=causal, window=window,
                           is_global=is_global, impl=impl)
