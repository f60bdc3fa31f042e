"""Selective SSM (Mamba-style) mixer, hymba's parallel heads (port of
`repro.models.ssm`).

Recurrence (per channel d, state dim N):
    h_t = exp(Δ_t A) ⊙ h_{t-1} + Δ_t B_t x_t
    y_t = C_t · h_t + D x_t ;  out = y ⊙ silu(z)

A short causal depthwise conv (k = 4) precedes the SSM, as in Mamba; its
last CONV_K - 1 inputs are the tail a later segment continues from.  A
multi-token call scans in 64-token chunks: inside a chunk a log-depth
doubling scan composes the steps (a_l·a_r, b_l·a_r + b_r), which only
multiplies decays, so a decay that underflows to 0 inside a chunk stays
exact (no product is ever divided out); the state crosses chunks one
chunk at a time.  A single token is the O(1) update.  Plain torch ops on
every device: the reference has no kernel for the mixer, and its
projections go through `layers.dense` (kernel B3 for a quantized weight
on the card).
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import ParamInit, dense, init_dense

CONV_K = 4
CHUNK = 64


def init_ssm(b: ParamInit, cfg: ModelConfig):
    d, n = cfg.d_model, cfg.ssm_state
    init_dense(b, "in_x", d, d, ("embed", "heads"))
    init_dense(b, "in_z", d, d, ("embed", "heads"))
    b.param("conv_w", (CONV_K, d), (None, "ssm"), scale=0.5)
    b.param("conv_b", (d,), ("ssm",), init="zeros")
    init_dense(b, "w_b", d, n, ("embed", None))
    init_dense(b, "w_c", d, n, ("embed", None))
    init_dense(b, "w_dt", d, 1, ("embed", None), bias=True)
    b.param("a_log", (d, n), ("ssm", None), init="zeros")
    b.param("d_skip", (d,), ("ssm",), init="ones")
    init_dense(b, "out", d, d, ("heads", "embed"))


def ssm_state_shape(cfg: ModelConfig, batch: int) -> Tuple[int, ...]:
    """[B, D, N] SSM state (+ [B, CONV_K-1, D] conv tail carried apart)."""
    return (batch, cfg.d_model, cfg.ssm_state)


def _conv(p: Dict[str, Any], x: torch.Tensor, tail: torch.Tensor):
    """Causal depthwise conv over x [B, S, D] after `tail` [B, CONV_K-1, D]
    (the previous segment's last inputs) -> (silu(conv), new tail)."""
    xt = torch.cat([tail.to(x.dtype), x], dim=1)              # [B, S+K-1, D]
    w = p["conv_w"].to(x.dtype)
    S = x.shape[1]
    out = sum(xt[:, i:i + S] * w[i] for i in range(CONV_K))
    new_tail = xt[:, -(CONV_K - 1):]
    return F.silu(out + p["conv_b"].to(x.dtype)), new_tail


def _ssm_coeffs(p: Dict[str, Any], xc: torch.Tensor, impl: str):
    """a_t = exp(Δ_t A) [B,S,D,N]; b_t = Δ_t B_t x_t [B,S,D,N]; C_t [B,S,N]."""
    A = -torch.exp(p["a_log"].float())                         # [D, N]
    dt = F.softplus(dense(p, "w_dt", xc, impl=impl).float())   # [B, S, 1]
    Bt = dense(p, "w_b", xc, impl=impl).float()                # [B, S, N]
    Ct = dense(p, "w_c", xc, impl=impl).float()
    a = torch.exp(dt[..., None] * A[None, None])               # [B, S, D, N]
    bx = (dt * xc.float())[..., None] * Bt[:, :, None, :]
    return a, bx, Ct


def _scan_within(a: torch.Tensor, b: torch.Tensor):
    """Inclusive scan of h_t = a_t h_{t-1} + b_t along axis 2 from h = 0
    (and the decay products), by doubling: log2(chunk) combine steps."""
    L = a.shape[2]
    shift = 1
    while shift < L:
        a_l, b_l = a[:, :, :-shift], b[:, :, :-shift]
        a_r, b_r = a[:, :, shift:], b[:, :, shift:]
        b = torch.cat([b[:, :, :shift], b_l * a_r + b_r], dim=2)
        a = torch.cat([a[:, :, :shift], a_l * a_r], dim=2)
        shift *= 2
    return a, b


def selective_scan_chunked(a, bx, C, h0, chunk: int = CHUNK):
    """h_t = a_t h_{t-1} + bx_t ; y_t = C_t · h_t, from h0 [B, D, N].
    Returns (y [B, S, D], h_S [B, D, N])."""
    B, S, D, N = a.shape
    pad = (-S) % chunk
    if pad:
        # padded steps keep the state: decay 1, input 0
        a = F.pad(a, (0, 0, 0, 0, 0, pad), value=1.0)
        bx = F.pad(bx, (0, 0, 0, 0, 0, pad))
        C = F.pad(C, (0, 0, 0, pad))
    n = a.shape[1] // chunk
    acc_a, acc_b = _scan_within(a.reshape(B, n, chunk, D, N),
                                bx.reshape(B, n, chunk, D, N))
    h = h0.float()
    hs = []
    for c in range(n):
        hc = acc_a[:, c] * h[:, None] + acc_b[:, c]            # [B, chunk, D, N]
        hs.append(hc)
        h = hc[:, -1]
    hs = torch.stack(hs, dim=1).reshape(B, n * chunk, D, N)
    y = torch.einsum("bsdn,bsn->bsd", hs, C)[:, :S]
    return y, h


def ssm_mixer(p: Dict[str, Any], cfg: ModelConfig, x: torch.Tensor,
              state: torch.Tensor, conv_tail: torch.Tensor, *,
              impl: str = "auto"):
    """The whole Mamba-style path over x [B, S, D] from (state, conv_tail)
    -> (out, new state, new conv tail)."""
    xz = dense(p, "in_z", x, impl=impl)
    xc = dense(p, "in_x", x, impl=impl)
    xc, new_tail = _conv(p, xc, conv_tail)
    a, bx, Ct = _ssm_coeffs(p, xc, impl)
    y, h_end = selective_scan_chunked(a, bx, Ct, state)
    y = y + xc.float() * p["d_skip"].float()
    out = dense(p, "out", y.to(x.dtype) * F.silu(xz), impl=impl)
    return out, h_end, new_tail


def ssm_decode_step(p: Dict[str, Any], cfg: ModelConfig, x: torch.Tensor,
                    state: torch.Tensor, conv_tail: torch.Tensor, *,
                    impl: str = "auto"):
    """One token x [B, 1, D]: the O(1) state update."""
    xz = dense(p, "in_z", x, impl=impl)
    xc = dense(p, "in_x", x, impl=impl)
    xc, new_tail = _conv(p, xc, conv_tail)
    a, bx, Ct = _ssm_coeffs(p, xc, impl)
    h = a[:, 0] * state.float() + bx[:, 0]                     # [B, D, N]
    y = torch.einsum("bdn,bn->bd", h, Ct[:, 0])[:, None]
    y = y + xc.float() * p["d_skip"].float()
    out = dense(p, "out", y.to(x.dtype) * F.silu(xz), impl=impl)
    return out, h, new_tail
