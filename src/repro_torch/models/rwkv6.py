"""RWKV6 (Finch) time-mix and channel-mix (port of `repro.models.rwkv6`
and of the channel-mix the reference writes out in its RWKV blocks).

Data-dependent token shift (LoRA-modulated lerp), per-channel
data-dependent decay bounded to (-4.05, -0.05), bonus u, multi-head wkv
state S ∈ [H, dh_k, dh_v], gated output with a per-head group norm.  The
wkv core lives in `kernels/wkv6` (plain versions in `ref.py`, kernel B5 on
a card); a multi-token call goes through `wkv6`, a single token through
the recurrence, as in the reference.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.wkv6 import wkv6
from repro_torch.kernels.wkv6.ref import wkv_recurrent
from repro_torch.models.layers import ParamInit, dense, init_dense, rms_norm

LORA_RANK = 32


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def init_rwkv_timemix(b: ParamInit, cfg: ModelConfig):
    d = cfg.d_model
    H, dh = cfg.n_heads, cfg.d_head
    # data-dependent token shift: base lerp factors + low-rank modulation
    b.param("mu_base", (5, d), (None, "ssm"), init="zeros")   # r,k,v,g,w
    b.param("mu_x", (d,), ("ssm",), init="zeros")
    b.param("lora_a", (d, LORA_RANK), ("embed", None), scale=0.01)
    b.param("lora_b", (LORA_RANK, 5, d), (None, None, "ssm"), scale=0.01)
    # decay + bonus
    b.param("w0", (d,), ("ssm",), init="zeros")
    b.param("wlora_a", (d, LORA_RANK), ("embed", None), scale=0.01)
    b.param("wlora_b", (LORA_RANK, d), (None, "ssm"), scale=0.01)
    b.param("u", (H, dh), (None, "ssm"), scale=0.5)
    # projections
    for name in ("wr", "wk", "wv", "wg"):
        init_dense(b, name, d, d, ("embed", "heads"))
    init_dense(b, "wo", d, d, ("heads", "embed"))
    b.param("ln_scale", (d,), ("norm",), init="ones")  # post-wkv group norm


def init_rwkv_channelmix(b: ParamInit, cfg: ModelConfig):
    b.param("mu_k", (cfg.d_model,), ("ssm",), init="zeros")
    b.param("mu_r", (cfg.d_model,), ("ssm",), init="zeros")
    init_dense(b, "ck", cfg.d_model, cfg.d_ff, ("embed", "mlp"))
    init_dense(b, "cv", cfg.d_ff, cfg.d_model, ("mlp", "embed"))
    init_dense(b, "cr", cfg.d_model, cfg.d_model, ("embed", "heads"))


def rwkv_state_shape(cfg: ModelConfig, batch: int) -> Tuple[int, ...]:
    """Per-layer recurrent state: [B, H, dh_k, dh_v] (+ shift token [B, D])."""
    return (batch, cfg.n_heads, cfg.d_head, cfg.d_head)


# ---------------------------------------------------------------------------
# shared projections
# ---------------------------------------------------------------------------

def _mix_inputs(p: Dict[str, Any], x: torch.Tensor, x_prev: torch.Tensor):
    """Data-dependent lerp between current and shifted token (5 streams)."""
    xx = x_prev - x                                           # [B, S, D]
    xmix = x + xx * p["mu_x"].to(x.dtype)
    lora = torch.tanh(xmix @ p["lora_a"].to(x.dtype))         # [B, S, R]
    deltas = torch.einsum("bsr,rcd->bcsd", lora,
                          p["lora_b"].to(x.dtype))            # [B, 5, S, D]
    mus = p["mu_base"].to(x.dtype)[None, :, None, :] + deltas
    mixed = x[:, None] + xx[:, None] * mus                    # [B, 5, S, D]
    return [mixed[:, i] for i in range(5)]                    # r,k,v,g,w


def _decay(p: Dict[str, Any], xw: torch.Tensor) -> torch.Tensor:
    """Bounded per-channel log-decay in (-4.05, -0.05)."""
    dw = torch.tanh(xw @ p["wlora_a"].to(xw.dtype)) @ \
        p["wlora_b"].to(xw.dtype)
    return -0.05 - 4.0 * torch.sigmoid(p["w0"].float() + dw.float())


def _project_rkvg(p, cfg: ModelConfig, xr, xk, xv, xg):
    B, S, _ = xr.shape
    H, dh = cfg.n_heads, cfg.d_head
    r = dense(p, "wr", xr).reshape(B, S, H, dh)
    k = dense(p, "wk", xk).reshape(B, S, H, dh)
    v = dense(p, "wv", xv).reshape(B, S, H, dh)
    g = F.silu(dense(p, "wg", xg))
    return r, k, v, g


def _group_norm(x: torch.Tensor, scale: torch.Tensor, H: int) -> torch.Tensor:
    """Per-head layer norm of the wkv output ([B, S, H*dh])."""
    B, S, D = x.shape
    xh = x.reshape(B, S, H, D // H).float()
    mean = xh.mean(-1, keepdim=True)
    var = xh.var(-1, keepdim=True, unbiased=False)
    xh = (xh - mean) * torch.rsqrt(var + 1e-5)
    return (xh.reshape(B, S, D) * scale.float()).to(x.dtype)


# ---------------------------------------------------------------------------
# the layers
# ---------------------------------------------------------------------------

def rwkv_timemix(p: Dict[str, Any], cfg: ModelConfig, x: torch.Tensor,
                 state: torch.Tensor, shift: torch.Tensor, *,
                 chunked: bool = True, impl: str = "auto"):
    """x: [B,S,D]; state: [B,H,dh,dh]; shift: [B,D] (previous last token).

    Returns (out [B,S,D], new_state, new_shift).  A multi-token chunked
    call runs `wkv6` (`impl` as there: kernel B5 on a card), otherwise the
    recurrence."""
    B, S, D = x.shape
    H = cfg.n_heads
    x_prev = torch.cat([shift[:, None], x[:, :-1]], dim=1)
    xr, xk, xv, xg, xw = _mix_inputs(p, x, x_prev)
    r, k, v, g = _project_rkvg(p, cfg, xr, xk, xv, xg)
    logw = _decay(p, xw).reshape(B, S, H, cfg.d_head)
    u = p["u"].float()

    if chunked and S > 1:
        out, state = wkv6(r, k, v, logw, u, state, impl=impl)
    else:
        out, state = wkv_recurrent(r, k, v, logw, u, state)
    out = _group_norm(out.reshape(B, S, D), p["ln_scale"], H)
    out = dense(p, "wo", out * g)
    return out, state, x[:, -1]


def channel_mix(p: Dict[str, Any], h: torch.Tensor,
                h_prev: torch.Tensor) -> torch.Tensor:
    """Token-shifted squared-ReLU FFN with a sigmoid receptance gate."""
    xk = h + (h_prev - h) * p["mu_k"].to(h.dtype)
    xr = h + (h_prev - h) * p["mu_r"].to(h.dtype)
    k = torch.square(F.relu(dense(p, "ck", xk)))
    v = dense(p, "cv", k)
    r = torch.sigmoid(dense(p, "cr", xr))
    return r * v


def rwkv_block(pl_: Dict[str, Any], cfg: ModelConfig, x: torch.Tensor,
               state: torch.Tensor, shift: torch.Tensor, shift2: torch.Tensor,
               *, chunked: bool = True, impl: str = "auto"):
    """One RWKV6 block from carried state (the reference's `_rwkv_block`
    and the engine's three RWKV blocks, which differ only in where the
    state comes from): x [B, S, D]; state [B, H, dh, dh]; shift / shift2
    [B, D], the time-mix and channel-mix inputs of the token before x.
    Returns (x, state, shift, shift2) after the block."""
    h = rms_norm(x, pl_["ln1"], cfg.norm_eps)
    tout, state, shift = rwkv_timemix(pl_["tmix"], cfg, h, state,
                                      shift.to(h.dtype), chunked=chunked,
                                      impl=impl)
    x = x + tout
    h = rms_norm(x, pl_["ln2"], cfg.norm_eps)
    h_prev = torch.cat([shift2.to(h.dtype)[:, None], h[:, :-1]], dim=1)
    x = x + channel_mix(pl_["cmix"], h, h_prev)
    return x, state, shift, h[:, -1]
