"""Core layers and the parameter initializer (port of `repro.models.layers`).

Parameters are the reference's tree, as plain nested dicts of tensors:
`bridge.params_from_numpy` carries a reference tree over leaf for leaf,
and `ParamInit` draws a fresh one with the reference's initializers from
an explicit `torch.Generator` (same shapes and scales, different random
numbers — torch's generator is not jax's threefry).
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional, Sequence

import torch
import torch.nn.functional as F

from repro_torch.core.quant import QuantizedWeight
from repro_torch.kernels.quant_gemv import quant_gemv

# ---------------------------------------------------------------------------
# Parameter init (counterpart of ParamBuilder's fan-in normal init)
# ---------------------------------------------------------------------------


class ParamInit:
    """Builds a parameter tree with the reference initializers.

    `param` mirrors `ParamBuilder.param`: "zeros", "ones", or a fan-in
    scaled normal (fan_in = shape[0] for 1-D, else shape[-2]) drawn in
    float32 on `device` from `generator`.
    `stack` prepends a layer axis WITHOUT changing fan-in, as the
    reference's vmapped per-layer init does.
    """

    def __init__(self, generator: torch.Generator, device, stack: int = 0):
        self.generator = generator
        self.device = device
        self.stack = stack
        self.params: Dict[str, Any] = {}

    def param(self, name: str, shape: Sequence[int], *, init: str = "normal",
              scale: Optional[float] = None) -> torch.Tensor:
        full = ((self.stack,) if self.stack else ()) + tuple(shape)
        if init == "zeros":
            val = torch.zeros(full, device=self.device)
        elif init == "ones":
            val = torch.ones(full, device=self.device)
        else:
            if scale is None:
                fan_in = shape[0] if len(shape) == 1 else shape[-2]
                scale = 1.0 / math.sqrt(max(fan_in, 1))
            val = torch.randn(full, generator=self.generator,
                              device=self.device) * scale
        self.params[name] = val
        return val

    def scope(self, name: str) -> "ParamInit":
        sub = ParamInit(self.generator, self.device, self.stack)
        self.params[name] = sub.params
        return sub


def layer_slice(tree, i: int):
    """Per-layer view of a stacked parameter tree (leading layer axis)."""
    if isinstance(tree, dict):
        return {k: layer_slice(v, i) for k, v in tree.items()}
    return tree[i]


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------

def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-5) -> torch.Tensor:
    """RMS norm with a `1 + w` scale, computed in float32."""
    dt = x.dtype
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    xf = xf * torch.rsqrt(var + eps)
    return (xf * (1.0 + scale.float())).to(dt)


# ---------------------------------------------------------------------------
# Rotary position embedding
# ---------------------------------------------------------------------------

def rope_frequencies(d_head: int, theta: float, device=None) -> torch.Tensor:
    half = d_head // 2
    return 1.0 / (theta ** (torch.arange(0, half, dtype=torch.float32,
                                         device=device) / half))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: [..., seq, heads, d_head]; positions: [..., seq] (int).

    Split-half rotation with the angles in float32."""
    d_head = x.shape[-1]
    freqs = rope_frequencies(d_head, theta, x.device)           # [half]
    angles = positions[..., :, None].float() * freqs            # [..., S, half]
    cos = torch.cos(angles)[..., :, None, :]                    # [..., S, 1, half]
    sin = torch.sin(angles)[..., :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Dense / MLP
# ---------------------------------------------------------------------------

def init_dense(b: ParamInit, name: str, in_dim: int, out_dim: int):
    b.param(f"{name}_w", (in_dim, out_dim))


def dense(params: Dict[str, Any], name: str, x: torch.Tensor, *,
          impl: str = "auto") -> torch.Tensor:
    """`x @ w (+ b)`.  A float weight is a plain matrix product, left to
    torch.matmul as the reference leaves it to XLA; a quantized weight goes
    through `quant_gemv` (kernel B3 on a card; impl="ref" asks for its
    plain version on any device)."""
    w = params[f"{name}_w"]
    if isinstance(w, QuantizedWeight):
        y = quant_gemv(x, w, impl=impl)
    else:
        y = torch.matmul(x, w.to(x.dtype))
    b = params.get(f"{name}_b")
    if b is not None:
        y = y + b.to(y.dtype)
    return y


def init_mlp(b: ParamInit, d_model: int, d_ff: int, gated: bool):
    if gated:
        init_dense(b, "gate", d_model, d_ff)
    init_dense(b, "up", d_model, d_ff)
    init_dense(b, "down", d_ff, d_model)


def mlp(params: Dict[str, Any], x: torch.Tensor, gated: bool, *,
        impl: str = "auto") -> torch.Tensor:
    if gated:
        h = (F.silu(dense(params, "gate", x, impl=impl))
             * dense(params, "up", x, impl=impl))
    else:
        h = F.gelu(dense(params, "up", x, impl=impl), approximate="tanh")
    return dense(params, "down", h, impl=impl)


# ---------------------------------------------------------------------------
# Embedding
# ---------------------------------------------------------------------------

def init_embedding(b: ParamInit, vocab: int, d_model: int,
                   name: str = "embedding"):
    # 1/sqrt(d) keeps tied-lm-head logits O(1) at init
    b.param(name, (vocab, d_model), scale=d_model ** -0.5)


def embed_lookup(table: torch.Tensor, ids: torch.Tensor,
                 dtype) -> torch.Tensor:
    return table[ids.long()].to(dtype)
