"""Weight and KV-page quantization (port of `repro.core.quant`).

Weights (the paper's W8A8 / W4A16 design-space axis): `QuantizedWeight`,
`quantize_weight`, `dequantize`, `quantize_activations_int8` and the
tree-level `quantize_params`; `models.layers.dense` sends every 2-D
quantized leaf through the `quant_gemv` kernel.

KV pages — kv8: int8 codes, one symmetric float32 scale per page × kv-head.
kv4: offset-binary nibbles packed along the TOKEN dim — token 2i in the
high nibble, token 2i+1 in the low nibble, offset 8 — so a [T, dh] page
stores as [T/2, dh] uint8.

Rounding is half-to-even on both sides (`torch.round` and `jnp.round`),
so codes and scales match the reference bit for bit.
"""
from __future__ import annotations

import torch

KV_QUANT_FORMATS = ("none", "kv8", "kv4")


def kv_storage_dtype(fmt: str) -> torch.dtype:
    return {"kv8": torch.int8, "kv4": torch.uint8}[fmt]


def kv_page_tokens_stored(page_tokens: int, fmt: str) -> int:
    """Length of the (possibly packed) token dim in storage."""
    if fmt == "kv4":
        if page_tokens % 2:
            raise ValueError(f"kv4 needs even page_tokens, got {page_tokens}")
        return page_tokens // 2
    return page_tokens


def pack_int4_tokens(q: torch.Tensor) -> torch.Tensor:
    """[..., T, dh] offset-binary int (0..15) -> [..., T/2, dh] uint8."""
    hi = q[..., 0::2, :].to(torch.uint8)
    lo = q[..., 1::2, :].to(torch.uint8)
    return (hi << 4) | lo


def unpack_int4_tokens(q: torch.Tensor) -> torch.Tensor:
    """[..., T/2, dh] uint8 -> [..., T, dh] int8 centered at 0 (-8 offset)."""
    hi = ((q >> 4) & 0xF).to(torch.int8) - 8
    lo = (q & 0xF).to(torch.int8) - 8
    out = torch.stack([hi, lo], dim=-2)                 # [..., T/2, 2, dh]
    return out.reshape(q.shape[:-2] + (2 * q.shape[-2],) + q.shape[-1:])


def quantize_kv_page(x: torch.Tensor, fmt: str):
    """x: [..., T, dh] float -> (q [..., T(/2), dh] int, scale [...] f32)."""
    xf = x.float()
    amax = xf.abs().amax(dim=(-2, -1))
    if fmt == "kv8":
        scale = amax.clamp_min(1e-8) * (1.0 / 127.0)
        q = torch.clamp(torch.round(xf / scale[..., None, None]),
                        -127, 127).to(torch.int8)
    elif fmt == "kv4":
        scale = amax.clamp_min(1e-8) * (1.0 / 7.0)
        q = torch.clamp(torch.round(xf / scale[..., None, None]),
                        -7, 7).to(torch.int8) + 8
        q = pack_int4_tokens(q)
    else:
        raise ValueError(fmt)
    return q, scale


def dequantize_kv_page(q: torch.Tensor, scale: torch.Tensor, fmt: str,
                       dtype=torch.float32) -> torch.Tensor:
    """Inverse of `quantize_kv_page`; scale broadcasts over [T, dh]."""
    if fmt == "kv8":
        w = q.float()
    elif fmt == "kv4":
        w = unpack_int4_tokens(q).float()
    else:
        raise ValueError(fmt)
    return (w * scale[..., None, None]).to(dtype)


# ---------------------------------------------------------------------------
# Weights (port of the W8A8 / W4A16 half of `repro.core.quant`)
# ---------------------------------------------------------------------------
#
# Weights quantize symmetrically per output channel.  w8a8: int8 codes
# [..., D, F]; w4a16: offset-binary nibbles packed along the INPUT dim, row
# 2i in the high nibble and row 2i+1 in the low nibble, offset 8, so
# [..., D, F] stores as [..., D/2, F] uint8.  Scales are [..., F] float32.

class QuantizedWeight:
    """A quantized weight leaf of the parameter tree (the reference's
    pytree class of the same name).  `q`: int8 [..., D, F] (w8a8) or
    uint8 [..., D/2, F] (w4a16); `scale`: float32 [..., F]; `orig_shape`:
    the float weight's shape.  Indexing takes the leading (layer) axis of
    a stacked leaf, so `layers.layer_slice` turns [L, D/2, F] into one
    layer's [D/2, F]."""

    def __init__(self, q: torch.Tensor, scale: torch.Tensor, scheme: str,
                 orig_shape):
        self.q = q
        self.scale = scale
        self.scheme = scheme
        self.orig_shape = tuple(int(s) for s in orig_shape)

    def __getitem__(self, i: int) -> "QuantizedWeight":
        return QuantizedWeight(self.q[i], self.scale[i], self.scheme,
                               self.orig_shape[1:])

    def to(self, device) -> "QuantizedWeight":
        return QuantizedWeight(self.q.to(device), self.scale.to(device),
                               self.scheme, self.orig_shape)

    def __repr__(self):
        return (f"QuantizedWeight({self.scheme}, {self.orig_shape}, "
                f"q={tuple(self.q.shape)})")


def quantize_weight(w: torch.Tensor, scheme: str) -> QuantizedWeight:
    """w: [..., D, F] -> per-(..., F)-channel symmetric quantization."""
    wf = w.float()
    amax = wf.abs().amax(dim=-2, keepdim=True)                 # [..., 1, F]
    if scheme == "w8a8":
        scale = amax.clamp_min(1e-8) / 127.0
        q = torch.clamp(torch.round(wf / scale), -127, 127).to(torch.int8)
    elif scheme == "w4a16":
        scale = amax.clamp_min(1e-8) / 7.0
        q = torch.clamp(torch.round(wf / scale), -7, 7).to(torch.int8) + 8
        if q.shape[-2] % 2:
            raise ValueError("w4a16 needs an even input dim")
        hi = q[..., 0::2, :].to(torch.uint8)
        lo = q[..., 1::2, :].to(torch.uint8)
        q = (hi << 4) | lo
    else:
        raise ValueError(scheme)
    return QuantizedWeight(q, scale[..., 0, :], scheme, w.shape)


def unpack_int4(q: torch.Tensor) -> torch.Tensor:
    """[..., D/2, F] uint8 -> [..., D, F] int32 in [-8, 7] (row 2i from the
    high nibble)."""
    hi = ((q >> 4) & 0xF).to(torch.int32) - 8
    lo = (q & 0xF).to(torch.int32) - 8
    out = torch.stack([hi, lo], dim=-2)                        # [..., D/2, 2, F]
    return out.reshape(q.shape[:-2] + (2 * q.shape[-2],) + q.shape[-1:])


def dequantize(qw: QuantizedWeight, dtype=torch.bfloat16) -> torch.Tensor:
    wf = (qw.q.float() if qw.scheme == "w8a8"
          else unpack_int4(qw.q).float())
    return (wf * qw.scale[..., None, :]).to(dtype)


def quantize_activations_int8(x: torch.Tensor):
    """Per-token symmetric int8 activation quantization (w8a8): returns
    (codes int8 [..., D], scale float32 [..., 1])."""
    xf = x.float()
    amax = xf.abs().amax(dim=-1, keepdim=True)
    scale = amax.clamp_min(1e-8) / 127.0
    q = torch.clamp(torch.round(xf / scale), -127, 127)
    return q.to(torch.int8), scale


_QUANT_SUFFIXES = ("_w",)
_QUANT_KEYS = ("w_gate", "w_up", "w_down")
_SKIP_KEYS = ("embedding", "meta_tokens", "conv_w", "router_w")


def _should_quantize(key: str, leaf) -> bool:
    if not isinstance(leaf, torch.Tensor) or leaf.ndim < 2:
        return False
    if key in _SKIP_KEYS:
        return False
    return key.endswith(_QUANT_SUFFIXES) or key in _QUANT_KEYS


def quantize_params(params, scheme: str):
    """Quantize every matmul weight of the tree (norms, biases and
    embeddings stay float); the leaves stay on their device."""
    if scheme in (None, "none"):
        return params

    def walk(tree):
        out = {}
        for k, v in tree.items():
            if isinstance(v, dict):
                out[k] = walk(v)
            elif _should_quantize(k, v):
                out[k] = quantize_weight(v, scheme)
            else:
                out[k] = v
        return out

    return walk(params)
