"""KV page formats (port of the kv8/kv4 half of `repro.core.quant`).

kv8: int8 codes, one symmetric float32 scale per page × kv-head.
kv4: offset-binary nibbles packed along the TOKEN dim — token 2i in the
high nibble, token 2i+1 in the low nibble, offset 8 — so a [T, dh] page
stores as [T/2, dh] uint8.  Rounding is half-to-even on both sides
(`torch.round` and `jnp.round`), so codes match the reference bit for bit.
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
        scale = amax.clamp_min(1e-8) / 127.0
        q = torch.clamp(torch.round(xf / scale[..., None, None]),
                        -127, 127).to(torch.int8)
    elif fmt == "kv4":
        scale = amax.clamp_min(1e-8) / 7.0
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
