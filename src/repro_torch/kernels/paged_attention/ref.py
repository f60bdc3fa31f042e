"""Plain torch paged attention (port of `repro.kernels.paged_attention.ref`).

`paged_attention_partial_ref` is the plain version of the stripe CUDA
decode kernel and `paged_attention_shared_ref` that of the shared-pool
kernel (`gather_table_pages`, then the stripe oracle — the reference's
`impl="ref"` path): the CPU path and the yardsticks the kernels are held
against on the card.  `paged_chunk_attention_ref` is the past-context
partial of chunked prefill, which has no kernel in the reference either.

Arithmetic mirrors the reference: bf16/f32 pools are contracted in the
POOL dtype with float32 accumulation (q and p rounded to the pool dtype,
products summed in f32); kv8/kv4 codes are contracted in f32 with the
per-page K scale folded into the scores and the V scale into p.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.core.quant import unpack_int4_tokens

NEG_INF = -1e30


def _pool_operands(k_pages, v_pages, kv_quant: str):
    """(k, v, dt): float32 operands plus the dtype q and p round through."""
    if kv_quant != "none":
        if kv_quant == "kv4":
            k_pages = unpack_int4_tokens(k_pages)
            v_pages = unpack_int4_tokens(v_pages)
        return k_pages.float(), v_pages.float(), torch.float32
    return k_pages.float(), v_pages.float(), k_pages.dtype


def paged_attention_partial_ref(
    q: torch.Tensor,          # [B, H, dh]
    k_pages: torch.Tensor,    # [B, K, NP, T, dh] (kv4: [B, K, NP, T/2, dh])
    v_pages: torch.Tensor,
    page_base: torch.Tensor,  # [B, NP] absolute pos of slot 0 (<0 = unwritten)
    length: torch.Tensor,     # [B] context length incl. current token
    *,
    window: Optional[int] = None,
    kv_quant: str = "none",
    k_scale: Optional[torch.Tensor] = None,   # [B, K, NP]
    v_scale: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Returns (o [B, H, dh] locally normalized, m [B, H], l [B, H])."""
    B, K, NP = k_pages.shape[:3]
    dh = k_pages.shape[-1]
    T = 2 * k_pages.shape[3] if kv_quant == "kv4" else k_pages.shape[3]
    H = q.shape[1]
    G = H // K
    scale = dh ** -0.5
    kf, vf, dt = _pool_operands(k_pages, v_pages, kv_quant)
    qg = (q.float() * scale).to(dt).float().reshape(B, K, G, dh)

    slots = torch.arange(T, device=q.device)
    pos = page_base[:, :, None] + slots[None, None, :]          # [B, NP, T]
    valid = (page_base >= 0)[:, :, None] & (pos < length[:, None, None])
    if window is not None:
        valid &= pos > (length[:, None, None] - 1 - window)
    mask = valid[:, None, None]                                  # [B,1,1,NP,T]

    s = torch.einsum("bkgd,bkntd->bkgnt", qg, kf)               # [B,K,G,NP,T]
    if kv_quant != "none":
        s = s * k_scale.float()[:, :, None, :, None]
    s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    m = s.amax(dim=(-2, -1))                                     # [B, K, G]
    p = torch.exp(s - m[..., None, None])
    p = torch.where(mask, p, torch.zeros_like(p))
    l = p.sum(dim=(-2, -1))
    pv = p * v_scale.float()[:, :, None, :, None] if kv_quant != "none" else p
    o = torch.einsum("bkgnt,bkntd->bkgd", pv.to(dt).float(), vf)
    o = o / l.clamp_min(1e-30)[..., None]
    return o.reshape(B, H, dh), m.reshape(B, H), l.reshape(B, H)


def gather_table_pages(pages: torch.Tensor,
                       page_table: torch.Tensor) -> torch.Tensor:
    """Shared-pool view: gather each slot's pages through its table.

    pages: [K, P_total, ...] pool (code pages [K, P, Ts, dh] or scales
    [K, P]); page_table: [B, NP] physical indices, every entry in
    [0, P_total).  Returns the per-slot stripe view [B, K, NP, ...]."""
    return pages[:, page_table.long()].movedim(1, 0)


def paged_attention_shared_ref(
    q: torch.Tensor,           # [B, H, dh]
    k_pages: torch.Tensor,     # [K, P_total, T, dh] (kv4: [K, P, T/2, dh])
    v_pages: torch.Tensor,
    page_table: torch.Tensor,  # [B, NP] physical page of each logical page
    page_base: torch.Tensor,   # [B, NP] absolute pos of logical page slot 0
    length: torch.Tensor,      # [B]
    *,
    window: Optional[int] = None,
    kv_quant: str = "none",
    k_scale: Optional[torch.Tensor] = None,    # [K, P_total]
    v_scale: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain shared-pool decode partial: the slot's pages gathered through
    its table row, then the stripe oracle.  Returns (o [B, H, dh], m, l)."""
    ks = vs = None
    if kv_quant != "none":
        ks = gather_table_pages(k_scale, page_table)
        vs = gather_table_pages(v_scale, page_table)
    return paged_attention_partial_ref(
        q, gather_table_pages(k_pages, page_table),
        gather_table_pages(v_pages, page_table), page_base, length,
        window=window, kv_quant=kv_quant, k_scale=ks, v_scale=vs)


def paged_chunk_attention_ref(
    q: torch.Tensor,          # [B, S, H, dh] span queries
    k_pages: torch.Tensor,    # [B, K, NP, T, dh] the slot's page stripe
    v_pages: torch.Tensor,
    page_base: torch.Tensor,  # [B, NP]
    start,                    # int or [B]: keys strictly below attend
    q_pos: torch.Tensor,      # [S] or [B, S] absolute query positions
    *,
    window: Optional[int] = None,
    kv_quant: str = "none",
    k_scale: Optional[torch.Tensor] = None,
    v_scale: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Past-context partial of a multi-token span against the slot's
    already-written pages; keys at positions >= `start` are masked (the
    span's own K/V go through the in-span causal partial).  Returns
    (o [B, S, H, dh], m [B, S, H], l [B, S, H])."""
    B, K, NP = k_pages.shape[:3]
    dh = k_pages.shape[-1]
    T = 2 * k_pages.shape[3] if kv_quant == "kv4" else k_pages.shape[3]
    S, H = q.shape[1], q.shape[2]
    G = H // K
    scale = dh ** -0.5
    kf, vf, dt = _pool_operands(k_pages, v_pages, kv_quant)
    qg = (q.float() * scale).to(dt).float().reshape(B, S, K, G, dh)

    start = torch.as_tensor(start, dtype=torch.int32,
                            device=q.device).expand(B)
    q_pos = torch.as_tensor(q_pos, device=q.device)
    if q_pos.ndim == 1:
        q_pos = q_pos[None].expand(B, S)

    slots = torch.arange(T, device=q.device)
    pos = page_base[:, :, None] + slots[None, None, :]          # [B, NP, T]
    valid = (page_base >= 0)[:, :, None] & (pos < start[:, None, None])
    mask = valid[:, None, None, None]                  # [B, 1, 1, 1, NP, T]
    if window is not None:
        in_w = pos[:, None] > (q_pos[:, :, None, None] - window)  # [B,S,NP,T]
        mask = mask & in_w[:, None, None]

    s = torch.einsum("bskgd,bkntd->bkgsnt", qg, kf)     # [B,K,G,S,NP,T]
    if kv_quant != "none":
        s = s * k_scale.float()[:, :, None, None, :, None]
    s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    m = s.amax(dim=(-2, -1))                            # [B, K, G, S]
    p = torch.exp(s - m[..., None, None])
    p = torch.where(mask, p, torch.zeros_like(p))
    l = p.sum(dim=(-2, -1))
    if kv_quant != "none":
        p = p * v_scale.float()[:, :, None, None, :, None]
    o = torch.einsum("bkgsnt,bkntd->bskgd", p.to(dt).float(), vf)
    o = o / l.clamp_min(1e-30).permute(0, 3, 1, 2)[..., None]
    return (o.reshape(B, S, H, dh),
            m.permute(0, 3, 1, 2).reshape(B, S, H),
            l.permute(0, 3, 1, 2).reshape(B, S, H))
