"""Page-level KV cache, per-slot stripe layout (port of `repro.core.paged_kv`).

Layout is (layer, head)-major as in the reference:

    k/v_pages_g: [L, B, K, NP, T, dh]   L layers, B slots, K kv heads,
                                        NP pages per slot, T page_tokens
    page_table_g: [B, NP]               identity within the stripe
    lengths: [B]                        tokens written so far

Each slot owns a private stripe of NP = ceil(max_context / T) pages.

In place, not threaded: the reference threads pools through `lax.scan`
as donated carries and gets new arrays back; here the pool tensors are
allocated once and every writer below mutates them IN PLACE (and returns
them, so call sites read like the reference).  As in the reference
(kvlint rule KV004), every pool write lives in this module.

The reference's drop sentinel (an out-of-range page index discarded by
`mode="drop"`) has no torch counterpart — an out-of-range index raises
on the CPU and asserts on the device — so the writers mask rows
explicitly instead: an inactive row rewrites its own current value.

Not ported yet: the shared pool, window rings, kv8/kv4 write paths,
span appends and tier staging (ROADMAP A8-A12).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

from repro_torch.configs.base import EngineConfig, ModelConfig


def ceil_div(a: int, b: int) -> int:
    return -(-a // b)


@dataclass
class DecodeCache:
    """Per-slot decode state of the stripe layout (global-span layers)."""
    k_pages_g: Optional[torch.Tensor] = None    # [L, B, K, NP, T, dh]
    v_pages_g: Optional[torch.Tensor] = None
    page_table_g: Optional[torch.Tensor] = None  # [B, NP] logical -> physical
    lengths: Optional[torch.Tensor] = None      # [B] int32


def check_supported(eng: EngineConfig) -> None:
    """Raise for the pool layouts/formats this slice does not port."""
    if eng.shared_pool or eng.hot_pages:
        raise NotImplementedError(
            "the shared (and tiered) page pool is not ported yet "
            "(ROADMAP: shared pool + kernel B2, tiered pool)")
    if eng.kv_quant != "none":
        raise NotImplementedError(
            f"kv_quant={eng.kv_quant!r} pools are not ported at the engine "
            "level yet (ROADMAP: kv8/kv4 server path); the decode kernel "
            "itself reads kv8/kv4 pages")


def init_cache(cfg: ModelConfig, eng: EngineConfig, batch: int,
               max_context: int, *, dtype=torch.bfloat16,
               device="cuda") -> DecodeCache:
    """Zeroed pools of NP = ceil(max_context / T) pages per slot, identity
    page tables, zero lengths."""
    check_supported(eng)
    T = eng.page_tokens
    K, dh, L = cfg.n_kv_heads, cfg.d_head, cfg.n_layers
    NP = eng.max_pages_per_seq or ceil_div(max_context, T)
    pool = (L, batch, K, NP, T, dh)
    table = torch.arange(NP, dtype=torch.int32, device=device)
    return DecodeCache(
        k_pages_g=torch.zeros(pool, dtype=dtype, device=device),
        v_pages_g=torch.zeros(pool, dtype=dtype, device=device),
        page_table_g=table[None].expand(batch, NP).contiguous(),
        lengths=torch.zeros(batch, dtype=torch.int32, device=device))


# ---------------------------------------------------------------------------
# Page write paths (token append / chunk fill), all in place
# ---------------------------------------------------------------------------

def append_token_inplace(pool: torch.Tensor, layer: int, phys: torch.Tensor,
                         slot: torch.Tensor, val: torch.Tensor,
                         active: Optional[torch.Tensor] = None
                         ) -> torch.Tensor:
    """pool: [L, B, K, NP, T, dh]; write one token's K or V per row.

    phys/slot: [B] page and in-page slot of each row's new token; val:
    [B, K, dh].  Rows with `active` False keep their current contents
    (the reference redirects them to the drop sentinel); their indices
    are clamped into range so the masked rewrite never leaves the stripe.
    """
    NP, T = pool.shape[3], pool.shape[4]
    pool_l = pool[layer]                               # [B, K, NP, T, dh]
    b_idx = torch.arange(pool_l.shape[0], device=pool.device)
    p = phys.long().clamp(0, NP - 1)
    s = slot.long().clamp(0, T - 1)
    new = val.to(pool.dtype)
    if active is not None:
        cur = pool_l[b_idx, :, p, s]                   # [B, K, dh]
        new = torch.where(active[:, None, None], new, cur)
    pool_l[b_idx, :, p, s] = new
    return pool


def _paged_from_seq(kv_seq: torch.Tensor, T: int) -> torch.Tensor:
    """[B, S, K, dh] -> page-major [B, K, n_pages, T, dh] (zero-padded)."""
    B, S, K, dh = kv_seq.shape
    n_pages = ceil_div(S, T)
    pad = n_pages * T - S
    if pad:
        kv_seq = torch.cat([kv_seq, kv_seq.new_zeros(B, pad, K, dh)], dim=1)
    return kv_seq.reshape(B, n_pages, T, K, dh).permute(0, 3, 1, 2, 4)


def fill_chunk_global_at(pool: torch.Tensor, kv_chunk: torch.Tensor,
                         layer: int, slot: int, page0: int,
                         valid_len: int) -> torch.Tensor:
    """Write one slot's prompt chunk into its stripe, whole pages at once.

    pool: [L, B, K, NP, T, dh]; kv_chunk: [1, C, K, dh]; page0: the
    chunk's first page (chunk starts are page-aligned).  Only pages
    holding at least one of the `valid_len` real tokens are written, and
    a page past the stripe is skipped (the reference drops it).
    """
    NP, T = pool.shape[3], pool.shape[4]
    x = _paged_from_seq(kv_chunk, T)                   # [1, K, n, T, dh]
    n_w = min(ceil_div(valid_len, T), x.shape[2], max(NP - page0, 0))
    if n_w > 0:
        pool[layer, slot, :, page0:page0 + n_w] = x[0, :, :n_w].to(pool.dtype)
    return pool
