"""Page-level KV cache (port of `repro.core.paged_kv`): the per-slot
stripe layout and the shared pool.

Layouts are (layer, head)-major as in the reference:

    stripe (default)                     shared pool (shared_pool=True)
    k/v_pages_g: [L, B, K, NP, T, dh]    k/v_pages_g: [L, K, P, T, dh]
    page_table_g: [B, NP] identity       page_table_g: [B, NP] -> [0, P)
    lengths: [B]                         lengths: [B]

L layers, B slots, K kv heads, NP = ceil(max_context / T) logical pages
per slot, T page_tokens, P = total_pages or B·NP physical pages.  In the
stripe layout each slot owns a private stripe; in the shared pool every
slot reaches its pages through its table row, whose entries the host
allocator (`core/page_alloc.py`, driven by the scheduler) hands out.

In place, not threaded: the reference threads pools through `lax.scan`
as donated carries and gets new arrays back; here the pool tensors are
allocated once and every writer below mutates them IN PLACE (and returns
them, so call sites read like the reference).  As in the reference
(kvlint rule KV004), every pool and page-table write lives in this
module.

The reference's drop sentinel (an out-of-range page index discarded by
`mode="drop"`) has no torch counterpart — an out-of-range index raises
on the CPU and asserts on the device.  The stripe writers mask rows
instead: an inactive row rewrites its own current value, which is safe
because no other row can name a cell of its private stripe.  In a shared
pool that is NOT safe: an empty slot's table row starts at page 0 and a
freed slot keeps stale entries, so an inactive row's (page, slot) can be
the very cell an active row writes in the same scatter, and duplicate
indices in one `index_put_` leave the winner undefined on CUDA.  So the
shared writers take the ACTIVE ROW SUBSET only (`rows`, from the
engine's active mask): active rows own their write page exclusively (the
scheduler allocates or copies-on-write it first), so no two rows of one
scatter ever name one cell.

Not ported yet: window rings, kv8/kv4 write paths, span appends and
tier staging (ROADMAP A9-A12).
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
    """Decode state of the global-span layers (stripe or shared pool)."""
    k_pages_g: Optional[torch.Tensor] = None    # [L, B, K, NP, T, dh] or
    v_pages_g: Optional[torch.Tensor] = None    # shared [L, K, P, T, dh]
    page_table_g: Optional[torch.Tensor] = None  # [B, NP] logical -> physical
    lengths: Optional[torch.Tensor] = None      # [B] int32


def check_supported(eng: EngineConfig) -> None:
    """Raise for the pool layouts/formats the port does not serve yet."""
    if eng.hot_pages:
        raise NotImplementedError(
            "the tiered pool (hot_pages) is not ported yet (ROADMAP A12: "
            "tiered pool)")
    if eng.kv_quant != "none":
        raise NotImplementedError(
            f"kv_quant={eng.kv_quant!r} pools are not ported at the engine "
            "level yet (ROADMAP: kv8/kv4 server path); the decode kernel "
            "itself reads kv8/kv4 pages")


def init_cache(cfg: ModelConfig, eng: EngineConfig, batch: int,
               max_context: int, *, dtype=torch.bfloat16,
               device="cuda") -> DecodeCache:
    """Zeroed pools, zero lengths.  Stripe: NP = ceil(max_context / T)
    pages per slot, identity tables.  Shared: one pool of P =
    total_pages or B·NP pages, tables of identity stripes mod P (slot b's
    logical page j on physical page (b·NP + j) mod P — the allocator-free
    default; the scheduler overwrites the tables from its allocator)."""
    check_supported(eng)
    T = eng.page_tokens
    K, dh, L = cfg.n_kv_heads, cfg.d_head, cfg.n_layers
    NP = eng.max_pages_per_seq or ceil_div(max_context, T)
    logical = torch.arange(NP, dtype=torch.int32, device=device)
    if eng.shared_pool:
        P = eng.total_pages or batch * NP
        pool = (L, K, P, T, dh)
        rows = torch.arange(batch, dtype=torch.int32, device=device)
        table = (rows[:, None] * NP + logical[None]) % P
    else:
        pool = (L, batch, K, NP, T, dh)
        table = logical[None].expand(batch, NP).contiguous()
    return DecodeCache(
        k_pages_g=torch.zeros(pool, dtype=dtype, device=device),
        v_pages_g=torch.zeros(pool, dtype=dtype, device=device),
        page_table_g=table,
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


# ---------------------------------------------------------------------------
# Shared-pool write paths: all coordinates go through the page table
# ---------------------------------------------------------------------------
#
# Pools are [L, K, P, T, dh]; the per-slot page tables hold GLOBAL physical
# indices in [0, P) handed out by the host allocator.  Only active rows
# write (see the module docstring), and a chunk fill writes only pages
# holding real tokens.

def append_global_shared(pool: torch.Tensor, layer: int, phys: torch.Tensor,
                         slot: torch.Tensor, val: torch.Tensor,
                         rows: Optional[torch.Tensor] = None
                         ) -> torch.Tensor:
    """Ragged one-token append into a shared pool [L, K, P, T, dh].

    phys/slot: [B] physical page and in-page slot of each row's new
    token; val: [B, K, dh].  `rows` (int64 indices) selects the rows
    that write — the active ones, each owning its page exclusively; None
    writes every row."""
    if rows is not None:
        phys, slot, val = phys[rows], slot[rows], val[rows]
    by_cell = pool[layer].permute(1, 2, 0, 3)          # [P, T, K, dh] view
    by_cell[phys.long(), slot.long()] = val.to(pool.dtype)
    return pool


def fill_chunk_global_at_shared(pool: torch.Tensor, kv_chunk: torch.Tensor,
                                layer: int, table_row: torch.Tensor,
                                page0: int, valid_len: int) -> torch.Tensor:
    """Shared-pool `fill_chunk_global_at`: chunk page sp lands on the
    physical page `table_row[page0 + sp]`.

    pool: [L, K, P, T, dh]; kv_chunk: [1, C, K, dh]; table_row: [NP].
    Only pages holding at least one of the `valid_len` real tokens are
    written, and a logical page past the table is skipped (the reference
    drops it)."""
    T = pool.shape[3]
    NP = table_row.shape[0]
    x = _paged_from_seq(kv_chunk, T)                   # [1, K, n, T, dh]
    n_w = min(ceil_div(valid_len, T), x.shape[2], max(NP - page0, 0))
    if n_w > 0:
        phys = table_row[page0:page0 + n_w].long()
        pool[layer][:, phys] = x[0, :, :n_w].to(pool.dtype)
    return pool


def copy_page_shared(pool: torch.Tensor, src: int, dst: int) -> torch.Tensor:
    """Copy physical page src -> dst across ALL layers of a shared pool
    [L, K, P, ...], in place (copy-on-write: the new exclusive owner starts
    from the shared page's bytes).  It runs on the current stream, so it
    reaches the pool before any later append into `dst`."""
    pool[:, :, dst] = pool[:, :, src]
    return pool


def write_page_table(table: torch.Tensor, host_rows) -> torch.Tensor:
    """Mirror the host page tables (numpy [B, NP] int32) into the device
    table in place.  A blocking copy: the host keeps mutating its array,
    so an asynchronous copy from its pageable memory could read a later
    state."""
    table.copy_(torch.from_numpy(host_rows))
    return table
