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

kv8/kv4 pools (`EngineConfig.kv_quant`) store int8 / packed-uint8 codes,
`Ts = T` (kv8) or `T/2` (kv4) rows per page, with one float32 scale per
page × kv head in `k_scale_g` / `v_scale_g` ([L, B, K, NP] on the stripe,
[L, K, P] on the shared pool).  A token append requantizes only the page
it touches (dequantize, insert, zero the dead slots past it, quantize); a
chunk fill quantizes whole pages.  The requantizing appends write only
the active rows, on BOTH layouts: an inactive row's dead-slot zeroing
would go through its own stale (page, slot), which in a shared pool can
be another slot's live page.

The one-shot prefill writes a whole prompt's pages per layer with
`fill_layer` (every batch row at once, padding included: the bucketed
prompts of the splice scheduler fill their padded tail too, and a kv8/kv4
page's scale is taken over real and padding tokens alike, as in the
reference); `splice_slot` copies a one-sequence prefill cache into one
slot of the batch cache.

An RWKV6 (`ssm`) cache holds no pool and no page table: each layer's
recurrent state `rwkv_state` [L, B, H, dh, dh] (float32) and the time-mix
and channel-mix token shifts `rwkv_shift` / `rwkv_shift2` [L, B, D] (the
pool dtype), written per layer by `write_recurrent_state`.

The span writers (`append_span*`) append a speculative verify step's
kept positions: position s of the span is written for the rows in
`rows[s]` only (a row keeps a prefix of its span), in span order, through
the one-token writers — so a kv8/kv4 page replays sequential decode's
requantizing chain, and a rejected draft never reaches a page.
`span_page_chain` computes that chain's page states beside the pool, so
the verify forward reads the values sequential decode would read.

Not ported yet: window rings and tier staging (ROADMAP A10, A12).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

from repro_torch.configs.base import EngineConfig, ModelConfig
from repro_torch.core import quant


def ceil_div(a: int, b: int) -> int:
    return -(-a // b)


@dataclass
class DecodeCache:
    """Decode state: the global-span layers' pool (stripe or shared), or
    an RWKV6 model's recurrent state."""
    k_pages_g: Optional[torch.Tensor] = None    # [L, B, K, NP, T, dh] or
    v_pages_g: Optional[torch.Tensor] = None    # shared [L, K, P, T, dh]
    page_table_g: Optional[torch.Tensor] = None  # [B, NP] logical -> physical
    # per-page × kv-head dequant scales (kv8/kv4 pools only)
    k_scale_g: Optional[torch.Tensor] = None    # [L, B, K, NP] float32 or
    v_scale_g: Optional[torch.Tensor] = None    # shared [L, K, P]
    # recurrent state (ssm)
    rwkv_state: Optional[torch.Tensor] = None   # [L, B, H, dh, dh] float32
    rwkv_shift: Optional[torch.Tensor] = None   # [L, B, D] time-mix shift
    rwkv_shift2: Optional[torch.Tensor] = None  # [L, B, D] channel-mix shift
    lengths: Optional[torch.Tensor] = None      # [B] int32


def check_supported(eng: EngineConfig) -> None:
    """Raise for the pool layouts/formats the port does not serve yet."""
    if eng.hot_pages:
        raise NotImplementedError(
            "the tiered pool (hot_pages) is not ported yet (ROADMAP A12: "
            "tiered pool)")


def init_cache(cfg: ModelConfig, eng: EngineConfig, batch: int,
               max_context: int, *, dtype=torch.bfloat16,
               device="cuda") -> DecodeCache:
    """Zeroed pools (and kv8/kv4 scales), zero lengths.  Stripe: NP =
    ceil(max_context / T) pages per slot, identity tables.  Shared: one
    pool of P = total_pages or B·NP pages, tables of identity stripes mod
    P (slot b's logical page j on physical page (b·NP + j) mod P — the
    allocator-free default; the scheduler overwrites the tables from its
    allocator).  `dtype` is the pool's dtype when kv_quant is "none", and
    the shifts' dtype of an RWKV6 cache, which has no pool (zero states
    and shifts instead)."""
    check_supported(eng)
    T = eng.page_tokens
    K, dh, L = cfg.n_kv_heads, cfg.d_head, cfg.n_layers
    lengths = torch.zeros(batch, dtype=torch.int32, device=device)
    if cfg.family == "ssm":
        H, D = cfg.n_heads, cfg.d_model
        return DecodeCache(
            rwkv_state=torch.zeros((L, batch, H, dh, dh), dtype=torch.float32,
                                   device=device),
            rwkv_shift=torch.zeros((L, batch, D), dtype=dtype, device=device),
            rwkv_shift2=torch.zeros((L, batch, D), dtype=dtype,
                                    device=device),
            lengths=lengths)
    NP = eng.max_pages_per_seq or ceil_div(max_context, T)
    fmt = eng.kv_quant
    if fmt != "none":
        Ts, dtype = (quant.kv_page_tokens_stored(T, fmt),
                     quant.kv_storage_dtype(fmt))
    else:
        Ts = T
    logical = torch.arange(NP, dtype=torch.int32, device=device)
    if eng.shared_pool:
        P = eng.total_pages or batch * NP
        pool, scales = (L, K, P, Ts, dh), (L, K, P)
        rows = torch.arange(batch, dtype=torch.int32, device=device)
        table = (rows[:, None] * NP + logical[None]) % P
    else:
        pool, scales = (L, batch, K, NP, Ts, dh), (L, batch, K, NP)
        table = logical[None].expand(batch, NP).contiguous()

    def zeros(shape, dt):
        return torch.zeros(shape, dtype=dt, device=device)

    quantized = fmt != "none"
    return DecodeCache(
        k_pages_g=zeros(pool, dtype), v_pages_g=zeros(pool, dtype),
        page_table_g=table,
        k_scale_g=zeros(scales, torch.float32) if quantized else None,
        v_scale_g=zeros(scales, torch.float32) if quantized else None,
        lengths=lengths)


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


# ---------------------------------------------------------------------------
# Quantized (kv8 / kv4) token appends: requantize the touched page
# ---------------------------------------------------------------------------
#
# Tokens land in page order, so the slots past the new token's hold a
# recycled occupant's stale K/V or bucket padding: masked at read time,
# but they must not enter the page's new amax, so they are zeroed before
# the page requantizes (the reference's `_zero_dead_slots`).

def _requantize_with_token(qpage, s, slot, val, fmt: str):
    """qpage [n, K, Ts, dh] codes with scales s [n, K]; insert val [n, K,
    dh] at token `slot` [n] of each page, zero the later tokens and
    requantize -> (codes, scales)."""
    page = quant.dequantize_kv_page(qpage, s, fmt)            # [n, K, T, dh]
    n, T = page.shape[0], page.shape[2]
    sl = slot.long()
    page[torch.arange(n, device=page.device), :, sl] = val.to(page.dtype)
    live = torch.arange(T, device=page.device)[None, :] <= sl[:, None]
    page = torch.where(live[:, None, :, None], page, page.new_zeros(()))
    return quant.quantize_kv_page(page, fmt)


def append_token_quant(pool: torch.Tensor, scale: torch.Tensor, layer: int,
                       phys: torch.Tensor, slot: torch.Tensor,
                       val: torch.Tensor, fmt: str,
                       rows: Optional[torch.Tensor] = None):
    """Ragged requantizing append into a stripe pool [L, B, K, NP, Ts, dh]
    with scales [L, B, K, NP].  phys/slot: [B] page and in-page token of
    each row's new token; val: [B, K, dh].  `rows` (int64 indices) selects
    the rows that write — the active ones; None writes every row."""
    b_idx = torch.arange(pool.shape[1], device=pool.device)
    if rows is not None:
        b_idx, phys, slot, val = rows, phys[rows], slot[rows], val[rows]
    p = phys.long()
    pool_l, scale_l = pool[layer], scale[layer]
    q2, s2 = _requantize_with_token(pool_l[b_idx, :, p], scale_l[b_idx, :, p],
                                    slot, val, fmt)
    pool_l[b_idx, :, p] = q2
    scale_l[b_idx, :, p] = s2
    return pool, scale


def _paged_from_seq(kv_seq: torch.Tensor, T: int) -> torch.Tensor:
    """[B, S, K, dh] -> page-major [B, K, n_pages, T, dh] (zero-padded)."""
    B, S, K, dh = kv_seq.shape
    n_pages = ceil_div(S, T)
    pad = n_pages * T - S
    if pad:
        kv_seq = torch.cat([kv_seq, kv_seq.new_zeros(B, pad, K, dh)], dim=1)
    return kv_seq.reshape(B, n_pages, T, K, dh).permute(0, 3, 1, 2, 4)


def _chunk_pages(pool: torch.Tensor, kv_chunk: torch.Tensor, NP: int,
                 page0: int, valid_len: int, kv_quant: str):
    """The chunk as whole pages, quantized for a kv8/kv4 pool: (pages
    [K, n_w, Ts, dh] in the pool's dtype, scales [K, n_w] or None), n_w
    the pages holding at least one of the `valid_len` real tokens and
    lying inside the NP-page walk (the reference drops the rest)."""
    T = pool.shape[-2] * (2 if kv_quant == "kv4" else 1)
    x = _paged_from_seq(kv_chunk, T)[0]                # [K, n, T, dh]
    n_w = min(ceil_div(valid_len, T), x.shape[1], max(NP - page0, 0))
    if n_w <= 0 or kv_quant == "none":
        return x[:, :n_w].to(pool.dtype), None, n_w
    xq, s = quant.quantize_kv_page(x[:, :n_w], kv_quant)
    return xq, s, n_w


def fill_chunk_global_at(pool: torch.Tensor, kv_chunk: torch.Tensor,
                         layer: int, slot: int, page0: int,
                         valid_len: int, *,
                         scale: Optional[torch.Tensor] = None,
                         kv_quant: str = "none") -> torch.Tensor:
    """Write one slot's prompt chunk into its stripe, whole pages at once.

    pool: [L, B, K, NP, Ts, dh]; kv_chunk: [1, C, K, dh]; page0: the
    chunk's first page (chunk starts are page-aligned).  Only pages
    holding at least one of the `valid_len` real tokens are written, and
    a page past the stripe is skipped (the reference drops it).  A kv8/kv4
    pool quantizes whole pages (its scales [L, B, K, NP] written beside).
    """
    x, s, n_w = _chunk_pages(pool, kv_chunk, pool.shape[3], page0,
                             valid_len, kv_quant)
    if n_w > 0:
        pool[layer, slot, :, page0:page0 + n_w] = x
        if s is not None:
            scale[layer, slot, :, page0:page0 + n_w] = s
    return pool


# ---------------------------------------------------------------------------
# One-shot prefill fill and the splice of a prefilled slot
# ---------------------------------------------------------------------------

def fill_layer(pool: torch.Tensor, kv_seq: torch.Tensor, layer: int, *,
               ring: bool = False, table: Optional[torch.Tensor] = None,
               scale: Optional[torch.Tensor] = None,
               kv_quant: str = "none") -> torch.Tensor:
    """One-shot prefill fill of ONE layer for every batch row, in place.

    kv_seq: [B, S, K, dh], all S tokens written (bucket padding too; the
    reference reads a true length only for window rings).  Stripe pool
    [L, B, K, NP, Ts, dh]: row b's pages 0..ceil(S/T) of its stripe.
    Shared pool [L, K, P, Ts, dh] with `table` [B, NP]: row b's logical
    page j on physical page table[b, j].  A kv8/kv4 pool quantizes whole
    pages and writes their scales into `scale` beside."""
    if ring:
        raise NotImplementedError(
            "window-ring prefill fills are not ported yet (ROADMAP A10, "
            "window rings)")
    T = pool.shape[-2] * (2 if kv_quant == "kv4" else 1)
    x = _paged_from_seq(kv_seq, T)                  # [B, K, n, T, dh]
    s = None
    if kv_quant != "none":
        x, s = quant.quantize_kv_page(x, kv_quant)
    n = x.shape[2]
    if table is None:
        pool[layer, :, :, :n] = x
        if s is not None:
            scale[layer, :, :, :n] = s
        return pool
    n = min(n, table.shape[1])
    phys = table[:, :n].long()                      # [B, n]
    pool[layer][:, phys] = x[:, :, :n].transpose(0, 1).to(pool.dtype)
    if s is not None:
        scale[layer][:, phys] = s[:, :, :n].transpose(0, 1)
    return pool


# leaves whose batch axis leads; every other leaf is [L, B, ...]
_BATCH_AXIS0 = ("page_table_g", "lengths")


def splice_slot(cache: DecodeCache, one: DecodeCache, i: int) -> DecodeCache:
    """Copy sequence 0 of a B=1 cache into slot i of the batch cache, in
    place: the slot's stripe of every pool, its kv8/kv4 scales, its table
    row, its recurrent state and shifts, and its length.  Stripe layout
    only (a shared pool has no per-slot stripe to copy)."""
    if cache.k_pages_g is not None and cache.k_pages_g.ndim != 6:
        raise ValueError("splice_slot copies per-slot stripes; a shared "
                         "pool has none")
    for name in ("k_pages_g", "v_pages_g", "k_scale_g", "v_scale_g",
                 "page_table_g", "rwkv_state", "rwkv_shift", "rwkv_shift2",
                 "lengths"):
        cur, new = getattr(cache, name), getattr(one, name)
        if cur is None:
            continue
        if name in _BATCH_AXIS0:
            cur[i] = new[0]
        else:
            cur[:, i] = new[:, 0]
    return cache


def write_recurrent_state(cache: DecodeCache, layer: int, rows: slice,
                          state: torch.Tensor, shift: torch.Tensor,
                          shift2: torch.Tensor,
                          active: Optional[torch.Tensor] = None
                          ) -> DecodeCache:
    """Store one layer's recurrent state [n, H, dh, dh] and token shifts
    [n, D] of the batch rows `rows` (n of them), in place.  Rows with
    `active` False keep their current values (the reference's
    `_mask_state`: a decode step must not disturb a slot that is empty or
    mid-prefill)."""
    for leaf, new in ((cache.rwkv_state, state), (cache.rwkv_shift, shift),
                      (cache.rwkv_shift2, shift2)):
        cur = leaf[layer, rows]
        new = new.to(leaf.dtype)
        if active is not None:
            act = active.reshape((-1,) + (1,) * (new.ndim - 1))
            new = torch.where(act, new, cur)
        cur.copy_(new)
    return cache


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


def append_token_quant_shared(pool: torch.Tensor, scale: torch.Tensor,
                              layer: int, phys: torch.Tensor,
                              slot: torch.Tensor, val: torch.Tensor,
                              fmt: str,
                              rows: Optional[torch.Tensor] = None):
    """Ragged requantizing append into a shared pool [L, K, P, Ts, dh]
    with scales [L, K, P]: `append_token_quant` through the table's
    physical pages.  `rows` selects the writing (active) rows, each owning
    its page exclusively; None writes every row."""
    if rows is not None:
        phys, slot, val = phys[rows], slot[rows], val[rows]
    p = phys.long()
    pool_l, scale_l = pool[layer], scale[layer]        # [K, P, ...], [K, P]
    q2, s2 = _requantize_with_token(pool_l[:, p].transpose(0, 1),
                                    scale_l[:, p].t(), slot, val, fmt)
    pool_l[:, p] = q2.transpose(0, 1)
    scale_l[:, p] = s2.t()
    return pool, scale


def fill_chunk_global_at_shared(pool: torch.Tensor, kv_chunk: torch.Tensor,
                                layer: int, table_row: torch.Tensor,
                                page0: int, valid_len: int, *,
                                scale: Optional[torch.Tensor] = None,
                                kv_quant: str = "none") -> torch.Tensor:
    """Shared-pool `fill_chunk_global_at`: chunk page sp lands on the
    physical page `table_row[page0 + sp]`.

    pool: [L, K, P, Ts, dh]; kv_chunk: [1, C, K, dh]; table_row: [NP].
    Only pages holding at least one of the `valid_len` real tokens are
    written, and a logical page past the table is skipped (the reference
    drops it).  A kv8/kv4 pool quantizes whole pages (scales [L, K, P])."""
    x, s, n_w = _chunk_pages(pool, kv_chunk, table_row.shape[0], page0,
                             valid_len, kv_quant)
    if n_w > 0:
        phys = table_row[page0:page0 + n_w].long()
        pool[layer][:, phys] = x
        if s is not None:
            scale[layer][:, phys] = s
    return pool


# ---------------------------------------------------------------------------
# Speculative-decode span appends (multi-token, accept-gated)
# ---------------------------------------------------------------------------
#
# `KVNANDEngine.verify_step` scores an S-token span in one forward pass
# and only then learns how many drafts each row keeps.  phys/slot: [S, B]
# page and in-page token of each span position; vals: [B, S, K, dh] the
# span's K or V; rows: S int64 index tensors, rows[s] the rows that keep
# position s.  Rejected and inactive positions are never written: that is
# the rollback on every layout (the reference gates them to its drop
# sentinel).  Within one position every writing row owns its page (the
# scheduler backed it before the step), so no two writes of one scatter
# name one cell.

def span_page_chain(codes: torch.Tensor, scales: torch.Tensor,
                    slot0: torch.Tensor, vals: torch.Tensor, fmt: str,
                    page_tokens: int):
    """The kv8/kv4 pages a verify step's span would leave after each of
    its positions, had it been appended token by token: the requantizing
    appends' chain (`_requantize_with_token`), computed beside the pool
    without writing it.

    codes [B, K, Ts, dh] / scales [B, K]: each row's page holding its
    first span position, as the pool holds it now; slot0 [B]: that
    position's in-page token; vals [B, S, K, dh]: the span's K or V.
    The span covers n = (T + S - 2) // T + 1 pages from there; returns
    (codes [S, B, K, n, Ts, dh], scales [S, B, K, n]): after position j,
    page r of row b as sequential decode would read it (pages past the
    one holding position j are zero and not yet reached)."""
    T = page_tokens
    B, S = vals.shape[:2]
    n = (T + S - 2) // T + 1
    pages = [(codes, scales)] + [(torch.zeros_like(codes),
                                  torch.zeros_like(scales))
                                 for _ in range(n - 1)]
    out_c, out_s = [], []
    for j in range(S):
        slot = (slot0.long() + j) % T
        rel = (slot0.long() + j) // T
        for r in range(n):
            c2, s2 = _requantize_with_token(pages[r][0], pages[r][1], slot,
                                            vals[:, j], fmt)
            hit = rel == r
            pages[r] = (torch.where(hit[:, None, None, None], c2,
                                    pages[r][0]),
                        torch.where(hit[:, None], s2, pages[r][1]))
        out_c.append(torch.stack([c for c, _ in pages], dim=2))
        out_s.append(torch.stack([sc for _, sc in pages], dim=2))
    return torch.stack(out_c), torch.stack(out_s)


def append_span(pool: torch.Tensor, layer: int, phys: torch.Tensor,
                slot: torch.Tensor, vals: torch.Tensor, rows
                ) -> torch.Tensor:
    """Span append into a stripe pool [L, B, K, NP, T, dh], position by
    position as S sequential decode appends would land."""
    pool_l = pool[layer]
    for s, r in enumerate(rows):
        pool_l[r, :, phys[s, r].long(), slot[s, r].long()] = \
            vals[r, s].to(pool.dtype)
    return pool


def append_span_shared(pool: torch.Tensor, layer: int, phys: torch.Tensor,
                       slot: torch.Tensor, vals: torch.Tensor, rows
                       ) -> torch.Tensor:
    """`append_span` for a shared pool [L, K, P, T, dh] (physical pages
    from the table)."""
    for s, r in enumerate(rows):
        append_global_shared(pool, layer, phys[s], slot[s], vals[:, s], r)
    return pool


def append_span_quant(pool: torch.Tensor, scale: torch.Tensor, layer: int,
                      phys: torch.Tensor, slot: torch.Tensor,
                      vals: torch.Tensor, fmt: str, rows):
    """Requantizing span append into a stripe pool: one
    `append_token_quant` per kept position, the page chain of sequential
    decode."""
    for s, r in enumerate(rows):
        append_token_quant(pool, scale, layer, phys[s], slot[s], vals[:, s],
                           fmt, r)
    return pool, scale


def append_span_quant_shared(pool: torch.Tensor, scale: torch.Tensor,
                             layer: int, phys: torch.Tensor,
                             slot: torch.Tensor, vals: torch.Tensor,
                             fmt: str, rows):
    """Shared-pool requantizing span append (see `append_span_quant`)."""
    for s, r in enumerate(rows):
        append_token_quant_shared(pool, scale, layer, phys[s], slot[s],
                                  vals[:, s], fmt, r)
    return pool, scale


def copy_page_shared(pool: torch.Tensor, src: int, dst: int) -> torch.Tensor:
    """Copy physical page src -> dst across ALL layers of a shared pool
    [L, K, P, ...], in place (copy-on-write: the new exclusive owner starts
    from the shared page's bytes; code pools and scale leaves alike).  It runs on the current stream, so it
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
