"""Page-level KV cache (port of `repro.core.paged_kv`): the per-slot
stripe layout and the shared pool.

Layouts are (layer, head)-major as in the reference:

    stripe (default)                     shared pool (shared_pool=True)
    k/v_pages_g: [Lg, B, K, NP, T, dh]   k/v_pages_g: [Lg, K, P, T, dh]
    page_table_g: [B, NP] identity       page_table_g: [B, NP] -> [0, P)
    k/v_pages_w: [Lw, B, K, NPw, T, dh]  k/v_pages_w: [Lw, K, Pw, T, dh]
    (no window table)                    page_table_w: [B, NPw] -> [0, Pw)
    page_pos_w: [B, NPw]                 page_pos_w: [B, NPw]
    lengths: [B]                         lengths: [B]

Lg global-span layers and Lw sliding-window layers (`layer_pattern`;
every layer is global unless the arch has a window), B slots, K kv heads,
NP = ceil(max_context / T) logical pages per slot, T page_tokens, P =
total_pages or B·NP physical pages.  In the stripe layout each slot owns
a private stripe; in the shared pool every slot reaches its pages
through its table row, whose entries the host allocator
(`core/page_alloc.py`, driven by the scheduler) hands out.

A window layer keeps only its newest tokens, in a RING of NPw =
ceil(window / T) + 1 pages a slot: the token at position t lands in ring
slot (t // T) % NPw, recycling the slot of the page that fell out of the
window.  `page_pos_w` holds each ring slot's base position (-1e9 while
empty), so the attention masks by data alone; the shared pool reaches a
ring slot's physical page through `page_table_w`.

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
pool dtype), written per layer by `write_recurrent_state`.  A hybrid
(hymba) cache holds its pool and rings and, beside them, each layer's SSM
state `ssm_state` [L, B, D, N] (float32) and conv tail `conv_tail`
[L, B, CONV_K-1, D] (the pool dtype, so a bf16 pool rounds the tail to
bf16 between steps, as the reference's does), through the same writer.

An encoder-decoder (whisper) cache holds, beside its pool, each decoder
layer's cross-attention K/V over the encoder's Senc positions,
`cross_k` / `cross_v` [L, B, Senc, K, dh] in the pool dtype (never
quantized, even beside kv8/kv4 pages), written once by the prefill and
read-only after it.  They are views of a page-major store [L, B, K, NP,
T, dh] (Senc = NP·T, so Senc must be a page multiple): `cross_pages`
hands the decode step a layer's pages as the contiguous [B, K, NP, T,
dh] stripe the paged kernel walks, with no copy a step.

The span writers (`append_span*`) append a speculative verify step's
kept positions: position s of the span is written for the rows in
`rows[s]` only (a row keeps a prefix of its span), in span order, through
the one-token writers — so a kv8/kv4 page replays sequential decode's
requantizing chain, and a rejected draft never reaches a page.
`span_page_chain` computes that chain's page states beside the pool, so
the verify forward reads the values sequential decode would read.

The ring writers: the one-token appends take the ring slot as their
page (`ring_slots`), `advance_ring_bases` records a fresh page's base,
`fill_layer(ring=True)` and `fill_chunk_window_at*` keep each ring slot's
newest real page (only pages holding real tokens are written, so bucket
padding never evicts a live page), and `write_ring_bases` stores a
slot's row of bases after a fill (`window_page_positions`).

A tiered pool (``EngineConfig.hot_pages``) sizes the shared global pool at
its hot tier; `read_hot_slot` and `stage_hot_slot` move one page's bytes
out of and into a hot slot for the scheduler's demotions and promotions.
Replica migration reads a page's bytes wherever they live
(`read_page_bytes`) and writes them back through `stage_hot_slot`, a
slot's length, ring bases and recurrent state through
`import_slot_rows`.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.bridge import to_numpy
from repro_torch.configs.base import EngineConfig, ModelConfig
from repro_torch.core import quant
from repro_torch.models.ssm import CONV_K


def ceil_div(a: int, b: int) -> int:
    return -(-a // b)


RING_EMPTY = -(10 ** 9)      # page_pos_w of a ring slot never written


def layer_pattern(cfg: ModelConfig) -> Tuple[int, Tuple[bool, ...]]:
    """(period, pattern), pattern[i] True when layer i is global: the
    smallest repeating local/global period."""
    flags = tuple(cfg.is_global_layer(i) for i in range(cfg.n_layers))
    for p in range(1, cfg.n_layers + 1):
        if cfg.n_layers % p:
            continue
        if all(flags[i] == flags[i % p] for i in range(cfg.n_layers)):
            return p, flags[:p]
    return cfg.n_layers, flags


def _n_layers_split(cfg: ModelConfig) -> Tuple[int, int]:
    """(Lg, Lw): the global and the sliding-window layer counts."""
    n_global = sum(cfg.is_global_layer(i) for i in range(cfg.n_layers))
    return n_global, cfg.n_layers - n_global


def layer_pools(cfg: ModelConfig):
    """Per layer, (ring, index): whether it lives in the window pool and
    its index there (the reference's per-period `_g_off` / `_w_off`
    unrolled over the layers)."""
    out, g, w = [], 0, 0
    for i in range(cfg.n_layers):
        if cfg.is_global_layer(i):
            out.append((False, g))
            g += 1
        else:
            out.append((True, w))
            w += 1
    return out


def ring_pages(cfg: ModelConfig, page_tokens: int) -> int:
    """NPw: ring pages a slot, ceil(window / T) + 1."""
    return ceil_div(cfg.window, page_tokens) + 1


@dataclass
class DecodeCache:
    """Decode state: the global-span layers' pool (stripe or shared), the
    sliding-window layers' rings, and an RWKV6 or hybrid model's
    recurrent state."""
    k_pages_g: Optional[torch.Tensor] = None    # [Lg, B, K, NP, T, dh] or
    v_pages_g: Optional[torch.Tensor] = None    # shared [Lg, K, P, T, dh]
    page_table_g: Optional[torch.Tensor] = None  # [B, NP] logical -> physical
    # sliding-window layers: ring-recycled pages
    k_pages_w: Optional[torch.Tensor] = None    # [Lw, B, K, NPw, T, dh] or
    v_pages_w: Optional[torch.Tensor] = None    # shared [Lw, K, Pw, T, dh]
    page_table_w: Optional[torch.Tensor] = None  # shared: [B, NPw] -> phys
    page_pos_w: Optional[torch.Tensor] = None   # [B, NPw] base position
    # per-page × kv-head dequant scales (kv8/kv4 pools only)
    k_scale_g: Optional[torch.Tensor] = None    # [Lg, B, K, NP] float32 or
    v_scale_g: Optional[torch.Tensor] = None    # shared [Lg, K, P]
    k_scale_w: Optional[torch.Tensor] = None    # [Lw, B, K, NPw] or
    v_scale_w: Optional[torch.Tensor] = None    # shared [Lw, K, Pw]
    # recurrent state (ssm)
    rwkv_state: Optional[torch.Tensor] = None   # [L, B, H, dh, dh] float32
    rwkv_shift: Optional[torch.Tensor] = None   # [L, B, D] time-mix shift
    rwkv_shift2: Optional[torch.Tensor] = None  # [L, B, D] channel-mix shift
    # selective-SSM state (hybrid)
    ssm_state: Optional[torch.Tensor] = None    # [L, B, D, N] float32
    conv_tail: Optional[torch.Tensor] = None    # [L, B, CONV_K-1, D]
    # encoder-decoder cross-attention K/V (read-only after prefill)
    cross_k: Optional[torch.Tensor] = None      # [L, B, Senc, K, dh]
    cross_v: Optional[torch.Tensor] = None
    lengths: Optional[torch.Tensor] = None      # [B] int32


def cross_store(cfg: ModelConfig, batch: int, enc_len: int,
                page_tokens: int, dtype, device):
    """Zeroed cross_k and cross_v [L, B, Senc, K, dh], each a view of a
    page-major store [L, B, K, Senc / T, T, dh].  Raises ValueError when
    Senc is not a multiple of T (the decode step walks whole pages; the
    reference fails there, reshaping Senc into pages)."""
    T = page_tokens
    if enc_len % T:
        raise ValueError(
            f"{cfg.name}: the encoder's {enc_len} positions are not a "
            f"multiple of page_tokens={T}; decode walks the cross K/V as "
            "whole pages, so pad the frames to a page multiple")
    L, K, dh = cfg.n_layers, cfg.n_kv_heads, cfg.d_head
    NP = enc_len // T

    def one():
        store = torch.zeros((L, batch, K, NP, T, dh), dtype=dtype,
                            device=device)
        return store.permute(0, 1, 3, 4, 2, 5).view(L, batch, enc_len, K,
                                                     dh)
    return one(), one()


def write_cross_kv(cache: DecodeCache, layer: int, k: torch.Tensor,
                   v: torch.Tensor) -> None:
    """Store one decoder layer's cross K/V [B, Senc, K, dh] (the prefill's
    projection of the encoder output) in the cache's dtype, into its
    pages."""
    cache.cross_k[layer].copy_(k)
    cache.cross_v[layer].copy_(v)


def cross_pages(leaf: torch.Tensor, page_tokens: int) -> torch.Tensor:
    """One layer's cross K or V, leaf [B, Senc, K, dh] (a `cross_store`
    view), as pages [B, K, Senc / T, T, dh]: the store itself,
    contiguous, which the paged kernel reads in place."""
    B, Senc, K, dh = leaf.shape
    return leaf.view(B, Senc // page_tokens, page_tokens, K, dh).permute(
        0, 3, 1, 2, 4)


def init_cache(cfg: ModelConfig, eng: EngineConfig, batch: int,
               max_context: int, *, dtype=torch.bfloat16,
               device="cuda", enc_len: int = 0, page_shards_g: int = 1,
               page_shards_w: int = 1, place=None) -> DecodeCache:
    """Zeroed pools (and kv8/kv4 scales), zero lengths.  Global pool:
    NP = ceil(max_context / T) pages per slot; window rings: NPw pages a
    slot, every base RING_EMPTY.  Stripe tables are identities; shared:
    one pool of P = total_pages or B·NP pages (a tiered pool: P =
    hot_pages, its device-resident hot tier; window: total_pages_w or
    B·NPw), tables of identity stripes mod P (slot b's logical page j on
    physical page (b·NP + j) mod P — the allocator-free default; the
    scheduler overwrites the tables from its allocator).  `dtype` is the
    pool's dtype when kv_quant is "none", the shifts' dtype of an RWKV6
    cache, which has no pool (zero states and shifts instead), and the
    conv tail's and the cross K/V's dtype (whatever kv_quant is).  An
    encoder-decoder arch given `enc_len` gets zeroed cross K/V over
    enc_len encoder positions (`cross_store`).

    On a device mesh (the reference's `cache_spec`): `page_shards_g` /
    `page_shards_w` round each pool's page count (NP, NPw and a shared
    pool's P) up to a multiple of the shards holding its page axis, and
    `place(name, shape, dtype)` builds each pool and scale leaf (the
    engine's makes shard-local zeros, `sharding.zeros`); the tables,
    ring bases and lengths stay whole on `device`."""
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
    leaves = {}
    if cfg.family == "hybrid":
        D = cfg.d_model
        leaves["ssm_state"] = torch.zeros((L, batch, D, cfg.ssm_state),
                                          dtype=torch.float32, device=device)
        leaves["conv_tail"] = torch.zeros((L, batch, CONV_K - 1, D),
                                          dtype=dtype, device=device)
    if cfg.is_encoder_decoder and enc_len:
        leaves["cross_k"], leaves["cross_v"] = cross_store(
            cfg, batch, enc_len, T, dtype, device)
    fmt = eng.kv_quant
    quantized = fmt != "none"
    if quantized:
        Ts, dtype = (quant.kv_page_tokens_stored(T, fmt),
                     quant.kv_storage_dtype(fmt))
    else:
        Ts = T

    def zeros(name, shape, dt):
        if place is not None:
            return place(name, shape, dt)
        return torch.zeros(shape, dtype=dt, device=device)

    def round_np(n: int, shards: int) -> int:
        return max(ceil_div(n, shards), 1) * shards

    def pool_leaves(sfx: str, Lp: int, NP: int, P: int):
        """(k, v, table, k_scale, v_scale) of one layer group."""
        logical = torch.arange(NP, dtype=torch.int32, device=device)
        if eng.shared_pool:
            pool, scales = (Lp, K, P, Ts, dh), (Lp, K, P)
            rows = torch.arange(batch, dtype=torch.int32, device=device)
            table = (rows[:, None] * NP + logical[None]) % P
        else:
            pool, scales = (Lp, batch, K, NP, Ts, dh), (Lp, batch, K, NP)
            table = logical[None].expand(batch, NP).contiguous()
        sc = ((lambda n: zeros(f"{n}_scale_{sfx}", scales, torch.float32))
              if quantized else (lambda n: None))
        return (zeros(f"k_pages_{sfx}", pool, dtype),
                zeros(f"v_pages_{sfx}", pool, dtype), table, sc("k"),
                sc("v"))

    Lg, Lw = _n_layers_split(cfg)
    if Lg:
        NP = round_np(eng.max_pages_per_seq or ceil_div(max_context, T),
                      page_shards_g)
        # a tiered pool keeps only its hot tier on the device; the flash
        # page count lives in the scheduler's allocator
        (leaves["k_pages_g"], leaves["v_pages_g"], leaves["page_table_g"],
         leaves["k_scale_g"], leaves["v_scale_g"]) = pool_leaves(
            "g", Lg, NP, round_np(eng.hot_pages or eng.total_pages
                                  or batch * NP, page_shards_g))
    if Lw:
        NPw = round_np(ring_pages(cfg, T), page_shards_w)
        (leaves["k_pages_w"], leaves["v_pages_w"], table_w,
         leaves["k_scale_w"], leaves["v_scale_w"]) = pool_leaves(
            "w", Lw, NPw, round_np(eng.total_pages_w or batch * NPw,
                                   page_shards_w))
        if eng.shared_pool:        # a stripe ring is addressed directly
            leaves["page_table_w"] = table_w
        leaves["page_pos_w"] = torch.full((batch, NPw), RING_EMPTY,
                                          dtype=torch.int32, device=device)
    return DecodeCache(lengths=lengths, **leaves)


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
                       rows: Optional[torch.Tensor] = None,
                       active: Optional[torch.Tensor] = None):
    """Ragged requantizing append into a stripe pool [L, B, K, NP, Ts, dh]
    with scales [L, B, K, NP].  phys/slot: [B] page and in-page token of
    each row's new token; val: [B, K, dh].  `rows` (int64 indices) selects
    the rows that write — the active ones; None writes every row.
    `active` [B] bool instead masks on the device: a masked row writes
    its page's current codes and scale back (safe on the stripe, where
    no other row names its cells; a mesh shard's owned-row mask)."""
    b_idx = torch.arange(pool.shape[1], device=pool.device)
    if rows is not None:
        b_idx, phys, slot, val = rows, phys[rows], slot[rows], val[rows]
    p = phys.long()
    pool_l, scale_l = pool[layer], scale[layer]
    cur_q, cur_s = pool_l[b_idx, :, p], scale_l[b_idx, :, p]
    q2, s2 = _requantize_with_token(cur_q, cur_s, slot, val, fmt)
    if active is not None:
        q2 = torch.where(active[:, None, None, None], q2, cur_q)
        s2 = torch.where(active[:, None], s2, cur_s)
    pool_l[b_idx, :, p] = q2
    scale_l[b_idx, :, p] = s2
    return pool, scale


def pages_from_seq(kv_seq: torch.Tensor, T: int) -> torch.Tensor:
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
    x = pages_from_seq(kv_chunk, T)[0]                # [K, n, T, dh]
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
# Window rings: ring slots, base positions and the ring fills
# ---------------------------------------------------------------------------
#
# A window layer's token at position t lives in ring slot (t // T) % NPw
# (the stripe's page index; a shared pool's through `page_table_w`).  The
# one-token appends above take that slot as their page: on a kv8/kv4 pool
# the requantizing append of a recycled page's first token zeroes every
# later token before it quantizes, so the previous occupant's tail and
# scale are gone with it.

def ring_slot(positions: torch.Tensor, page_tokens: int,
              ring: int) -> torch.Tensor:
    """Ring slot of each token position: (t // T) % NPw."""
    return (positions // page_tokens) % ring


def advance_ring_bases(page_pos: torch.Tensor, positions: torch.Tensor,
                       page_tokens: int,
                       write: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Record the base of every ring page a token append opens, in
    place: row b's ring slot of positions[b] takes base positions[b]
    when that token is the page's first (positions[b] % T == 0) and
    `write[b]` (None: every row) — the reference's fresh-page rule.
    page_pos: [B, NPw]; positions: [B]."""
    B, NPw = page_pos.shape
    b_idx = torch.arange(B, device=page_pos.device)
    pos = positions.to(page_pos.dtype)
    r = ring_slot(pos, page_tokens, NPw).long()
    fresh = pos % page_tokens == 0
    if write is not None:
        fresh = fresh & write
    page_pos[b_idx, r] = torch.where(fresh, pos, page_pos[b_idx, r])
    return page_pos


def window_page_positions(S: int, NP: int, T: int) -> np.ndarray:
    """Ring base positions after the first S tokens were written
    (RING_EMPTY = never written): slot sp % NP holds source page sp for
    the newest NP pages."""
    vals = np.full((NP,), RING_EMPTY, np.int64)
    n_src = ceil_div(S, T)
    for sp in range(max(0, n_src - NP), n_src):
        vals[sp % NP] = sp * T
    return vals.astype(np.int32)


def window_page_positions_dyn(true_len: torch.Tensor, NP: int,
                              T: int) -> torch.Tensor:
    """`window_page_positions` for a length held in a tensor: ring slot j
    holds source page m - ((m - j) mod NP), m = n_src - 1 (negative:
    never written)."""
    true_len = torch.as_tensor(true_len, dtype=torch.int32)
    n_src = (true_len + T - 1) // T
    m = n_src - 1
    j = torch.arange(NP, dtype=torch.int32, device=true_len.device)
    sp = m - torch.remainder(m - j, NP)
    return torch.where((sp >= 0) & (n_src > 0), sp * T,
                       torch.full_like(sp, RING_EMPTY)).to(torch.int32)


def write_ring_bases(page_pos: torch.Tensor, rows, length: int,
                     page_tokens: int) -> torch.Tensor:
    """Set the ring bases of batch rows `rows` (a slice or an index) to
    what a fill of their first `length` tokens leaves, in place."""
    vals = window_page_positions(length, page_pos.shape[1], page_tokens)
    page_pos[rows] = torch.as_tensor(vals, device=page_pos.device)
    return page_pos


def _ring_pages(kv_seq: torch.Tensor, T: int, NP: int, valid_len: int,
                kv_quant: str):
    """The newest <= NP source pages of kv_seq [B, S, K, dh] that hold
    real tokens (the first `valid_len`): (first source page lo, pages
    [B, K, n, Ts, dh], scales [B, K, n] or None).  Older real pages
    would only be overwritten in the ring, and pages of padding alone
    are never written, so no padding page evicts a live one; the last
    page keeps its padding tokens, as the reference's pages do."""
    n_w = min(ceil_div(valid_len, T), ceil_div(kv_seq.shape[1], T))
    lo = max(0, n_w - NP)
    x = pages_from_seq(kv_seq[:, lo * T:n_w * T], T)
    if kv_quant == "none":
        return lo, x, None
    return (lo,) + quant.quantize_kv_page(x, kv_quant)


def fill_chunk_window_at(pool: torch.Tensor, kv_chunk: torch.Tensor,
                         layer: int, slot: int, page0: int,
                         valid_len: int, *,
                         scale: Optional[torch.Tensor] = None,
                         kv_quant: str = "none") -> torch.Tensor:
    """Ring variant of `fill_chunk_global_at` for a stripe window pool
    [Lw, B, K, NPw, Ts, dh]: chunk page page0 + sp lands in ring slot
    (page0 + sp) % NPw.  Only pages holding real tokens are written, and
    of those the newest NPw (the reference writes them in ascending
    order, so each ring slot keeps its newest real occupant).  Base
    positions are written by the engine (`write_ring_bases`)."""
    NP = pool.shape[3]
    T = pool.shape[4] * (2 if kv_quant == "kv4" else 1)
    lo, x, s = _ring_pages(kv_chunk, T, NP, valid_len, kv_quant)
    if x.shape[2]:
        r = (page0 + lo + torch.arange(x.shape[2], device=pool.device)) % NP
        pool[layer, slot][:, r] = x[0].to(pool.dtype)
        if s is not None:
            scale[layer, slot][:, r] = s[0]
    return pool


def fill_chunk_window_at_shared(pool: torch.Tensor, kv_chunk: torch.Tensor,
                                layer: int, table_row: torch.Tensor,
                                page0: int, valid_len: int, *,
                                scale: Optional[torch.Tensor] = None,
                                kv_quant: str = "none") -> torch.Tensor:
    """Shared-pool ring chunk fill: ring slot (page0 + sp) % NPw resolves
    through `table_row` [NPw] (the slot's row of `page_table_w`)."""
    NP = table_row.shape[0]
    T = pool.shape[3] * (2 if kv_quant == "kv4" else 1)
    lo, x, s = _ring_pages(kv_chunk, T, NP, valid_len, kv_quant)
    if x.shape[2]:
        r = (page0 + lo + torch.arange(x.shape[2], device=pool.device)) % NP
        phys = table_row[r].long()
        pool[layer][:, phys] = x[0].to(pool.dtype)
        if s is not None:
            scale[layer][:, phys] = s[0]
    return pool


def fill_pages_at(pool: torch.Tensor, pages: torch.Tensor, layer: int,
                  dst, *, scale: Optional[torch.Tensor] = None,
                  page_scales: Optional[torch.Tensor] = None
                  ) -> torch.Tensor:
    """Write whole pages into every row's stripe at page slots `dst` (a
    list of n page indices), in place: pool [L, B, K, NP, Ts, dh], pages
    [B, K, n, Ts, dh] (already quantized for a kv8/kv4 pool, its scales
    `page_scales` [B, K, n] into `scale` [L, B, K, NP]).  A mesh shard's
    window-ring fill (`seqpar.sharded_window_fill`) writes its own ring
    slots through it."""
    idx = torch.as_tensor(dst, dtype=torch.long, device=pool.device)
    pool[layer][:, :, idx] = pages.to(pool.dtype)
    if page_scales is not None:
        scale[layer][:, :, idx] = page_scales
    return pool


# ---------------------------------------------------------------------------
# One-shot prefill fill and the splice of a prefilled slot
# ---------------------------------------------------------------------------

def fill_layer(pool: torch.Tensor, kv_seq: torch.Tensor, layer: int, *,
               ring: bool = False, true_len: Optional[int] = None,
               table: Optional[torch.Tensor] = None,
               scale: Optional[torch.Tensor] = None,
               kv_quant: str = "none") -> torch.Tensor:
    """One-shot prefill fill of ONE layer for every batch row, in place.

    kv_seq: [B, S, K, dh].  Global pool (ring=False): all S tokens are
    written (bucket padding too, as in the reference: masked by
    `lengths`, overwritten by decode appends) — stripe [L, B, K, NP, Ts,
    dh]: row b's pages 0..ceil(S/T) of its stripe; shared [L, K, P, Ts,
    dh] with `table` [B, NP]: row b's logical page j on physical page
    table[b, j].  Window ring (ring=True): source page sp lands in ring
    slot sp % NPw, of the pages holding real tokens (the first
    `true_len`, or all S) only the newest NPw, so bucket padding never
    evicts a live page (the reference's `_fill_ring_dyn`); a shared ring
    resolves its slots through `table` [B, NPw].  A kv8/kv4 pool
    quantizes whole pages and writes their scales into `scale` beside."""
    T = pool.shape[-2] * (2 if kv_quant == "kv4" else 1)
    if ring:
        NP = table.shape[1] if table is not None else pool.shape[3]
        S = kv_seq.shape[1]
        lo, x, s = _ring_pages(kv_seq, T, NP, S if true_len is None
                               else true_len, kv_quant)
        n = x.shape[2]
        r = (lo + torch.arange(n, device=pool.device)) % NP
        if table is None:
            pool[layer][:, :, r] = x.to(pool.dtype)
            if s is not None:
                scale[layer][:, :, r] = s
            return pool
        phys = table[:, r].long()                   # [B, n]
        pool[layer][:, phys] = x.transpose(0, 1).to(pool.dtype)
        if s is not None:
            scale[layer][:, phys] = s.transpose(0, 1)
        return pool
    x = pages_from_seq(kv_seq, T)                  # [B, K, n, T, dh]
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
_BATCH_AXIS0 = ("page_table_g", "page_table_w", "page_pos_w", "lengths")


def splice_slot(cache: DecodeCache, one: DecodeCache, i: int) -> DecodeCache:
    """Copy sequence 0 of a B=1 cache into slot i of the batch cache, in
    place: the slot's stripe of every pool and ring, its kv8/kv4 scales,
    its table row and ring bases, its recurrent state and shifts (an
    SSM's state and conv tail), and its length.  Stripe layout only (a shared pool has no per-slot stripe
    to copy)."""
    pool = cache.k_pages_g if cache.k_pages_g is not None else \
        cache.k_pages_w
    if pool is not None and pool.ndim != 6:
        raise ValueError("splice_slot copies per-slot stripes; a shared "
                         "pool has none")
    for name in ("k_pages_g", "v_pages_g", "k_scale_g", "v_scale_g",
                 "page_table_g", "k_pages_w", "v_pages_w", "k_scale_w",
                 "v_scale_w", "page_pos_w", "rwkv_state", "rwkv_shift",
                 "rwkv_shift2", "ssm_state", "conv_tail", "lengths"):
        cur, new = getattr(cache, name), getattr(one, name)
        if cur is None:
            continue
        if name in _BATCH_AXIS0:
            cur[i] = new[0]
        else:
            cur[:, i] = new[:, 0]
    return cache


def write_recurrent_state(cache: DecodeCache, layer: int, rows: slice,
                          news: Dict[str, torch.Tensor],
                          active: Optional[torch.Tensor] = None
                          ) -> DecodeCache:
    """Store one layer's recurrent leaves of the batch rows `rows` (n of
    them), in place: `news` maps a leaf name to its [n, ...] rows — an
    RWKV6 state [n, H, dh, dh] and token shifts [n, D], or an SSM state
    [n, D, N] and conv tail [n, CONV_K-1, D] — each cast to the leaf's
    dtype.  Rows with `active` False keep their current values (the
    reference's `_mask_state`: a decode step must not disturb a slot that
    is empty or mid-prefill)."""
    for name, new in news.items():
        leaf = getattr(cache, name)
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


def host_to_device(a: np.ndarray, device) -> torch.Tensor:
    """Upload a host array without blocking the host: on a card, from a
    pinned snapshot of `a` with a non-blocking copy (a copy from pageable
    memory would wait for the stream to drain).  The snapshot comes from
    the caching host allocator, which keeps it until the copy has run,
    so the caller may mutate `a` at once.  On the CPU a plain copy."""
    device = torch.device(device)
    t = torch.from_numpy(np.array(a))
    if device.type != "cuda":
        return t.to(device)
    return t.pin_memory().to(device, non_blocking=True)


def write_page_table(table: torch.Tensor, host_rows) -> torch.Tensor:
    """Mirror the host page tables (numpy [B, NP] int32) into the device
    table in place, from a snapshot (`host_to_device`): the host goes on
    mutating its array while the copy may still be pending."""
    table.copy_(host_to_device(host_rows, table.device))
    return table


# ---------------------------------------------------------------------------
# Tiered pool: a hot slot's bytes in and out
# ---------------------------------------------------------------------------
#
# A tiered shared pool keeps only `hot_pages` pages on the device (the hot
# tier); page axis 2 of every global pool leaf ([L, K, P, ...]: K/V codes
# and kv8/kv4 scales) is indexed by hot slot.  The scheduler moves a page's
# bytes between a hot slot and its capacity store (pinned host tensors).
# Both directions are copies enqueued on the current stream, so they land
# in order with every step that reads or writes the slot.

POOL_LEAVES_G = ("k_pages_g", "v_pages_g", "k_scale_g", "v_scale_g")


def read_hot_slot(cache: DecodeCache, slot: int) -> dict:
    """One hot slot's bytes, {leaf name: [L, K, ...] host tensor} for every
    global pool leaf the cache has (the reference scheduler's
    `_read_hot`).  On a card the copy goes into pinned memory without
    blocking: it is ordered after every write already enqueued into the
    slot and before any later one, and its bytes are read only by a later
    `stage_hot_slot` on the same stream."""
    out = {}
    for name in POOL_LEAVES_G:
        leaf = getattr(cache, name)
        if leaf is None:
            continue
        src = leaf[:, :, slot]
        if leaf.is_cuda:
            dst = torch.empty(src.shape, dtype=src.dtype, pin_memory=True)
            out[name] = dst.copy_(src, non_blocking=True)
        else:
            out[name] = src.clone()
    return out


def stage_hot_slot(cache: DecodeCache, slot: int, vals) -> DecodeCache:
    """Write a page's bytes into hot slot `slot`: `vals` maps a pool leaf
    name to its [L, K, ...] bytes (host or device), written at page axis 2,
    in place (the reference's `stage_hot_slot`, a dynamic_update_slice per
    leaf).  Replica migration reuses it with `slot` a flat-pool physical
    page.  A pinned source is copied without blocking; the caching host
    allocator keeps it until the copy has run."""
    for name, val in vals.items():
        leaf = getattr(cache, name)
        leaf[:, :, slot].copy_(val, non_blocking=True)
    return cache


# ---------------------------------------------------------------------------
# Replica migration: a page's bytes out, a slot's rows in
# ---------------------------------------------------------------------------
#
# A KV envelope (serving/replica.py) carries a request's pages as host
# arrays, one [L, K, ...] block per pool leaf; its page bytes are written
# back through `stage_hot_slot` (a flat pool's physical page in the hot
# slot's place) and its per-slot rows through `import_slot_rows`.

def read_page_bytes(cache: DecodeCache, page: int, leaves, tier=None,
                    store=None) -> dict:
    """One physical page's bytes, {leaf name: [L, K, ...] host array}
    (bf16 as float32, as the envelope stores it), wherever the page lives
    (the reference's `_page_bytes`): the device pool at `page` (a flat
    pool, or a window ring's page), the hot slot it is resident in (a
    tiered pool: a mapped page is pinned hot), or the capacity `store`
    (a tiered pool's demoted page: {leaf: pinned host tensor}).  A device read is a same-stream copy, ordered after
    every write already enqueued; before a store entry is read, the
    stream is drained, since its bytes may still be in flight from a
    non-blocking demotion (`read_hot_slot`)."""
    if tier is not None and not tier.is_resident(page):
        for leaf in (cache.k_pages_g, cache.k_pages_w):
            if leaf is not None and leaf.is_cuda:
                torch.cuda.current_stream(leaf.device).synchronize()
                break
        return {n: to_numpy(v) for n, v in store[page].items()}
    slot = tier.slot_of(page) if tier is not None else page
    return {n: to_numpy(getattr(cache, n)[:, :, slot]) for n in leaves}


def import_slot_rows(cache: DecodeCache, i: int, rows) -> DecodeCache:
    """Write one slot's per-sequence rows into slot i, in place (the
    reference's `import_slot_rows`): the `lengths` entry, the
    `page_pos_w` ring-base row, and the recurrent-state stacks
    (`rwkv_state`, `rwkv_shift`, `rwkv_shift2`, `ssm_state`,
    `conv_tail`, [L, ...] rows of the [L, B, ...] leaves) named in `rows` ({leaf name: host array}).  The
    uploads are non-blocking copies from pinned snapshots."""
    for name, val in rows.items():
        leaf = getattr(cache, name)
        v = host_to_device(np.asarray(val), leaf.device)
        if name in _BATCH_AXIS0:
            leaf[i].copy_(v)
        else:
            leaf[:, i].copy_(v)
    return cache
