"""Sequence-parallel attention: the paper's G2 dataflow on a device mesh
(port of `repro.core.seqpar`).

KVNAND §IV-B: G2 dies each hold a slice of the KV cache, compute partial
K·q products, the NPU aggregates them for the softmax, and the dies apply
Attend to their local V slice.  That is flash-decoding with a
log-sum-exp combine:

  decode : KV pages sharded over `model` (± `data`/`pod` for batch-1 long
           context); each page shard computes a partial (o, m, l) over its
           local pages (`paged_attention_partial`: kernel B1 on the
           stripe, B2 through the table of a shared pool, on a card);
           `combine_partials` (pmax/psum) plays the NPU-aggregation role.
  train / prefill : ring attention — q/k/v sequence-sharded, KV blocks
           rotate via ppermute with online-softmax accumulation.

Only q vectors and [B, H] statistics cross between shards; KV pages
never move.  The mesh is the single-process one of
`distributed/sharding.py`: a pool is a `ShardedTensor` (one tensor per
mesh coordinate), a body runs once per coordinate (`map_shards`) and
each collective runs between bodies.  Every shard-local pool write goes
through a `core/paged_kv.py` writer called on the shard's local pool.
Replicated operands (q, page bases, lengths, the new token's K/V) stay
whole on the caller's device and each shard takes its slice; results
come back assembled on the caller's device.  A plain tensor passed where
a pool is expected is split by the pool's spec first (a copy), and the
sharded pool is returned.

Departures from the reference: the stripe appends take a per-row page
(the reference's `sharded_append_uniform` reads row 0's, lockstep
decode), which serves the ragged path too; the shared-pool append reads
the new tokens' pages to the host once a call to pick each shard's
writing rows (a shared pool's writer needs a row subset, see
`core/paged_kv.py`).
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core import paged_kv, quant
from repro_torch.distributed.sharding import (P, ShardedTensor, axes_spec,
                                              axis_index, axis_size,
                                              map_shards, pmax, ppermute,
                                              psum, shard)
from repro_torch.kernels.paged_attention import (paged_attention_partial,
                                                 paged_chunk_attention)
from repro_torch.kernels.paged_attention.merge import NEG_INF, merge_partials


def merge_two(o1, m1, l1, o2, m2, l2):
    """Merge two locally-normalized partials (log-sum-exp)."""
    return merge_partials(torch.stack([o1, o2]), torch.stack([m1, m2]),
                          torch.stack([l1, l2]), axis=0)


# ---------------------------------------------------------------------------
# Partial-attention merge across shards (the "NPU softmax aggregation")
# ---------------------------------------------------------------------------

def combine_partials(o: ShardedTensor, m: ShardedTensor, l: ShardedTensor,
                     axis_names: Sequence[str]) -> ShardedTensor:
    """Cross-shard merge over mesh axes: the collective twin of
    `merge_partials` (one max, one sum).  o: [..., dh] locally-normalized
    partials; m/l: [...] stats, one per coordinate."""
    o, _, _ = combine_partials_stats(o, m, l, axis_names)
    return o


def combine_partials_stats(o: ShardedTensor, m: ShardedTensor,
                           l: ShardedTensor, axis_names: Sequence[str]):
    """`combine_partials` that also returns the combined (m, l) stats, for
    callers that merge the cross-shard result with further partials (the
    chunked-prefill past partial with its in-chunk causal partial)."""
    ax = tuple(axis_names)
    M = pmax(m, ax)
    w = map_shards(lambda l_, m_, M_: l_ * torch.exp(m_ - M_), l, m, M)
    L = psum(w, ax)
    num = psum(map_shards(lambda o_, w_: o_ * w_[..., None], o, w,
                          out_specs=o.spec), ax)
    o = map_shards(lambda n_, L_: n_ / L_.clamp_min(1e-30)[..., None], num,
                   L, out_specs=o.spec)
    return o, M, L


# ---------------------------------------------------------------------------
# Ring attention (train / prefill sequence parallelism)
# ---------------------------------------------------------------------------

def _attn_block_partial(q, k, v, q_pos, k_pos0, *, causal: bool,
                        window: Optional[int], scale: float,
                        is_global=None):
    """One (q-chunk x kv-chunk) partial in float32 -> (o, m, l).

    q: [B, Sq, H, dh]; k/v: [B, Sk, K, dh]; q_pos: [Sq] absolute
    positions; k_pos0: absolute position of k[0].  `is_global` (a bool,
    or a 0-d bool tensor) lifts the window."""
    B, Sq, H, dh = q.shape
    K = k.shape[2]
    G = H // K
    qg = (q.float() * scale).reshape(B, Sq, K, G, dh)
    s = torch.einsum("bqkgd,bskd->bkgqs", qg, k.float())       # [B,K,G,Sq,Sk]
    k_pos = k_pos0 + torch.arange(k.shape[1], device=q.device)
    mask = torch.ones((Sq, k.shape[1]), dtype=torch.bool, device=q.device)
    if causal:
        mask &= k_pos[None, :] <= q_pos[:, None]
    if window is not None:
        in_w = k_pos[None, :] > q_pos[:, None] - window
        if is_global is not None:
            in_w = in_w | torch.as_tensor(is_global, device=q.device)
        mask &= in_w
    s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    m = s.amax(dim=-1)                                          # [B,K,G,Sq]
    p = torch.exp(s - m[..., None])
    l = p.sum(dim=-1)
    o = torch.einsum("bkgqs,bskd->bqkgd", p, v.float())
    o = o / l.clamp_min(1e-30).permute(0, 3, 1, 2)[..., None]
    return (o.reshape(B, Sq, H, dh),
            m.permute(0, 3, 1, 2).reshape(B, Sq, H),
            l.permute(0, 3, 1, 2).reshape(B, Sq, H))


def ring_attention_local(q: ShardedTensor, k: ShardedTensor,
                         v: ShardedTensor, *, axis_name: str, causal: bool,
                         window: Optional[int], is_global, scale: float
                         ) -> ShardedTensor:
    """The per-shard ring: q/k/v hold each coordinate's chunk [B, Sl,
    H/K, dh], coordinate i of `axis_name` owning positions [i·Sl,
    (i+1)·Sl).  Each round merges the partial of the local q chunk
    against the KV chunk in hand, then the KV chunks move one step along
    the ring (ppermute), so every KV chunk passes every q chunk."""
    n_dev = q.mesh.shape[axis_name]
    Sl = q.shards[0].shape[1]
    mspec = P(*q.spec[:3])

    def zeros(qq, fill):
        return torch.full(qq.shape[:3], fill, dtype=torch.float32,
                          device=qq.device)

    o = map_shards(lambda qq: torch.zeros(qq.shape, dtype=torch.float32,
                                          device=qq.device), q)
    m = map_shards(lambda qq: zeros(qq, NEG_INF), q, out_specs=mspec)
    l = map_shards(lambda qq: zeros(qq, 0.0), q, out_specs=mspec)
    kc, vc = k, v
    perm = [(i, (i + 1) % n_dev) for i in range(n_dev)]
    for r in range(n_dev):
        def step(qq, kk, vv, oo, mm, ll, r=r):
            idx = axis_index(axis_name)
            src = (idx - r) % n_dev                       # owner of kk
            q_pos = idx * Sl + torch.arange(Sl, device=qq.device)
            o2, m2, l2 = _attn_block_partial(
                qq, kk, vv, q_pos, src * Sl, causal=causal, window=window,
                scale=scale, is_global=is_global)
            return merge_two(oo, mm, ll, o2, m2, l2)

        o, m, l = map_shards(step, q, kc, vc, o, m, l,
                             out_specs=[q.spec, mspec, mspec])
        if r + 1 < n_dev:
            kc = ppermute(kc, axis_name, perm)
            vc = ppermute(vc, axis_name, perm)
    return o.map(lambda t: t.to(q.dtype))


def ring_attention(q, k, v, mesh, *, causal: bool = True,
                   window: Optional[int] = None, is_global=None,
                   batch_axes=("data",), seq_axis: str = "model"):
    """q/k/v [B, S, H/K, dh] on one device -> [B, S, H, dh] there: the
    batch split over `batch_axes`, the sequence over `seq_axis`, the ring
    run per shard (differentiable: autograd follows the splits, the
    moves and the merges)."""
    scale = q.shape[-1] ** -0.5
    spec = P(axes_spec(batch_axes), seq_axis, None, None)
    qs, ks, vs = (shard(x, mesh, spec, copy=False) for x in (q, k, v))
    o = ring_attention_local(qs, ks, vs, axis_name=seq_axis, causal=causal,
                             window=window, is_global=is_global, scale=scale)
    return o.assemble(q.device)


# ---------------------------------------------------------------------------
# Sequence-parallel paged decode attention (the G2 dataflow proper)
# ---------------------------------------------------------------------------

def _shard_page_offset(page_axes: Sequence[str], np_local: int) -> int:
    """Linearized first local index of this shard along `page_axes`
    (inside a body)."""
    idx = 0
    for a in page_axes:
        idx = idx * axis_size(a) + axis_index(a)
    return idx * np_local


def _n_shards(mesh, axes: Sequence[str]) -> int:
    n = 1
    for a in axes:
        n *= mesh.shape[a]
    return n


def _as_sharded(x, mesh, spec):
    """A pool operand as shards: a ShardedTensor as it is, None as None,
    a plain tensor split by `spec` (a copy)."""
    if x is None or isinstance(x, ShardedTensor):
        return x
    return shard(x, mesh, spec)


def _rows(x, b0: int, n: int, device):
    """Rows [b0, b0 + n) of a replicated operand, on `device`."""
    return None if x is None else x[b0:b0 + n].to(device)


def local_append_uniform(pool_local, phys, slot, val, page_axes):
    """Append one token's K or V inside the owning shard (inside a body):
    pool_local [B, K, NP_local, T, dh] one layer's local pages; phys /
    slot [B] each row's global page and in-page slot, val [B, K, dh].
    A row whose page lies in another shard rewrites its own current value
    (the reference's owned-mask select, through the stripe writer's
    `active` mask)."""
    NPl = pool_local.shape[2]
    p_loc = phys - _shard_page_offset(page_axes, NPl)
    owned = (p_loc >= 0) & (p_loc < NPl)
    paged_kv.append_token_inplace(pool_local[None], 0,
                                  p_loc.clamp(0, NPl - 1), slot, val, owned)
    return pool_local


def sharded_append_uniform(pool_k, pool_v, layer, k_new, v_new, phys, slot,
                           mesh, *, batch_axes: Sequence[str] = ("data",),
                           page_axes: Sequence[str] = ("model",),
                           k_scale=None, v_scale=None,
                           kv_quant: str = "none", active=None):
    """In-place append of one token's K/V into stacked stripe pools
    [L, B, K, NP, Ts, dh] at `layer`, inside the owning shard (the
    paper's direct G2-die write).  phys/slot [B]: each row's global page
    and slot; `active` [B] (optional) masks rows that must not write.
    kv8/kv4 pools carry per-page scales [L, B, K, NP]: the owning shard
    requantizes only the touched page (`append_token_quant`).  Returns
    (k, v) or (k, v, k_scale, v_scale) when quantized, as shards."""
    bspec, pg = axes_spec(batch_axes), axes_spec(page_axes)
    kp, vp = (_as_sharded(x, mesh, P(None, bspec, None, pg, None, None))
              for x in (pool_k, pool_v))
    ks, vs = (_as_sharded(x, mesh, P(None, bspec, None, pg))
              for x in (k_scale, v_scale))

    def local(kp_l, vp_l, ks_l, vs_l):
        Bl, NPl = kp_l.shape[1], kp_l.shape[3]
        dev = kp_l.device
        b0 = _shard_page_offset(batch_axes, Bl)
        p_loc = _rows(phys, b0, Bl, dev) - _shard_page_offset(page_axes,
                                                              NPl)
        owned = (p_loc >= 0) & (p_loc < NPl)
        if active is not None:
            owned &= _rows(active, b0, Bl, dev)
        p_loc = p_loc.clamp(0, NPl - 1)
        sl = _rows(slot, b0, Bl, dev)
        for pool, sc, new in ((kp_l, ks_l, k_new), (vp_l, vs_l, v_new)):
            val = _rows(new, b0, Bl, dev)
            if kv_quant != "none":
                paged_kv.append_token_quant(pool, sc, layer, p_loc, sl, val,
                                            kv_quant, active=owned)
            else:
                paged_kv.append_token_inplace(pool, layer, p_loc, sl, val,
                                              owned)

    map_shards(local, kp, vp, ks, vs)
    return (kp, vp) if kv_quant == "none" else (kp, vp, ks, vs)


def sharded_prefill_fill(pool, kv_seq, layer, mesh, *,
                         batch_axes: Sequence[str] = ("data",),
                         page_axes: Sequence[str] = ("model",),
                         scale=None, kv_quant: str = "none"):
    """Write prefill K/V [B, S, K, dh] into one layer of the stacked
    stripe pool [L, B, K, NP, Ts, dh], each shard packing only its own
    rows and page range (`paged_kv.fill_layer` on the local pool); the
    sequence is zero-padded to NP·T first, as in the reference.  kv8/kv4
    pools quantize each shard's pages and write their scales.  Returns
    pool or (pool, scale), as shards."""
    bspec, pg = axes_spec(batch_axes), axes_spec(page_axes)
    pool = _as_sharded(pool, mesh, P(None, bspec, None, pg, None, None))
    scale = _as_sharded(scale, mesh, P(None, bspec, None, pg))
    _, _, K, NP, Ts, dh = pool.shape
    T = Ts * (2 if kv_quant == "kv4" else 1)
    B, S = kv_seq.shape[:2]
    if NP * T > S:
        kv_seq = torch.cat([kv_seq, kv_seq.new_zeros(B, NP * T - S, K, dh)],
                           dim=1)

    def local(pool_l, scale_l):
        Bl, NPl = pool_l.shape[1], pool_l.shape[3]
        b0 = _shard_page_offset(batch_axes, Bl)
        p0 = _shard_page_offset(page_axes, NPl)
        chunk = kv_seq[b0:b0 + Bl, p0 * T:(p0 + NPl) * T].to(pool_l.device)
        paged_kv.fill_layer(pool_l, chunk, layer, scale=scale_l,
                            kv_quant=kv_quant)

    map_shards(local, pool, scale)
    return pool if kv_quant == "none" else (pool, scale)


def sharded_window_fill(pool, kv_seq, layer, mesh, *,
                        batch_axes: Sequence[str] = ("data",),
                        page_axes: Sequence[str] = ("model",),
                        scale=None, kv_quant: str = "none"):
    """Ring-fill the newest window pages of one layer, shard-locally:
    source page sp of the prompt lands in ring slot sp % NP, for the
    newest NP source pages, each shard writing (and, kv8/kv4,
    quantizing) only the slots in its range (`paged_kv.fill_pages_at`).
    Returns pool or (pool, scale), as shards."""
    bspec, pg = axes_spec(batch_axes), axes_spec(page_axes)
    pool = _as_sharded(pool, mesh, P(None, bspec, None, pg, None, None))
    scale = _as_sharded(scale, mesh, P(None, bspec, None, pg))
    _, _, K, NP, Ts, dh = pool.shape
    T = Ts * (2 if kv_quant == "kv4" else 1)
    B, S = kv_seq.shape[:2]
    n_src = paged_kv.ceil_div(S, T)
    src = paged_kv.pages_from_seq(kv_seq, T)            # [B, K, n_src, T, dh]

    def local(pool_l, scale_l):
        Bl, NPl = pool_l.shape[1], pool_l.shape[3]
        b0 = _shard_page_offset(batch_axes, Bl)
        p0 = _shard_page_offset(page_axes, NPl)
        sps = [sp for sp in range(max(0, n_src - NP), n_src)
               if p0 <= sp % NP < p0 + NPl]
        if not sps:
            return
        x = src[b0:b0 + Bl, :, sps].to(pool_l.device)
        s = None
        if kv_quant != "none":
            x, s = quant.quantize_kv_page(x, kv_quant)
        paged_kv.fill_pages_at(pool_l, x, layer, [sp % NP - p0 for sp in sps],
                               scale=scale_l, page_scales=s)

    map_shards(local, pool, scale)
    return pool if kv_quant == "none" else (pool, scale)


def sharded_chunk_fill(pool, kv_chunk, layer, slot, page0, valid_len, mesh,
                       *, batch_axes: Sequence[str] = ("data",),
                       page_axes: Sequence[str] = ("model",),
                       scale=None, kv_quant: str = "none"):
    """Chunked-prefill fill of one slot's stripe in the sharded stacked
    pool [L, B, K, NP, Ts, dh] (slot, page0 and valid_len Python ints):
    each shard that holds the slot's row writes the chunk pages in its
    page range (`paged_kv.fill_chunk_global_at` on its local pool), pages
    holding none of the `valid_len` real tokens skipped.  kv_chunk [1, C,
    K, dh] stays on the caller's device; each writing shard takes its
    pages' slice.  Returns pool or (pool, scale), as shards."""
    bspec, pg = axes_spec(batch_axes), axes_spec(page_axes)
    pool = _as_sharded(pool, mesh, P(None, bspec, None, pg, None, None))
    scale = _as_sharded(scale, mesh, P(None, bspec, None, pg))
    T = pool.shape[4] * (2 if kv_quant == "kv4" else 1)
    n_pages = paged_kv.ceil_div(kv_chunk.shape[1], T)

    def local(pool_l, scale_l):
        Bl, NPl = pool_l.shape[1], pool_l.shape[3]
        sl = slot - _shard_page_offset(batch_axes, Bl)
        p0 = _shard_page_offset(page_axes, NPl)
        lo, hi = max(page0, p0), min(page0 + n_pages, p0 + NPl)
        if not 0 <= sl < Bl or lo >= hi:
            return
        first = (lo - page0) * T
        sub = kv_chunk[:, first:(hi - page0) * T].to(pool_l.device)
        paged_kv.fill_chunk_global_at(pool_l, sub, layer, sl, lo - p0,
                                      valid_len - first, scale=scale_l,
                                      kv_quant=kv_quant)

    map_shards(local, pool, scale)
    return pool if kv_quant == "none" else (pool, scale)


def slot_stripe(leaf: ShardedTensor, layer: int, slot: int,
                batch_axes: Sequence[str]) -> ShardedTensor:
    """One layer of one slot's stripe, [1, K, NP, Ts, dh] (or its scales
    [1, K, NP]), as views on the shards that hold the slot's row: a
    ShardedTensor on the sub-mesh with the batch axes fixed there (the
    page axes, and any axis the pool replicates over, left free)."""
    mesh = leaf.mesh
    Bl = leaf.shards[0].shape[1]
    blk, fixed = slot // Bl, {}
    for a in reversed(tuple(batch_axes)):
        blk, fixed[a] = divmod(blk, mesh.shape[a])
    sub = mesh.submesh(fixed)
    r = slot % Bl
    return ShardedTensor(sub, P(None, *leaf.spec[2:]), [
        leaf.local({**fixed, **c})[layer, r:r + 1] for c in sub.coords()])


def sharded_chunk_attention(q, k_pages, v_pages, page_base, start, q_pos,
                            mesh, *, window: Optional[int] = None,
                            page_axes: Sequence[str] = ("model",),
                            kv_quant: str = "none", k_scale=None,
                            v_scale=None, partitions: int = 0):
    """Past-context partial of one slot's chunk queries against its
    page-sharded stripe (chunked prefill on a mesh).

    q: [1, S, H, dh] on the caller's device; pages: [1, K, NP, Ts, dh]
    the slot's stripe, NP sharded over `page_axes` (replicated over any
    other axis of `mesh`); page_base: [1, NP] absolute positions.  Each
    shard runs the chunk partial over its local pages (`partitions`
    splits its local walk) and the partials merge by the log-sum-exp
    combine.  Returns the combined (o, m, l) on q's device, for the
    caller's merge with the in-chunk causal partial."""
    pg = axes_spec(page_axes)
    kp, vp = (_as_sharded(x, mesh, P(None, None, pg, None, None))
              for x in (k_pages, v_pages))
    ks, vs = (_as_sharded(x, mesh, P(None, None, pg))
              for x in (k_scale, v_scale))

    def run(kp_l, vp_l, ks_l, vs_l):
        NPl = kp_l.shape[2]
        p0 = _shard_page_offset(page_axes, NPl)
        dev = kp_l.device
        return paged_chunk_attention(
            q.to(dev), kp_l, vp_l,
            page_base[:, p0:p0 + NPl].to(dev).contiguous(), start,
            torch.as_tensor(q_pos).to(dev), window=window,
            kv_quant=kv_quant, k_scale=ks_l, v_scale=vs_l,
            partitions=partitions)

    o, m, l = map_shards(run, kp, vp, ks, vs, out_specs=[P(), P(), P()])
    if _n_shards(mesh, page_axes) > 1:
        o, m, l = combine_partials_stats(o, m, l, tuple(page_axes))
    return tuple(x.assemble(q.device) for x in (o, m, l))


def paged_decode_attention_sharded(
    q, k_pages, v_pages, page_base, length, mesh, *,
    window: Optional[int] = None,
    batch_axes: Sequence[str] = ("data",),
    page_axes: Sequence[str] = ("model",),
    append: Optional[Tuple] = None,   # (k_new [B,K,dh], v_new, phys, slot)
    kv_quant: str = "none",
    k_scale=None, v_scale=None,       # [B, K, NP] per-page x head scales
    partitions: int = 0,              # split of each shard's local walk
    kv_heads: Optional[Tuple[int, int]] = None,
):
    """q: [B, H, dh]; pages: [B, K, NP, T, dh] (one layer); page_base:
    [B, NP] absolute position of each physical page's slot 0 (<0 =
    unwritten); length: [B] context length including the token being
    decoded.

    Pages are sharded over `page_axes` and batch rows over `batch_axes`;
    each shard runs `paged_attention_partial` on its local pages (kernel
    B1 on a card) and the partials combine over `page_axes` (the paper's
    NPU aggregation step).  `kv_heads` attends one head group (KVNAND-D).
    With `append`, the new token's K/V land in the owning shard before
    the attention (the paper's direct G2 write; float pools only, as in
    the reference).  Returns o [B, H, dh] on q's device, or (o, k pages,
    v pages) when appending."""
    if append is not None and kv_quant != "none":
        raise NotImplementedError(
            "fused append+attention does not support quantized pools; "
            "the engine appends via sharded_append_uniform instead")
    bspec, pg = axes_spec(batch_axes), axes_spec(page_axes)
    kp, vp = (_as_sharded(x, mesh, P(bspec, None, pg, None, None))
              for x in (k_pages, v_pages))
    ks, vs = (_as_sharded(x, mesh, P(bspec, None, pg))
              for x in (k_scale, v_scale))

    def run(kp_l, vp_l, ks_l, vs_l):
        Bl, NPl = kp_l.shape[0], kp_l.shape[2]
        dev = kp_l.device
        b0 = _shard_page_offset(batch_axes, Bl)
        p0 = _shard_page_offset(page_axes, NPl)
        if append is not None:
            k_new, v_new, phys, slot = (_rows(x, b0, Bl, dev) for x in append)
            local_append_uniform(kp_l, phys, slot, k_new, page_axes)
            local_append_uniform(vp_l, phys, slot, v_new, page_axes)
        return paged_attention_partial(
            _rows(q, b0, Bl, dev), kp_l, vp_l,
            page_base[b0:b0 + Bl, p0:p0 + NPl].to(dev).contiguous(),
            _rows(length, b0, Bl, dev), window=window, kv_quant=kv_quant,
            k_scale=ks_l, v_scale=vs_l, partitions=partitions,
            kv_heads=kv_heads)

    o, m, l = map_shards(run, kp, vp, ks, vs,
                         out_specs=[P(bspec, None, None), P(bspec, None),
                                    P(bspec, None)])
    if _n_shards(mesh, page_axes) > 1:
        o = combine_partials(o, m, l, tuple(page_axes))
    o = o.assemble(q.device).to(q.dtype)
    return o if append is None else (o, kp, vp)


# ---------------------------------------------------------------------------
# Shared-pool (FTL-mapped) variants: P_total sharded over the mesh
# ---------------------------------------------------------------------------
#
# The shared pool [K, P_total, T, dh] shards its PHYSICAL page axis over
# `page_axes` (the paper's G2 dies); page tables hold GLOBAL physical
# indices, so each shard subtracts its page offset and masks entries
# outside its local range: a table walk is shard-local arithmetic, and
# the KV bytes never move.  Over batch axes the pool is replicated.

def paged_decode_attention_sharded_shared(
    q, k_pages, v_pages, page_table, page_base, length, mesh, *,
    window: Optional[int] = None,
    batch_axes: Sequence[str] = ("data",),
    page_axes: Sequence[str] = ("model",),
    kv_quant: str = "none",
    k_scale=None, v_scale=None,       # [K, P_total] per-page x head scales
    partitions: int = 0,              # split of each shard's local walk
    kv_heads: Optional[Tuple[int, int]] = None,
):
    """q: [B, H, dh]; pages: [K, P_total, T, dh] sharded on P_total;
    page_table: [B, NP] global physical indices; page_base: [B, NP] base
    position of logical page j (<0 = unwritten); length: [B].

    Each shard translates its rows' table into its local page range
    (entries it does not own get page_base -1e9, so they are masked by
    data), runs the shared-pool partial over its local pages (kernel B2
    on a card), and the partials merge by the log-sum-exp combine.
    Returns o [B, H, dh] on q's device."""
    bspec, pg = axes_spec(batch_axes), axes_spec(page_axes)
    kp, vp = (_as_sharded(x, mesh, P(None, pg, None, None))
              for x in (k_pages, v_pages))
    ks, vs = (_as_sharded(x, mesh, P(None, pg)) for x in (k_scale, v_scale))
    Bl = q.shape[0] // _n_shards(mesh, batch_axes)

    def run(kp_l, vp_l, ks_l, vs_l):
        P_local = kp_l.shape[1]
        dev = kp_l.device
        b0 = _shard_page_offset(batch_axes, Bl)
        tl = _rows(page_table, b0, Bl, dev) - _shard_page_offset(page_axes,
                                                                 P_local)
        owned = (tl >= 0) & (tl < P_local)
        base = _rows(page_base, b0, Bl, dev)
        base = torch.where(owned, base, torch.full_like(base, -(10 ** 9)))
        return paged_attention_partial(
            _rows(q, b0, Bl, dev), kp_l, vp_l, base,
            _rows(length, b0, Bl, dev), window=window, kv_quant=kv_quant,
            k_scale=ks_l, v_scale=vs_l, page_table=tl.clamp(0, P_local - 1),
            partitions=partitions, kv_heads=kv_heads)

    o, m, l = map_shards(run, kp, vp, ks, vs,
                         out_specs=[P(bspec, None, None), P(bspec, None),
                                    P(bspec, None)])
    if _n_shards(mesh, page_axes) > 1:
        o = combine_partials(o, m, l, tuple(page_axes))
    return o.assemble(q.device).to(q.dtype)


def sharded_append_shared(pool_k, pool_v, layer, k_new, v_new, phys, slot,
                          mesh, *, batch_axes: Sequence[str] = ("data",),
                          page_axes: Sequence[str] = ("model",),
                          k_scale=None, v_scale=None,
                          kv_quant: str = "none", rows=None):
    """One-token append into stacked shared pools [L, K, P, T, dh] at
    `layer`: the shard owning each row's physical page writes it through
    the shared writers (`append_global_shared`,
    `append_token_quant_shared`) on its local pool; every replica over
    the batch axes applies the same full-batch append, so the copies stay
    equal.  phys/slot [B] (phys a tensor or a host array: it is read to
    the host once a call to pick each shard's rows); `rows`: the writing
    rows (default all).  Returns (k, v) or (k, v, k_scale, v_scale), as
    shards."""
    del batch_axes                       # the values replicate (see above)
    pg = axes_spec(page_axes)
    kp, vp = (_as_sharded(x, mesh, P(None, None, pg, None, None))
              for x in (pool_k, pool_v))
    ks, vs = (_as_sharded(x, mesh, P(None, None, pg))
              for x in (k_scale, v_scale))
    ph = (phys.cpu().numpy() if isinstance(phys, torch.Tensor)
          else np.asarray(phys)).astype(np.int64)
    writers = (np.arange(len(ph)) if rows is None
               else np.asarray(rows.cpu() if isinstance(rows, torch.Tensor)
                               else rows, dtype=np.int64))

    def local(kp_l, vp_l, ks_l, vs_l):
        P_local = kp_l.shape[2]
        p0 = _shard_page_offset(page_axes, P_local)
        mine = writers[(ph[writers] >= p0) & (ph[writers] < p0 + P_local)]
        if not len(mine):
            return
        dev = kp_l.device
        r = torch.as_tensor(mine, device=dev)
        p_loc = torch.as_tensor(ph - p0, device=dev)
        sl = slot.to(dev)
        for pool, sc, new in ((kp_l, ks_l, k_new), (vp_l, vs_l, v_new)):
            if kv_quant != "none":
                paged_kv.append_token_quant_shared(pool, sc, layer, p_loc, sl,
                                                   new.to(dev), kv_quant, r)
            else:
                paged_kv.append_global_shared(pool, layer, p_loc, sl,
                                              new.to(dev), r)

    map_shards(local, kp, vp, ks, vs)
    return (kp, vp) if kv_quant == "none" else (kp, vp, ks, vs)
