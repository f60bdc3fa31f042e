"""Public paged-attention entry points (port of
`repro.kernels.paged_attention.ops`).

`paged_attention_partial` dispatches by the tensors' device alone: a CPU
or meta tensor takes the plain torch version (`ref.py`), a CUDA tensor
launches a CUDA kernel — the stripe kernel, or the shared-pool kernel
when a `page_table` is given — and there is no fallback between the
two.  Both
split the page walk into `partitions` contiguous ranges whose partials
recombine in `merge.merge_partials` (0 resolves per
`merge.resolve_partitions`).

With `page_table` [B, NP], k/v_pages (and scales) are the shared GLOBAL
pool [K, P_total, ...]: the plain version gathers each partition's slice
of the slot's pages through the table before the stripe oracle runs, the
kernel walks the table itself (no gathered copy).

`kv_heads=(head0, n)` attends q's heads to the pool's kv heads [head0,
head0 + n) only (one head group of the discrete variant, KVNAND-D): the
plain version and the shared-pool kernel take the head slice of the pool
as a view (contiguous on the shared pool, whose kv-head axis leads); the
stripe kernel walks the layer's whole pool from `head0` in place, since a
head slice of a stripe is not contiguous and copying it would copy the
layer's pool once per group.

`paged_chunk_attention` (the past-context partial of chunked prefill)
has no kernel in the reference either and stays plain torch on every
device.  The reference's TPU-only `pages_per_block` blocking is not
carried over.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels import PLAIN_DEVICES
from repro_torch.kernels.paged_attention.kernel import (
    paged_attention_cuda, paged_attention_shared_cuda)
from repro_torch.kernels.paged_attention.merge import (merge_partials,
                                                      resolve_partitions)
from repro_torch.kernels.paged_attention.ref import (
    gather_table_pages, paged_attention_partial_ref,
    paged_chunk_attention_ref)


def _partition_walk(num_pages: int, partitions: int, piece):
    """Run `piece(page_lo, pages_per_partition)` over contiguous page
    ranges, one at a time, and merge the stacked partials."""
    npp = num_pages // partitions
    parts = [piece(i * npp, npp) for i in range(partitions)]
    o, m, l = (torch.stack(x) for x in zip(*parts))
    return merge_partials(o, m, l, axis=0)


def _slice_pages(lo: int, n: int, k_pages, v_pages, page_base, k_scale,
                 v_scale, page_table):
    """Partition [lo, lo + n) of the logical page walk as stripe-layout
    operands: a slice of the stripe, or the shared pool's pages (and
    scales) gathered through that slice of the table."""
    sl = lambda a, axis: None if a is None else a.narrow(axis, lo, n)  # noqa
    if page_table is None:
        return (sl(k_pages, 2), sl(v_pages, 2), sl(page_base, 1),
                sl(k_scale, 2), sl(v_scale, 2))
    tbl = sl(page_table, 1)

    def gather(a):
        return None if a is None else gather_table_pages(a, tbl)

    return (gather(k_pages), gather(v_pages), sl(page_base, 1),
            gather(k_scale), gather(v_scale))


def paged_chunk_attention(q, k_pages, v_pages, page_base, start, q_pos, *,
                          window: Optional[int] = None,
                          kv_quant: str = "none", k_scale=None, v_scale=None,
                          page_table=None, partitions: int = 0):
    """Past-context partial of a multi-token span (plain torch)."""
    NP = k_pages.shape[2] if page_table is None else page_table.shape[1]
    P = resolve_partitions(partitions, NP)

    def piece(lo, npp):
        kp, vp, base, ks, vs = _slice_pages(lo, npp, k_pages, v_pages,
                                            page_base, k_scale, v_scale,
                                            page_table)
        return paged_chunk_attention_ref(
            q, kp, vp, base, start, q_pos, window=window, kv_quant=kv_quant,
            k_scale=ks, v_scale=vs)

    if P == 1:
        return piece(0, NP)
    return _partition_walk(NP, P, piece)


def paged_attention_partial(
    q: torch.Tensor,          # [B, H, dh]
    k_pages: torch.Tensor,    # [B, K, NP, T, dh] (kv4: [B, K, NP, T/2, dh])
    v_pages: torch.Tensor,    # shared: [K, P_total, T, dh]
    page_base: torch.Tensor,  # [B, NP]
    length: torch.Tensor,     # [B]
    *,
    window: Optional[int] = None,
    kv_quant: str = "none",
    k_scale: Optional[torch.Tensor] = None,   # [B, K, NP] (shared: [K, P])
    v_scale: Optional[torch.Tensor] = None,
    page_table: Optional[torch.Tensor] = None,  # [B, NP] shared-pool tables
    partitions: int = 0,      # 0 = auto from page count; must divide NP
    kv_heads: Optional[Tuple[int, int]] = None,  # (head0, n): a head range
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Returns (o [B, H, dh] locally normalized, m [B, H], l [B, H])."""
    B, H, dh = q.shape
    shared = page_table is not None
    head_axis = 0 if shared else 1
    head0, K = kv_heads or (0, k_pages.shape[head_axis])
    NP = page_table.shape[1] if shared else k_pages.shape[2]
    G = H // K
    P = resolve_partitions(partitions, NP)
    plain = q.device.type in PLAIN_DEVICES
    if kv_heads is not None and (shared or plain):
        k_pages, v_pages, k_scale, v_scale = (
            None if a is None else a.narrow(head_axis, head0, K)
            for a in (k_pages, v_pages, k_scale, v_scale))
        head0 = 0

    if plain:
        def piece(lo, npp):
            kp, vp, base, ks, vs = _slice_pages(lo, npp, k_pages, v_pages,
                                                page_base, k_scale, v_scale,
                                                page_table)
            return paged_attention_partial_ref(
                q, kp, vp, base, length, window=window, kv_quant=kv_quant,
                k_scale=ks, v_scale=vs)

        o, m, l = (piece(0, NP) if P == 1
                   else _partition_walk(NP, P, piece))
        # o in q's dtype, as the kernel path returns it
        return o.to(q.dtype), m, l

    if q.device.type != "cuda":
        raise ValueError(f"paged_attention_partial: no kernel for device "
                         f"{q.device}")
    q4 = q.reshape(B, K, G, dh).float().contiguous()
    kw = dict(window=window, kv_quant=kv_quant, k_scale=k_scale,
              v_scale=v_scale, partitions=P)
    if shared:
        o, m, l = paged_attention_shared_cuda(
            q4, k_pages, v_pages, page_table.to(torch.int32).contiguous(),
            page_base.to(torch.int32).contiguous(), length.to(torch.int32),
            **kw)
    else:
        o, m, l = paged_attention_cuda(
            q4, k_pages, v_pages, page_base.to(torch.int32),
            length.to(torch.int32), head0=head0, **kw)
    if P > 1:
        o, m, l = merge_partials(o, m, l, axis=2)
    else:
        o, m, l = o[:, :, 0], m[:, :, 0], l[:, :, 0]
    return (o.reshape(B, H, dh).to(q.dtype), m.reshape(B, H),
            l.reshape(B, H))
