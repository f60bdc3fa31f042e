"""Single-device pieces of `repro.core.seqpar`: the in-chunk causal
partial and the two-way LSE merge that chunked prefill needs.

The sharded page walks, ring attention and cross-device combines are
not ported yet (ROADMAP A17, multiple GPUs).
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.paged_attention.merge import NEG_INF, merge_partials


def merge_two(o1, m1, l1, o2, m2, l2):
    """Merge two locally-normalized partials (log-sum-exp)."""
    return merge_partials(torch.stack([o1, o2]), torch.stack([m1, m2]),
                          torch.stack([l1, l2]), axis=0)


def _attn_block_partial(q, k, v, q_pos, k_pos0, *, causal: bool,
                        window: Optional[int], scale: float):
    """One (q-chunk x kv-chunk) partial in float32 -> (o, m, l).

    q: [B, Sq, H, dh]; k/v: [B, Sk, K, dh]; q_pos: [Sq] absolute
    positions; k_pos0: absolute position of k[0]."""
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
        mask &= k_pos[None, :] > q_pos[:, None] - window
    s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    m = s.amax(dim=-1)                                          # [B,K,G,Sq]
    p = torch.exp(s - m[..., None])
    l = p.sum(dim=-1)
    o = torch.einsum("bkgqs,bskd->bqkgd", p, v.float())
    o = o / l.clamp_min(1e-30).permute(0, 3, 1, 2)[..., None]
    return (o.reshape(B, Sq, H, dh),
            m.permute(0, 3, 1, 2).reshape(B, Sq, H),
            l.permute(0, 3, 1, 2).reshape(B, Sq, H))
