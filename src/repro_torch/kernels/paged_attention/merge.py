"""N-partial log-sum-exp merge core (port of
`repro.kernels.paged_attention.merge`).

Partials are locally normalized `(o, m, l)` triples.  An empty partial
(`m = NEG_INF = -1e30`, finite so `exp` never yields NaN, and `l = 0`)
carries zero weight; if every partial is empty the merge returns
o = 0, l = 0 — what one partial over an empty page set returns.
"""
from __future__ import annotations

from typing import Tuple

import torch

NEG_INF = -1e30


def merge_partials(o: torch.Tensor, m: torch.Tensor, l: torch.Tensor,
                   axis: int = 0
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Merge N partials stacked on `axis` (o carries a trailing dh dim)."""
    m = torch.movedim(m, axis, 0)
    l = torch.movedim(l, axis, 0)
    o = torch.movedim(o, axis, 0)
    m_all = m.amax(dim=0)
    w = l * torch.exp(m - m_all[None])            # l re-scaled to global max
    l_all = w.sum(dim=0)
    o_all = (o * w[..., None]).sum(dim=0) \
        / l_all.clamp_min(1e-30)[..., None]
    return o_all, m_all, l_all


def resolve_partitions(partitions: int, num_pages: int) -> int:
    """Resolve a partition request against a concrete page count.

    partitions > 0 must divide `num_pages`; 0 is auto: walks under 256
    pages stay whole, longer ones split 16 ways, halved down to the
    nearest divisor."""
    if num_pages <= 0:
        raise ValueError(f"num_pages must be positive, got {num_pages}")
    if partitions < 0:
        raise ValueError(f"partitions must be >= 0, got {partitions}")
    if partitions:
        if num_pages % partitions:
            raise ValueError(
                f"partitions={partitions} does not divide the page count "
                f"{num_pages}; pick a divisor (or 0 for auto)")
        return partitions
    p = 1 if num_pages < 256 else 16
    while p > 1 and num_pages % p:
        p //= 2
    return p
