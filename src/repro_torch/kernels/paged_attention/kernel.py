"""CUDA paged decode-attention kernels: build, bind, launch.

Two kernels share one body (`csrc/paged_attention.cuh`):

  * B1 `paged_attention_cuda` (`csrc/paged_attention.cu`) replaces the
    TPU kernel `repro/kernels/paged_attention/kernel.py::
    paged_attention_pallas` (per-slot stripe pools).  It walks a range of
    the pool's kv heads (`head0` and q's head count): one head group of
    the discrete variant reads its heads of the layer's whole pool in
    place, since a head slice of a stripe pool is not contiguous;
  * B2 `paged_attention_shared_cuda` (`csrc/paged_attention_shared.cu`)
    replaces `paged_attention_pallas_shared` (one shared pool reached
    through per-slot page tables).

Each caller partition of the page walk is split inside the launch over
a thread-block cluster of S CTAs (`choose_split`, or `split=` forced),
which merge their partials through distributed shared memory, so the
output is one (o, m, l) per caller partition whatever S is.

Each source builds into its own library (`kernels/_build.py`, which
compiles every kernel library of the port in parallel at first use).
Importing this module builds nothing and needs neither nvcc nor a card.
"""
from __future__ import annotations

import functools
from typing import Optional, Tuple

import torch

from repro_torch.kernels._build import LaunchCount, entry

_FMT = {"none": None, "kv8": 2, "kv4": 3}
_POOL_DTYPE = {torch.float32: 0, torch.bfloat16: 1}

HEAD_DIMS = (32, 64, 112, 128, 160, 256)
SPLITS = (1, 2, 4, 8)             # cluster sizes the kernels take
TILE_TOKENS = 32                  # token slots a warp stages at once

launches = LaunchCount()          # B1, the stripe kernel
launches_shared = LaunchCount()   # B2, the shared-pool kernel


def _check(cond: bool, msg: str):
    if not cond:
        raise ValueError(f"paged_attention_cuda: {msg}")


def choose_split(ctas: int, partition_tokens: int, sms: int = 132) -> int:
    """Cluster size S that splits each caller partition's page walk.

    `ctas` = B·K·P is the launch's grid without a split and
    `partition_tokens` = (NP / P)·T the token slots one partition walks.
    S is the largest of 1, 2, 4, 8 that keeps the grid at one CTA an SM
    or fewer and hands every CTA at least one tile of TILE_TOKENS slots;
    so S = 1 where the grid already has a CTA for every SM.  (Measured on
    an H100: a CTA's fixed chain of memory round trips and merges costs
    more than a second CTA on the SM saves, so a grid past one CTA an SM
    runs slower.)"""
    s = 1
    while (s < SPLITS[-1] and ctas * 2 * s <= sms
           and partition_tokens >= 2 * s * TILE_TOKENS):
        s *= 2
    return s


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _split_of(split: int, q, NP: int, T: int, partitions: int) -> int:
    if split:
        _check(split in SPLITS, f"split={split} not in {SPLITS}")
        return split
    B, K = q.shape[:2]
    return choose_split(B * K * partitions, NP // partitions * T,
                        _sm_count(q.device.index or 0))


def _check_inputs(q, k_pages, v_pages, page_base, length, *, pool_shape,
                  scale_shape, NP, window, kv_quant, k_scale, v_scale,
                  partitions) -> int:
    """The checks both kernels share; returns the C format code."""
    B, K, G, dh = q.shape
    dev = q.device
    _check(dh in HEAD_DIMS, f"head dim {dh} not in {HEAD_DIMS}")
    _check(1 <= G <= 8, f"query group {G} not in 1..8")
    _check(partitions >= 1 and NP % partitions == 0,
           f"partitions={partitions} must divide the page count {NP}")
    _check(window is None or window >= 0, f"bad window {window}")
    _check(q.dtype == torch.float32, "q must be float32")
    _check(q.is_contiguous(), "q must be contiguous")
    if kv_quant == "none":
        _check(k_pages.dtype in _POOL_DTYPE,
               f"pool dtype {k_pages.dtype} not float32/bfloat16")
        fmt = _POOL_DTYPE[k_pages.dtype]
    else:
        want = torch.int8 if kv_quant == "kv8" else torch.uint8
        _check(k_pages.dtype == want, f"{kv_quant} pool must be {want}")
        fmt = _FMT[kv_quant]
        for s in (k_scale, v_scale):
            _check(s is not None and s.dtype == torch.float32
                   and tuple(s.shape) == scale_shape and s.is_contiguous()
                   and s.device == dev,
                   f"kv8/kv4 scales must be contiguous float32 "
                   f"{list(scale_shape)}")
    for t in (k_pages, v_pages):
        _check(tuple(t.shape) == pool_shape and t.dtype == k_pages.dtype,
               f"pool shape {tuple(t.shape)} != {pool_shape}")
        _check(t.device == dev and t.is_contiguous()
               and t.data_ptr() % 16 == 0,
               "pools must be contiguous and 16-byte aligned on q's device")
    _check(tuple(page_base.shape) == (B, NP)
           and page_base.dtype == torch.int32
           and page_base.is_contiguous() and page_base.device == dev,
           "page_base must be contiguous int32 [B, NP]")
    _check(tuple(length.shape) == (B,) and length.dtype == torch.int32
           and length.is_contiguous() and length.device == dev,
           "length must be contiguous int32 [B]")
    return fmt


def _partials(q, partitions):
    B, K, G, dh = q.shape
    P = partitions
    dev = q.device
    return (torch.empty((B, K, P, G, dh), dtype=torch.float32, device=dev),
            torch.empty((B, K, P, G), dtype=torch.float32, device=dev),
            torch.empty((B, K, P, G), dtype=torch.float32, device=dev))


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _raise_on(rc: int):
    if rc != 0:
        raise RuntimeError(f"paged_attention kernel launch failed: CUDA "
                           f"error {rc}")


def paged_attention_cuda(
    q: torch.Tensor,          # [B, K, G, dh] float32
    k_pages: torch.Tensor,    # [B, Kp, NP, Ts, dh], Kp >= head0 + K
    v_pages: torch.Tensor,
    page_base: torch.Tensor,  # [B, NP] int32
    length: torch.Tensor,     # [B] int32
    *,
    window: Optional[int] = None,
    kv_quant: str = "none",
    k_scale: Optional[torch.Tensor] = None,   # [B, Kp, NP] float32
    v_scale: Optional[torch.Tensor] = None,
    partitions: int = 1,
    split: int = 0,           # cluster size S; 0 = choose_split
    head0: int = 0,           # the pool's kv head that q's head 0 reads
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Launch B1 (stripe pools) over the pool's kv heads [head0, head0 +
    K); returns partials o [B, K, P, G, dh], m / l [B, K, P, G] (float32),
    one per caller partition whatever the split.  Checks device, dtype,
    shape and contiguity and raises on anything the kernel does not
    take."""
    _check(kv_quant in _FMT, f"unknown kv_quant {kv_quant!r}")
    _check(q.is_cuda, "tensors must be on a CUDA device")
    B, K, G, dh = q.shape
    Kp, NP, Ts = k_pages.shape[1], k_pages.shape[2], k_pages.shape[3]
    T = 2 * Ts if kv_quant == "kv4" else Ts
    _check(0 <= head0 and head0 + K <= Kp,
           f"heads [{head0}, {head0 + K}) outside the pool's {Kp}")
    fmt = _check_inputs(q, k_pages, v_pages, page_base, length,
                        pool_shape=(B, Kp, NP, Ts, dh),
                        scale_shape=(B, Kp, NP), NP=NP, window=window,
                        kv_quant=kv_quant, k_scale=k_scale, v_scale=v_scale,
                        partitions=partitions)
    o, m, l = _partials(q, partitions)
    if B == 0:
        return o, m, l
    S = _split_of(split, q, NP, T, partitions)
    fn = entry("kvnand_paged_attention")
    _raise_on(fn(
        _ptr(q), _ptr(k_pages), _ptr(v_pages), _ptr(k_scale), _ptr(v_scale),
        _ptr(page_base), _ptr(length), _ptr(o), _ptr(m), _ptr(l),
        B, K, Kp, head0, NP, T, G, dh, partitions,
        -1 if window is None else int(window), S, fmt,
        torch.cuda.current_stream(q.device).cuda_stream))
    launches.value += 1
    return o, m, l


def paged_attention_shared_cuda(
    q: torch.Tensor,           # [B, K, G, dh] float32
    k_pages: torch.Tensor,     # [K, P_total, Ts, dh]
    v_pages: torch.Tensor,
    page_table: torch.Tensor,  # [B, NP] int32, every entry in [0, P_total)
    page_base: torch.Tensor,   # [B, NP] int32
    length: torch.Tensor,      # [B] int32
    *,
    window: Optional[int] = None,
    kv_quant: str = "none",
    k_scale: Optional[torch.Tensor] = None,   # [K, P_total] float32
    v_scale: Optional[torch.Tensor] = None,
    partitions: int = 1,
    split: int = 0,           # cluster size S; 0 = choose_split
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Launch B2 (shared pool through page tables); returns partials
    o [B, K, P, G, dh], m / l [B, K, P, G] (float32), one per caller
    partition whatever the split.

    Precondition, not checked (it would cost a device sync per launch):
    every table entry lies in [0, P_total).  The kernel addresses pages
    only through the entries of tokens that pass the base / length /
    window mask, so stale entries past `length` are never dereferenced.
    Checks device, dtype, shape and contiguity and raises on anything the
    kernel does not take."""
    _check(kv_quant in _FMT, f"unknown kv_quant {kv_quant!r}")
    _check(q.is_cuda, "tensors must be on a CUDA device")
    B, K, G, dh = q.shape
    P_total, Ts = k_pages.shape[1], k_pages.shape[2]
    T = 2 * Ts if kv_quant == "kv4" else Ts
    _check(page_table.ndim == 2 and page_table.shape[0] == B
           and page_table.dtype == torch.int32
           and page_table.is_contiguous() and page_table.device == q.device,
           "page_table must be contiguous int32 [B, NP]")
    NP = page_table.shape[1]
    _check(0 < P_total < 2 ** 31, f"bad pool size {P_total}")
    fmt = _check_inputs(q, k_pages, v_pages, page_base, length,
                        pool_shape=(K, P_total, Ts, dh),
                        scale_shape=(K, P_total), NP=NP, window=window,
                        kv_quant=kv_quant, k_scale=k_scale, v_scale=v_scale,
                        partitions=partitions)
    o, m, l = _partials(q, partitions)
    if B == 0:
        return o, m, l
    S = _split_of(split, q, NP, T, partitions)
    fn = entry("kvnand_paged_attention_shared")
    _raise_on(fn(
        _ptr(q), _ptr(k_pages), _ptr(v_pages), _ptr(k_scale), _ptr(v_scale),
        _ptr(page_table), _ptr(page_base), _ptr(length), _ptr(o), _ptr(m),
        _ptr(l), B, K, NP, P_total, T, G, dh, partitions,
        -1 if window is None else int(window), S, fmt,
        torch.cuda.current_stream(q.device).cuda_stream))
    launches_shared.value += 1
    return o, m, l
