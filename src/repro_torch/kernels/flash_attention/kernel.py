"""CUDA flash-attention forward, kernel B4: plan, bind and launch.

`flash_attention_cuda` (`csrc/flash_attention.cu`) replaces the TPU
kernel `repro/kernels/flash_attention/kernel.py::flash_attention_pallas`.
It reads q [B, Sq, H, dh] and k/v [B, Sk, K, dh] in place through their
strides (no transposed or padded copy: the kernel masks the ragged tails
itself, and pads dh to its compute width of 64, 128 or 256 inside shared
memory, where the TPU path pads dh to its 128-wide lanes in copies),
scales q by the unpadded dh^-0.5, accumulates in float32 and writes
o [B, Sq, H, dh] in q's dtype.  Its products run on the tensor cores:
float32 as three TF32 products (f32-exact), bfloat16 on bf16 mma.

`choose_flash_plan` splits each 64-row q tile's key range over a
thread-block cluster of S CTAs where the grid alone would leave SMs idle
(short prompts at B=1); it runs on the host, so the CPU tests hold it,
and `plan=` forces one.
The source builds into its own library (`kernels/_build.py`, in parallel
with the other kernels, at first use); importing this module builds
nothing and needs neither nvcc nor a card.
"""
from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import torch

from repro_torch.kernels._build import LaunchCount, entry

launches = LaunchCount()          # B4

_DTYPES = (torch.float32, torch.bfloat16)
# every d_head of the port's configs (the reduced ones are 32)
HEAD_DIMS = (32, 64, 112, 128, 160, 256)
SPLITS = (1, 2, 4, 8)             # cluster sizes the kernel takes
BLOCK_Q = 64                      # query rows a CTA
# The instances `csrc/flash_attention.cu` compiles (its `Geo`), by dtype
# and compute width: (keys a tile, ring stages, CTAs an SM it is built to
# hold).  dh runs in the narrowest width that holds it.
INSTANCES = {(torch.float32, 64): (64, 2, 2),
             (torch.float32, 128): (32, 2, 2),
             (torch.float32, 256): (32, 2, 1),
             (torch.bfloat16, 64): (64, 3, 3),
             (torch.bfloat16, 128): (64, 2, 2),
             (torch.bfloat16, 256): (32, 2, 2)}
# the fewest key tiles a rank of a split walks on the longest q tile (at
# the serving shape a split that leaves a rank one tile runs slower than
# one that leaves it two: PERF.md §6)
MIN_SPLIT_TILES = 2


class FlashPlan(NamedTuple):
    split: int                    # S: CTAs of a cluster sharing a q tile
    block_k: int                  # keys a tile of the instance
    stages: int                   # its ring stages
    ctas: int                     # CTAs an SM it is built to hold
    grid: tuple                   # (q tiles x S, H, B)


def _check(cond: bool, msg: str):
    if not cond:
        raise ValueError(f"flash_attention_cuda: {msg}")


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def instance(dh: int, dtype: torch.dtype) -> tuple:
    """(keys a tile, ring stages, CTAs an SM) of the instance that runs
    head dim `dh` in `dtype`."""
    _check(dh in HEAD_DIMS, f"head dim {dh} not in {HEAD_DIMS}")
    _check(dtype in _DTYPES, f"dtype {dtype} not float32/bfloat16")
    width = 64 if dh <= 64 else 128 if dh <= 128 else 256
    return INSTANCES[(dtype, width)]


def key_tiles(Sq: int, Sk: int, causal: bool, window: Optional[int],
              q_offset: int, block_k: int) -> int:
    """The key tiles the longest-walking q tile visits: its rows' causal
    and window spans, cut to block_k tiles as the kernel cuts them."""
    most = 0
    for q0 in range(0, Sq, BLOCK_Q):
        first = q_offset + q0
        last = q_offset + min(q0 + BLOCK_Q, Sq) - 1
        hi = min(Sk, last + 1) if causal else Sk
        lo = max(0, first - window + 1) if window else 0
        if hi > lo:
            most = max(most, _cdiv(hi, block_k) - lo // block_k)
    return most


def choose_flash_plan(B: int, Sq: int, Sk: int, H: int, causal: bool,
                      window: Optional[int], sms: int = 132, *,
                      q_offset: int = 0, dh: int = 64,
                      dtype: torch.dtype = torch.float32,
                      split: Optional[int] = None) -> FlashPlan:
    """The cluster size S that splits each q tile's key range, for one
    launch on a card of `sms` SMs.  The grid without a split is
    B·H·ceil(Sq/64) CTAs; S doubles (up to 8) while the split grid still
    fits on the card at the CTAs an SM the instance holds, and while every
    rank of the longest walk keeps at least MIN_SPLIT_TILES key tiles.  So
    S = 1 where the grid already fills the card, and never more splits
    than the longest walk has key tiles.  `split` forces S."""
    _check(min(B, Sq, Sk, H) >= 1, f"bad shape B={B} Sq={Sq} Sk={Sk} H={H}")
    block_k, stages, ctas = instance(dh, dtype)
    grid = B * H * _cdiv(Sq, BLOCK_Q)
    if split is None:
        split = 1
        # the walk is measured only where the card has room for a split
        tiles = (key_tiles(Sq, Sk, causal, window, q_offset, block_k)
                 if grid * 2 <= sms * ctas else 0)
        while (split < SPLITS[-1] and grid * 2 * split <= sms * ctas
               and tiles >= 2 * split * MIN_SPLIT_TILES):
            split *= 2
    _check(split in SPLITS, f"split={split} not in {SPLITS}")
    return FlashPlan(split, block_k, stages, ctas,
                     (_cdiv(Sq, BLOCK_Q) * split, H, B))


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool = True,
                         window: Optional[int] = None,
                         q_offset: int = 0,
                         plan: Optional[FlashPlan] = None) -> torch.Tensor:
    """Launch B4.  q [B, Sq, H, dh], k/v [B, Sk, K, dh], float32 or
    bfloat16 alike, dh in HEAD_DIMS, H a multiple of K; any strides whose
    head dim is contiguous and whose rows start 16-byte aligned.  Query
    row i sits at position q_offset + i.  Returns o [B, Sq, H, dh] in q's
    dtype.  `plan` forces a `choose_flash_plan` result (its split; the
    instance is fixed by dh and dtype).  Checks device, dtype, shape,
    strides and plan and raises on anything the kernel does not take."""
    _check(q.is_cuda, "tensors must be on a CUDA device")
    _check(q.ndim == 4 and k.ndim == 4 and v.ndim == 4,
           "q, k and v must be [B, S, heads, dh]")
    B, Sq, H, dh = q.shape
    Sk, K = k.shape[1], k.shape[2]
    _check(dh in HEAD_DIMS, f"head dim {dh} not in {HEAD_DIMS}")
    _check(q.dtype in _DTYPES and k.dtype == q.dtype and v.dtype == q.dtype,
           f"q, k, v must all be float32 or all bfloat16, got {q.dtype}, "
           f"{k.dtype}, {v.dtype}")
    _check(tuple(k.shape) == (B, Sk, K, dh) and v.shape == k.shape,
           f"k/v shape {tuple(k.shape)} / {tuple(v.shape)} does not match "
           f"q {tuple(q.shape)}")
    _check(K > 0 and H % K == 0, f"{H} query heads over {K} kv heads")
    _check(Sk > 0, "no keys")
    _check(window is None or window >= 1, f"bad window {window}")
    _check(isinstance(q_offset, int) and q_offset >= 0,
           f"q_offset must be a non-negative int, got {q_offset!r}")
    vec = 16 // q.element_size()
    for name, t in (("q", q), ("k", k), ("v", v)):
        _check(t.device == q.device, f"{name} is not on q's device")
        _check(t.stride(3) == 1 and all(s % vec == 0 for s in t.stride()[:3])
               and t.data_ptr() % 16 == 0,
               f"{name} needs a contiguous head dim and 16-byte aligned "
               f"rows, got strides {t.stride()}")
    _check(max(B, Sq, Sk, H) < 2 ** 31 and Sq + q_offset < 2 ** 31,
           "sizes past int32")
    out = torch.empty((B, Sq, H, dh), dtype=q.dtype, device=q.device)
    if out.numel() == 0:
        return out
    if plan is None:
        plan = choose_flash_plan(B, Sq, Sk, H, causal, window,
                                 _sm_count(q.device.index or 0),
                                 q_offset=q_offset, dh=dh, dtype=q.dtype)
    _check(plan.split in SPLITS
           and plan[1:4] == instance(dh, q.dtype),
           f"plan {plan} does not fit dh={dh} {q.dtype}")
    _check(H <= 65535 and B <= 65535
           and _cdiv(Sq, BLOCK_Q) * plan.split < 2 ** 31,
           "grid past the launch limits")
    rc = entry("kvnand_flash_attention")(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
        B, Sq, Sk, H, K, dh, int(causal), 0 if window is None else window,
        q_offset, int(q.dtype == torch.bfloat16), dh ** -0.5, plan.split,
        torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: CUDA "
                           f"error {rc}")
    launches.value += 1
    return out
