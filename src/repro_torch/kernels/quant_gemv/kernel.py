"""CUDA quantized GEMV, kernel B3: plan, bind and launch.

`quant_gemv_cuda` (`csrc/quant_gemv.cu`) replaces the TPU kernel
`repro/kernels/quant_gemv/kernel.py::quant_gemv_pallas`: W4A16
(`f32(Σ bf16(x)·w4) × scale`) and W8A8 (`int32(Σ x8·w8) × scale`, the
caller applies the activation scale).  Unlike the TPU kernel it takes any
M, D and F (the reference asserts multiples of its 512 blocks) and any
alignment of x.  Both of its paths run the product on the tensor cores
with the weights dequantized in registers:

  * the stream path (decode, M up to `STREAM_MAX_M`): 8 or 16 rows of x a
    CTA and deep ring stages of weights, for a weight stream at the card's
    rate;
  * the tile path (the 64-row prefill chunk, and every M past the
    crossover): 64 rows of x a CTA.

`choose_gemv_plan` picks the path, the instance and the splits of D on
the host, so the CPU tests can hold it; the wrapper passes its result
down.  The source builds into its own library (`kernels/_build.py`, in
parallel with the other kernels, at first use); importing this module
builds nothing.
"""
from __future__ import annotations

import functools
from typing import NamedTuple, Optional, Tuple

import torch

from repro_torch.kernels._build import LaunchCount, entry

launches = LaunchCount()          # B3

# (device, stream) -> int32 tickets of the split-D reduction; every launch
# leaves them at zero, so one zeroed buffer per stream serves all launches
_tickets: dict = {}

_SCHEME = {"w4a16": (0, torch.bfloat16, torch.uint8),
           "w8a8": (1, torch.int8, torch.int8)}

# The instances `csrc/quant_gemv.cu` compiles, (warps, kc, stages, ctas) by
# path and scheme: 32 weight columns a warp, kc rows of D a ring stage, and
# the CTAs an SM each is compiled to hold (its register cap).  The stream
# path holds 8 rows of x a CTA, or 16 past 8; the tile path 64.
STREAM = {"w4a16": (4, 256, 4, 2), "w8a8": (4, 128, 4, 2)}
TILE = {"w4a16": (4, 64, 4, 3), "w8a8": (4, 64, 4, 3)}
TILE_ROWS = 64
# The crossover: the largest M that takes the stream path (measured on an
# H100 by `chip_smoke.py`'s crossover timing, PERF.md §6).
STREAM_MAX_M = 16
# the fewest ring stages a split walks
MIN_SPLIT_CHUNKS = 2
# the tile path's splits form one thread-block cluster (portable size)
MAX_CLUSTER = 8


class GemvPlan(NamedTuple):
    path: str                     # "stream" or "tile"
    warps: int                    # 32 weight columns a warp
    rows: int                     # rows of x a CTA
    kc: int                       # rows of D a ring stage
    stages: int
    ctas: int                     # CTAs an SM the instance is built for
    splits: int                   # CTAs that split D (grid.z)
    grid: Tuple[int, int, int]    # (column tiles, row tiles, splits)
    # the splits' partials meet in the cluster's shared memory (tile
    # path), or in a global workspace ordered by tickets (stream path)
    cluster: bool


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def choose_gemv_plan(M: int, D: int, F: int, scheme: str, sms: int = 132,
                     *, path: Optional[str] = None) -> GemvPlan:
    """The path, instance and splits of D for one launch on a card of `sms`
    SMs.  M up to `STREAM_MAX_M` streams, larger M tiles; `path` forces
    one.  D is split over CTAs until the grid fills the SMs with as many
    CTAs as the instance is built to hold,
    each split at least `MIN_SPLIT_CHUNKS` ring stages, and on the tile
    path at most `MAX_CLUSTER` (its splits are one cluster); no split is
    left without a stage of D."""
    _check(scheme in _SCHEME, f"unknown scheme {scheme!r}")
    _check(M >= 1 and D >= 1 and F >= 1, f"bad shape M={M} D={D} F={F}")
    path = path or ("stream" if M <= STREAM_MAX_M else "tile")
    _check(path in ("stream", "tile"), f"unknown path {path!r}")
    if path == "stream":
        warps, kc, stages, ctas = STREAM[scheme]
        rows = 8 if M <= 8 else 16
    else:
        warps, kc, stages, ctas = TILE[scheme]
        rows = TILE_ROWS
    tiles = (_cdiv(F, 32 * warps), _cdiv(M, rows))
    chunks = _cdiv(D, kc)
    want = _cdiv(ctas * sms, tiles[0] * tiles[1])
    splits = _cdiv(chunks, max(_cdiv(chunks, want), MIN_SPLIT_CHUNKS))
    if path == "tile":
        splits = min(splits, MAX_CLUSTER)
    splits = _cdiv(chunks, _cdiv(chunks, splits))      # none left empty
    return GemvPlan(path, warps, rows, kc, stages, ctas, splits,
                    (tiles[0], tiles[1], splits), path == "tile")


def _check(cond: bool, msg: str):
    if not cond:
        raise ValueError(f"quant_gemv_cuda: {msg}")


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def quant_gemv_cuda(x: torch.Tensor, q: torch.Tensor, scale: torch.Tensor,
                    scheme: str, *,
                    plan: Optional[GemvPlan] = None) -> torch.Tensor:
    """Launch B3.  x: [M, D] bfloat16 (w4a16) or int8 (w8a8), rows at any
    stride and alignment; q: [D/2, F] uint8 or [D, F] int8; scale: [F]
    float32 -> out [M, F] float32.  `plan` forces a `choose_gemv_plan`
    result (for tests).  Checks device, dtype, shape and contiguity and
    raises on anything the kernel does not take."""
    _check(scheme in _SCHEME, f"unknown scheme {scheme!r}")
    code, x_dtype, q_dtype = _SCHEME[scheme]
    _check(x.is_cuda, "tensors must be on a CUDA device")
    _check(x.ndim == 2 and x.dtype == x_dtype,
           f"x must be {x_dtype} [M, D], got {x.dtype} {list(x.shape)}")
    M, D = x.shape
    F = q.shape[-1]
    rows = D // 2 if scheme == "w4a16" else D
    _check(scheme != "w4a16" or D % 2 == 0, "w4a16 needs an even D")
    _check(q.ndim == 2 and tuple(q.shape) == (rows, F) and q.dtype == q_dtype
           and q.is_contiguous() and q.device == x.device,
           f"q must be contiguous {q_dtype} [{rows}, F] on x's device, got "
           f"{q.dtype} {list(q.shape)}")
    _check(tuple(scale.shape) == (F,) and scale.dtype == torch.float32
           and scale.is_contiguous() and scale.device == x.device,
           "scale must be contiguous float32 [F] on x's device")
    _check(0 < F < 2 ** 31 and 0 < D < 2 ** 31 and M < 2 ** 31,
           f"bad shape M={M} D={D} F={F}")
    dev = x.device
    out = torch.empty((M, F), dtype=torch.float32, device=dev)
    if M == 0:
        return out
    if x.stride(1) != 1 or (M > 1 and x.stride(0) < D):
        x = x.contiguous()
    ldx = x.stride(0) if M > 1 else D
    es = x.element_size()
    xvec = int(x.data_ptr() % 16 == 0 and ldx * es % 16 == 0)
    qvec = int(q.data_ptr() % 16 == 0 and F % 16 == 0)
    if plan is None:
        plan = choose_gemv_plan(M, D, F, scheme, _sm_count(dev.index or 0))
    stream = torch.cuda.current_stream(dev)
    ws = tickets = None
    if plan.splits > 1 and not plan.cluster:
        # the splits' partials meet in a workspace, ordered by tickets
        ws = torch.empty((plan.splits, M, F), dtype=torch.float32,
                         device=dev)
        tickets = _ticket_buffer(dev, stream, plan.grid[0] * plan.grid[1])
    _raise_on(entry("kvnand_quant_gemv")(
        x.data_ptr(), q.data_ptr(), scale.data_ptr(), out.data_ptr(),
        None if ws is None else ws.data_ptr(),
        None if tickets is None else tickets.data_ptr(), M, D, F, ldx, code,
        plan.warps, plan.rows, plan.kc, plan.stages, plan.ctas, plan.splits,
        int(plan.cluster), xvec, qvec, stream.cuda_stream))
    launches.value += 1
    return out


def _ticket_buffer(dev, stream, n: int) -> torch.Tensor:
    """At least `n` zeroed tickets for launches on `stream`, allocated (and
    zeroed) only when a larger grid first needs them."""
    key = (dev, stream.cuda_stream)
    buf = _tickets.get(key)
    if buf is None or buf.numel() < n:
        buf = _tickets[key] = torch.zeros(max(n, 4096), dtype=torch.int32,
                                          device=dev)
    return buf


def _raise_on(rc: int):
    if rc != 0:
        raise RuntimeError(f"quant_gemv kernel launch failed: CUDA error "
                           f"{rc}")
