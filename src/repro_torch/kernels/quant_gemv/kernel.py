"""CUDA quantized GEMV, kernel B3: bind and launch.

`quant_gemv_cuda` (`csrc/quant_gemv.cu`) replaces the TPU kernel
`repro/kernels/quant_gemv/kernel.py::quant_gemv_pallas`: W4A16
(`f32(Σ bf16(x)·w4) × scale`) and W8A8 (`int32(Σ x8·w8) × scale`, the
caller applies the activation scale).  Unlike the TPU kernel it takes any
D and F (the reference asserts multiples of its 512 blocks).  The source
builds into its own library (`kernels/_build.py`, in parallel with the
other kernels, at first use); importing this module builds nothing.
"""
from __future__ import annotations

import torch

from repro_torch.kernels._build import LaunchCount, entry

launches = LaunchCount()          # B3

# (device, stream) -> int32 tickets of the split-D reduction; every launch
# leaves them at zero, so one zeroed buffer per stream serves all launches
_tickets: dict = {}

_SCHEME = {"w4a16": (0, torch.bfloat16, torch.uint8),
           "w8a8": (1, torch.int8, torch.int8)}


def _check(cond: bool, msg: str):
    if not cond:
        raise ValueError(f"quant_gemv_cuda: {msg}")


def quant_gemv_cuda(x: torch.Tensor, q: torch.Tensor, scale: torch.Tensor,
                    scheme: str) -> torch.Tensor:
    """Launch B3.  x: [M, D] bfloat16 (w4a16) or int8 (w8a8); q: [D/2, F]
    uint8 or [D, F] int8; scale: [F] float32 -> out [M, F] float32.
    Checks device, dtype, shape and contiguity and raises on anything the
    kernel does not take; a D that is not a multiple of 4 (or a
    misaligned x) costs one zero-padded copy of x."""
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
    ldx = -(-D // 4) * 4
    if ldx != D or not x.is_contiguous() or x.data_ptr() % 16:
        xp = torch.zeros((M, ldx), dtype=x.dtype, device=dev)
        xp[:, :D] = x
        x = xp
    # D is split across CTAs when the column tiles alone cannot fill the
    # card: the splits' partials meet in a workspace, ordered by tickets
    splits = entry("kvnand_quant_gemv_splits")(
        M, D, F, code, torch.cuda.get_device_properties(dev)
        .multi_processor_count)
    stream = torch.cuda.current_stream(dev)
    ws = tickets = None
    if splits > 1:
        ws = torch.empty((splits, M, F), dtype=torch.float32, device=dev)
        tickets = _ticket_buffer(dev, stream, -(-F // 32) * -(-M // 4))
    vec = int(F % 4 == 0 and q.data_ptr() % 4 == 0)
    _raise_on(entry("kvnand_quant_gemv")(
        x.data_ptr(), q.data_ptr(), scale.data_ptr(), out.data_ptr(),
        None if ws is None else ws.data_ptr(),
        None if tickets is None else tickets.data_ptr(), M, D, F, ldx, code,
        splits, vec, stream.cuda_stream))
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
