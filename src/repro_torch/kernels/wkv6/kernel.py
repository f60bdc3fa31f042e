"""CUDA RWKV6 wkv recurrence, kernel B5: plan, bind and launch.

`wkv6_cuda` (`csrc/wkv6.cu`) replaces the TPU kernel
`repro/kernels/wkv6/kernel.py::wkv6_pallas`.  It reads r/k/v/logw in the
model's [B, S, H, dh] layout through their strides (the TPU path pads S
to the chunk and transposes to [B, H, S, dh] first) and masks the ragged
tail of the last chunk itself.  Where the TPU kernel walks the chunks in
order with the state in VMEM, B5 runs a local pass over every chunk at
once (its output without the incoming state, its state delta, on the
tensor cores in float32-exact 3xTF32), then a carry that walks the chunks
with the state on chip and adds each chunk's share of it (see the
source).  Each chunk is factored around a mid-chunk pivot, so B5 stays
finite over the model's whole decay range where the reference's
factorization overflows; `ref.wkv_chunk_parallel` is the same arithmetic
in plain torch.  The source builds into its own library
(`kernels/_build.py`, in parallel with the other kernels, at first use);
importing this module builds nothing and needs neither nvcc nor a card.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels._build import LaunchCount, entry

launches = LaunchCount()          # B5: one per `wkv6_cuda` call

HEAD_DIMS = (16, 32, 64)
MAX_CHUNK = 32


def _check(cond: bool, msg: str):
    if not cond:
        raise ValueError(f"wkv6_cuda: {msg}")


def wkv6_cuda(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              logw: torch.Tensor, u: torch.Tensor, state: torch.Tensor, *,
              chunk: int = MAX_CHUNK) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch B5.  r/k/v/logw [B, S, H, dh] float32 with a contiguous head
    dim (any other strides); u [H, dh] and state [B, H, dh, dh] float32,
    contiguous; dh 16, 32 or 64; chunk 1..32.  Returns (out [B, S, H,
    dh], the state after the last token [B, H, dh, dh]), both float32.
    Checks device, dtype, shape and strides and raises on anything the
    kernel does not take.  The carry's scratch (rs, dS and e^{tot} of
    every chunk) is allocated here, and only when the prompt spans two
    chunks or more."""
    _check(r.is_cuda, "tensors must be on a CUDA device")
    _check(r.ndim == 4, f"r must be [B, S, H, dh], got {tuple(r.shape)}")
    B, S, H, dh = r.shape
    _check(dh in HEAD_DIMS, f"head dim {dh} not in {HEAD_DIMS}")
    _check(isinstance(chunk, int) and 1 <= chunk <= MAX_CHUNK,
           f"chunk must be an int in 1..{MAX_CHUNK}, got {chunk!r}")
    for name, t in (("r", r), ("k", k), ("v", v), ("logw", logw)):
        _check(t.dtype == torch.float32, f"{name} must be float32, got "
               f"{t.dtype}")
        _check(tuple(t.shape) == (B, S, H, dh), f"{name} shape "
               f"{tuple(t.shape)} does not match r {tuple(r.shape)}")
        _check(t.device == r.device, f"{name} is not on r's device")
        _check(t.stride(3) == 1, f"{name} needs a contiguous head dim, got "
               f"strides {t.stride()}")
    for name, t, shape in (("u", u, (H, dh)), ("state", state, (B, H, dh, dh))):
        _check(t.dtype == torch.float32 and tuple(t.shape) == shape
               and t.is_contiguous() and t.device == r.device,
               f"{name} must be a contiguous float32 {shape} on r's device, "
               f"got {t.dtype} {tuple(t.shape)} strides {t.stride()}")
    n = -(-S // chunk)
    _check(n < 2 ** 31 and max(H, B) < 2 ** 16, "sizes past the grid")
    out = torch.empty((B, S, H, dh), dtype=torch.float32, device=r.device)
    sT = torch.empty((B, H, dh, dh), dtype=torch.float32, device=r.device)
    if B * H == 0:
        return out, sT
    scratch = []                  # rs, dS, e^{tot}: held until the launch
    if n >= 2:
        scratch = [torch.empty(shape, dtype=torch.float32, device=r.device)
                   for shape in ((B, H, n, chunk, dh), (B, H, n, dh, dh),
                                 (B, H, n, dh))]
    rc = entry("kvnand_wkv6")(
        r.data_ptr(), k.data_ptr(), v.data_ptr(), logw.data_ptr(),
        u.data_ptr(), state.data_ptr(), out.data_ptr(), sT.data_ptr(),
        *([t.data_ptr() for t in scratch] or [None] * 3),
        *r.stride()[:3], *k.stride()[:3], *v.stride()[:3],
        *logw.stride()[:3], B, S, H, dh, chunk,
        torch.cuda.current_stream(r.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"wkv6 kernel launch failed: CUDA error {rc}")
    launches.value += 1
    return out, sT
