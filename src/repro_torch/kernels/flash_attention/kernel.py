"""CUDA flash-attention forward, kernel B4: bind and launch.

`flash_attention_cuda` (`csrc/flash_attention.cu`) replaces the TPU
kernel `repro/kernels/flash_attention/kernel.py::flash_attention_pallas`.
It reads q [B, Sq, H, dh] and k/v [B, Sk, K, dh] in place through their
strides (no transposed or padded copy: the kernel masks the ragged tails
itself, and pads dh to its compute width of 64, 128 or 256 inside shared
memory, where the TPU path pads dh to its 128-wide lanes in copies),
scales q by the unpadded dh^-0.5, accumulates in float32 and writes
o [B, Sq, H, dh] in q's dtype.
The source builds into its own library (`kernels/_build.py`, in parallel
with the other kernels, at first use); importing this module builds
nothing and needs neither nvcc nor a card.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels._build import LaunchCount, entry

launches = LaunchCount()          # B4

_DTYPES = (torch.float32, torch.bfloat16)
# every d_head of the port's configs (the reduced ones are 32)
HEAD_DIMS = (32, 64, 112, 128, 160, 256)


def _check(cond: bool, msg: str):
    if not cond:
        raise ValueError(f"flash_attention_cuda: {msg}")


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool = True,
                         window: Optional[int] = None,
                         q_offset: int = 0) -> torch.Tensor:
    """Launch B4.  q [B, Sq, H, dh], k/v [B, Sk, K, dh], float32 or
    bfloat16 alike, dh in HEAD_DIMS, H a multiple of K; any strides whose
    head dim is contiguous and whose rows start 16-byte aligned.  Query
    row i sits at position q_offset + i.  Returns o [B, Sq, H, dh] in q's
    dtype.  Checks device, dtype, shape and strides and raises on
    anything the kernel does not take."""
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
    rc = entry("kvnand_flash_attention")(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
        B, Sq, Sk, H, K, dh, int(causal), 0 if window is None else window,
        q_offset, int(q.dtype == torch.bfloat16), dh ** -0.5,
        torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: CUDA "
                           f"error {rc}")
    launches.value += 1
    return out
