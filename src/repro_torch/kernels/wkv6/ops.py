"""Public wkv6 (port of `repro.kernels.wkv6.ops`).

`wkv6` dispatches by the tensors' device, as the port's other kernel
entry points do: a CPU or meta tensor takes the plain chunked form
(`ref.py`, the reference's CPU path), a CUDA tensor launches kernel B5,
and there is no fallback between the two.  impl="ref" (the chunked form) and
impl="recurrent" ask for a plain version on any device; impl="cuda" for
the kernel.  Inputs stay in the model's [B, S, H, dh] layout: B5 reads
them through their strides and masks the ragged tail itself, where the
reference pads S and transposes for its TPU kernel.  r/k/v/logw in any
float dtype (the activation dtype) are upcast to float32 for B5, which
reads float32 only; the output comes back in r's dtype.  B5 has no
backward yet: a CUDA call under autograd raises, naming ROADMAP A18b,
rather than take a plain version on the card.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import PLAIN_DEVICES
from repro_torch.kernels.wkv6.kernel import MAX_CHUNK, wkv6_cuda
from repro_torch.kernels.wkv6.ref import wkv_chunked, wkv_recurrent


def wkv6(r, k, v, logw, u, state, *, impl: str = "auto",
         chunk: int = MAX_CHUNK):
    """r/k/v/logw: [B, S, H, dh]; u: [H, dh]; state: [B, H, dh, dh].

    Returns (out [B, S, H, dh], new_state [B, H, dh, dh] float32)."""
    if impl == "auto":
        impl = "ref" if r.device.type in PLAIN_DEVICES else "cuda"
    if impl == "ref":
        return wkv_chunked(r, k, v, logw, u, state, chunk=chunk)
    if impl == "recurrent":
        return wkv_recurrent(r, k, v, logw, u, state)
    if impl != "cuda":
        raise ValueError(f"wkv6: unknown impl {impl!r}")
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (r, k, v, logw, u, state)):
        raise NotImplementedError(
            "wkv6: kernel B5 has no backward yet, so RWKV6 does not train "
            "on a card (ROADMAP A18b); train it on the CPU")
    # the kernel reads float32, as the reference's kernel upcasts inside;
    # its chunk is clamped as the reference clamps its TPU kernel's
    out, sT = wkv6_cuda(*(a.float() for a in (r, k, v, logw)),
                        u.float().contiguous(), state.float().contiguous(),
                        chunk=min(chunk, MAX_CHUNK))
    return out.to(r.dtype), sT
