"""Public flash attention (port of `repro.kernels.flash_attention.ops`).

`flash_attention` dispatches by the tensors' device, as the port's other
kernel entry points do: a CPU tensor takes the plain version (`ref.py`),
a CUDA tensor launches kernel B4, and there is no fallback between the
two.  impl="ref" asks for the plain version on any device, impl="cuda"
for the kernel.

The reference hands `is_global` (a traced window switch) and a traced
`q_offset` to its jnp path.  Here the plain version takes them on the
CPU; the kernel does not, and a CUDA call with either raises rather than
quietly taking the plain path.  The port's callers loop over layers in
Python and pass each layer's window as an int (None on a global layer),
so a sliding-window arch's one-shot prefill runs the kernel on every
layer.

Under autograd (grad mode on and an input that requires grad) a CUDA
call runs B4 through `FlashAttentionFn` (`autograd.py`), whose backward
is torch ops; the plain version never runs on a card's training path.
A CPU call's plain version is differentiated by autograd itself.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.flash_attention.autograd import FlashAttentionFn
from repro_torch.kernels.flash_attention.kernel import flash_attention_cuda
from repro_torch.kernels.flash_attention.ref import flash_attention_ref


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: Optional[int] = None,
                    q_offset=0, is_global=None,
                    impl: str = "auto") -> torch.Tensor:
    """q [B, Sq, H, dh], k/v [B, Sk, K, dh] -> [B, Sq, H, dh] in q's
    dtype."""
    if impl == "auto":
        impl = "ref" if q.device.type == "cpu" else "cuda"
    if impl == "ref":
        return flash_attention_ref(q, k, v, causal=causal, window=window,
                                   q_offset=q_offset, is_global=is_global)
    if impl != "cuda":
        raise ValueError(f"flash_attention: unknown impl {impl!r}")
    if is_global is not None or isinstance(q_offset, torch.Tensor):
        raise NotImplementedError(
            "flash_attention: a per-layer window switch (is_global) or a "
            "tensor q_offset has no kernel path; pass the layer's window "
            "(None on a global layer) and an int q_offset")
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return FlashAttentionFn.apply(q, k, v, causal, window, q_offset,
                                      flash_attention_cuda)
    return flash_attention_cuda(q, k, v, causal=causal, window=window,
                                q_offset=q_offset)
