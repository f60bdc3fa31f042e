"""Public quantized matmul (port of `repro.kernels.quant_gemv.ops`).

`quant_gemv` dispatches by the tensors' device, as the paged-attention
entry points do: a CPU tensor takes the plain version (`ref.py`), a CUDA
tensor launches kernel B3, and there is no fallback between the two.
impl="ref" asks for the plain version on any device (the kernel-free
reference forward uses it).
"""
from __future__ import annotations

import torch

from repro_torch.core.quant import QuantizedWeight, quantize_activations_int8
from repro_torch.kernels.quant_gemv.kernel import quant_gemv_cuda
from repro_torch.kernels.quant_gemv.ref import quant_gemv_ref


def quant_gemv(x: torch.Tensor, qw: QuantizedWeight, *,
               impl: str = "auto") -> torch.Tensor:
    """x: [..., D] @ quantized [D, F] -> [..., F] in x.dtype."""
    if qw.q.ndim != 2:
        raise NotImplementedError(
            f"quant_gemv: expert-batched quantized weights (q of shape "
            f"{tuple(qw.q.shape)}) are not ported yet (ROADMAP A15, MoE)")
    if impl == "auto":
        impl = "ref" if x.device.type == "cpu" else "cuda"
    if impl == "ref":
        return quant_gemv_ref(x, qw.q, qw.scale, qw.scheme)
    if impl != "cuda":
        raise ValueError(f"quant_gemv: unknown impl {impl!r}")
    lead, D = x.shape[:-1], x.shape[-1]
    x2 = x.reshape(-1, D)
    if qw.scheme == "w8a8":
        xq, xs = quantize_activations_int8(x2)
        out = quant_gemv_cuda(xq, qw.q, qw.scale, "w8a8") * xs
    else:
        out = quant_gemv_cuda(x2.to(torch.bfloat16), qw.q, qw.scale,
                              qw.scheme)
    return out.reshape(*lead, qw.q.shape[-1]).to(x.dtype)
