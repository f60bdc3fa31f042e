"""Plain torch quantized GEMV/GEMM (port of
`repro.kernels.quant_gemv.ref.quant_gemv_ref`, op for op).

2-D weights only ([D, F] + per-channel scale [F]).  W4A16 rounds the
product `bf16(x) @ bf16(w)` to bf16 before the scale multiplies it, as the
reference does (the TPU kernel, and kernel B3, accumulate in float32 and
do not round: the two differ by a few 1e-3 of max|y|).  W8A8 quantizes x
per token; its int32 accumulate is taken as a float64 product of the same
integers, which is exact (|acc| <= 127² · D < 2^53) and runs on every
device (torch has no integer matmul on CUDA).
"""
from __future__ import annotations

import torch

from repro_torch.core.quant import (quantize_activations_int8,  # noqa: F401
                                    unpack_int4)


def quant_gemv_ref(x: torch.Tensor, q: torch.Tensor, scale: torch.Tensor,
                   scheme: str) -> torch.Tensor:
    """x: [..., D]; q: [D, F] int8 (w8a8) or [D/2, F] uint8 (w4a16);
    scale: [F] -> [..., F] in x.dtype."""
    if scheme == "w4a16":
        w = unpack_int4(q).to(torch.bfloat16)
        y = torch.einsum("...d,df->...f", x.to(torch.bfloat16), w)
        return (y.float() * scale.float()).to(x.dtype)
    if scheme == "w8a8":
        xq, xs = quantize_activations_int8(x)
        acc = torch.matmul(xq.double(), q.double())
        return (acc.float() * xs * scale.float()).to(x.dtype)
    raise ValueError(scheme)
