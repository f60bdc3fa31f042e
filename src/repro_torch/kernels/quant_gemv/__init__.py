"""Quantized GEMV (W4A16 / W8A8): kernel B3, its plain version and the
dispatching entry point (port of `repro.kernels.quant_gemv`)."""
from repro_torch.kernels.quant_gemv.kernel import (  # noqa: F401
    launches,
    quant_gemv_cuda,
)
from repro_torch.kernels.quant_gemv.ops import quant_gemv  # noqa: F401
from repro_torch.kernels.quant_gemv.ref import (  # noqa: F401
    quant_gemv_ref,
    unpack_int4,
)
