"""RWKV6 wkv recurrence: kernel B5, its plain versions and the
dispatching entry point (port of `repro.kernels.wkv6`)."""
from repro_torch.kernels.wkv6.kernel import launches, wkv6_cuda  # noqa: F401
from repro_torch.kernels.wkv6.ops import wkv6  # noqa: F401
from repro_torch.kernels.wkv6.ref import (  # noqa: F401
    wkv_chunk_parallel,
    wkv_chunked,
    wkv_recurrent,
)
