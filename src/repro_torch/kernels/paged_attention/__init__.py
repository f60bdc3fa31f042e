from repro_torch.kernels.paged_attention.kernel import (  # noqa: F401
    HEAD_DIMS,
    SPLITS,
    choose_split,
    launches,
    launches_shared,
    paged_attention_cuda,
    paged_attention_shared_cuda,
)
from repro_torch.kernels.paged_attention.merge import (  # noqa: F401
    merge_partials,
    resolve_partitions,
)
from repro_torch.kernels.paged_attention.ops import (  # noqa: F401
    paged_attention_partial,
    paged_chunk_attention,
)
from repro_torch.kernels.paged_attention.ref import (  # noqa: F401
    gather_table_pages,
    paged_attention_partial_ref,
    paged_attention_shared_ref,
    paged_chunk_attention_ref,
)
