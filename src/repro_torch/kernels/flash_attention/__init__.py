"""Flash attention (prefill): kernel B4, its plain versions and the
dispatching entry point (port of `repro.kernels.flash_attention`), and
B4 under autograd (`FlashAttentionFn`, a torch-op backward)."""
from repro_torch.kernels.flash_attention.autograd import (  # noqa: F401
    FlashAttentionFn,
    flash_attention_backward,
)
from repro_torch.kernels.flash_attention.kernel import (  # noqa: F401
    FlashPlan,
    choose_flash_plan,
    flash_attention_cuda,
    launches,
)
from repro_torch.kernels.flash_attention.ops import flash_attention  # noqa: F401
from repro_torch.kernels.flash_attention.ref import (  # noqa: F401
    dense_attention_ref,
    flash_attention_ref,
)
