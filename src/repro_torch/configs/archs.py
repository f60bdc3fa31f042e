"""Imports every per-arch config module so registration side-effects run."""
# Assigned architectures (10)
from repro_torch.configs import dbrx_132b        # noqa: F401
from repro_torch.configs import kimi_k2_1t_a32b  # noqa: F401
from repro_torch.configs import pixtral_12b      # noqa: F401
from repro_torch.configs import qwen1_5_4b       # noqa: F401
from repro_torch.configs import qwen2_5_32b      # noqa: F401
from repro_torch.configs import gemma3_12b       # noqa: F401
from repro_torch.configs import qwen1_5_0_5b     # noqa: F401
from repro_torch.configs import whisper_base     # noqa: F401
from repro_torch.configs import rwkv6_3b         # noqa: F401
from repro_torch.configs import hymba_1_5b       # noqa: F401
# Paper evaluation models (Track A / benchmarks)
from repro_torch.configs import opt_30b          # noqa: F401
from repro_torch.configs import llama2_7b        # noqa: F401
from repro_torch.configs import llama3_1_8b      # noqa: F401
from repro_torch.configs import llama3_1_70b     # noqa: F401
from repro_torch.configs import mixtral_8x7b     # noqa: F401
