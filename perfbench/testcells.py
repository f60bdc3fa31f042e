"""Tiny cells for the CPU tests: the cells' shapes of configuration,
traffic and server at a size a test run holds (2 layers, width 128,
4 query heads over 2 kv heads of 32, 4 experts top-2, a 512 vocabulary,
64-token chunks, 4 slots)."""
from __future__ import annotations

import copy
from typing import Any, Dict

# the widest gap a sound tiny run reads on the CPU is a few 1e-3: the
# port's plain quantized GEMV rounds its product to bfloat16 where kernel
# B3, which the reference follows, does not
TINY_GAP_LIMIT = 0.05
# the MoE cell compares what the mixtral cell compares: the median
# logprob error (sound tiny runs read 0.0012-0.0016) and the largest of
# the requests' own medians (0.0014-0.0024), over every request of a
# tiny window's sample
TINY_MOE_LIMITS = {"logprob_err_median": 0.01, "logprob_err_req_max": 0.02}

_MODEL = {"n_layers": 2, "d_model": 128, "n_heads": 4, "n_kv_heads": 2,
          "d_head": 32, "d_ff": 256, "vocab_size": 512, "rope_theta": 1e6,
          "norm_eps": 1e-5, "tie_embeddings": False}

_TRAFFIC = {"name": "tiny", "loop": "closed", "requests_per_client": 8,
            "prompt_tokens": {"dist": "lognormal", "median": 40,
                              "sigma": 0.8, "min": 8, "max": 150},
            "output_tokens": {"dist": "lognormal", "median": 8,
                              "sigma": 0.8, "min": 4, "max": 24},
            "first_request": "residual"}


def cell(moe: bool = False, docs: bool = False) -> Dict[str, Any]:
    model = dict(_MODEL, family="moe" if moe else "vlm")
    if moe:
        # a capacity that drops pairs in the short prompts of a tiny run
        model.update(n_experts=4, top_k=2, capacity_factor=0.75)
    traffic = copy.deepcopy(_TRAFFIC)
    if docs:
        traffic["documents"] = {"count": 2, "tokens": 128,
                                "prefill_in_setup": True}
    server = {"arch": "mixtral-8x7b" if moe else "pixtral-12b",
              "batch_slots": 4, "max_context": 320,
              "prefill_chunk_tokens": 64, "page_tokens": 16,
              "kv_dtype": "bfloat16", "shared_pool": docs}
    if docs:
        server["total_pages"] = 256
    return {"name": "tiny", "chips": 1, "config_name": "tiny",
            "model": model, "traffic": traffic, "server": server,
            "check": ({"sample_tokens": 40, "sample_requests": 4,
                       "limits": dict(TINY_MOE_LIMITS)} if moe else
                      {"sample_tokens": 40,
                       "limits": {"logit_gap": TINY_GAP_LIMIT}}),
            "trace_steps": [2, 1]}
