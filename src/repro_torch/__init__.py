"""PyTorch/CUDA port of the KVNAND serving stack.

Mirrors `repro`'s subpackage layout (`configs/`, `models/`, `core/`,
`kernels/paged_attention/`, `kernels/quant_gemv/`,
`kernels/flash_attention/`, `serving/`, `launch/`) so each module's JAX
counterpart sits at the same relative path.  The package
imports torch, numpy and the standard library only — never jax, never
`repro` — and runs on the CUDA device unless a caller passes
``device="cpu"``.

Decode attention (`csrc/paged_attention.cu`, `paged_attention_shared.cu`),
the quantized W4A16/W8A8 matmuls (`csrc/quant_gemv.cu`) and the one-shot
prefill's flash attention (`csrc/flash_attention.cu`) run in
hand-written CUDA kernels, built with nvcc on first use
(`kernels/_build.py`); everything else is plain torch.  On CPU tensors
each kernel's plain torch version runs instead, which is how the parity
tests against the JAX reference execute without a card.
"""
