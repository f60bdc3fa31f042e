"""PyTorch/CUDA port of the KVNAND serving stack.

Mirrors `repro`'s subpackage layout (`configs/`, `models/`, `core/`,
`kernels/paged_attention/`, `serving/`) so each module's JAX counterpart
sits at the same relative path.  The package imports torch, numpy and
the standard library only — never jax, never `repro` — and runs on the
CUDA device unless a caller passes ``device="cpu"``.

Decode attention runs in a hand-written CUDA kernel
(`csrc/paged_attention.cu`), built with nvcc on first use; everything
else is plain torch.  On CPU tensors the kernel's plain torch version
runs instead, which is how the parity tests against the JAX reference
execute without a card.
"""
