"""The port's kvlint — static analysis of `repro_torch` (stdlib `ast`
only), the counterpart of the reference's `repro.analysis`.

The reference's rules key on JAX idioms (`jax.jit` sites, `.at[...].set`,
`pl.pallas_call`); these carry each one over to the port's own:

  TK001  step purity — no host sync (`.item()`, `.cpu()`, `.nonzero()`,
         `int(t)`, `if t:`, a pageable upload, `synchronize()` ...) on a
         tensor in a function reachable from a step root (KV001)
  TK002  stale alias after an in-place step — a local bound to the cache,
         or to a leaf of it, before a step that writes the cache in place
         is not read after it (KV002)
  TK003  build and compile hazards — kernels are built and loaded in
         `kernels/_build.py` only; nothing builds, compiles or captures in
         a loop or on the step's path (KV003)
  TK004  pool-write discipline — every in-place write to a KV pool leaf
         goes through the writers in `core/paged_kv.py` (KV004)
  TK005  kernel hygiene — wrappers dispatch by `PLAIN_DEVICES`, raise on
         a failed launch, count every launch and call no library in a
         kernel's place; CUDA sources state launch bounds, print nothing
         on the device and return `cudaGetLastError()` (KV005)

Run it with ``python -m repro_torch.analysis.kvlint src/repro_torch
chip_smoke.py``; its baseline is `kvlint_torch_baseline.txt`.  The rule
IDs differ from the reference's, so a suppression comment silences one
linter only.  This package imports neither torch nor jax, nor anything
of the reference.
"""
from repro_torch.analysis.core import Finding, run_paths  # noqa: F401
