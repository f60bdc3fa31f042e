"""The port's hand-written CUDA kernels (B1-B5) and their wrappers.

Every wrapper dispatches by its tensors' device: a CUDA tensor launches
the kernel, a tensor on one of `PLAIN_DEVICES` takes the kernel's plain
torch version — the CPU (the tests), and the meta device (the dry-run,
which counts a step's work without running it and builds nothing).
"""

PLAIN_DEVICES = ("cpu", "meta")
