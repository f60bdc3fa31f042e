"""Roofline terms of a dry-run cell (port of `repro.launch.roofline`).

The counts come from `launch/op_cost.py`, a run of the step on meta
tensors, and are per device:

    compute term    = flops_per_device            / PEAK_FLOPS
    memory term     = bytes_accessed_per_device   / HBM_BW
    collective term = Σ collective payload bytes  / LINK_BW

These are the terms of the eager program the count ran: every op writes
its result to memory, so the memory term grows with the program's
intermediates (and falls as a change removes them).  The least time of
the step's function, the yardstick a measured step is read against, is
`Bound`: the FLOPs and bytes the function itself needs
(`steps.function_cost`: arguments read once, outputs and what the
backward keeps written once; for decode the weights and the live pages
of the cache), over the same peaks.

The constants are one NVIDIA H100 SXM's published dense peaks at its
700 W limit: 989 TFLOP/s of bf16 on the tensor cores, 3.35 TB/s of HBM3,
450 GB/s of NVLink each way, and `HBM_BYTES` = 80 GB of device memory
for the fit check.  A card set below 700 W runs slower under load, so a
measured time is compared with these peaks beside the card's limit.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

PEAK_FLOPS = 989e12        # bf16 dense / card
HBM_BW = 3.35e12           # B/s / card
LINK_BW = 450e9            # B/s / card, NVLink, each way
HBM_BYTES = 80e9           # device memory / card


@dataclasses.dataclass
class Roofline:
    flops: float                 # per device
    bytes_accessed: float        # per device (excl. kernel-fusible)
    fusible_bytes: float         # attention intermediates a kernel keeps
    #                              on chip
    collective_bytes: Optional[float]   # per device; 0 on one device
    #                              (no collective), None on a larger mesh
    collectives: Dict[str, float]
    compute_s: float = 0.0
    memory_s: float = 0.0        # fused-kernel memory term (the roofline)
    memory_raw_s: float = 0.0    # plain-path memory term (incl. fusible)
    collective_s: Optional[float] = 0.0
    bottleneck: str = ""
    model_flops: float = 0.0     # 6·N·D (or 2·N·D decode), global
    useful_ratio: float = 0.0    # model_flops / (flops × chips)

    def finalize(self, chips: int, model_flops: float = 0.0):
        self.compute_s = self.flops / PEAK_FLOPS
        self.memory_s = self.bytes_accessed / HBM_BW
        self.memory_raw_s = (self.bytes_accessed
                             + self.fusible_bytes) / HBM_BW
        terms = {"compute": self.compute_s, "memory": self.memory_s}
        if self.collective_bytes is None:
            self.collective_s = None
        else:
            self.collective_s = self.collective_bytes / LINK_BW
            terms["collective"] = self.collective_s
        self.bottleneck = max(terms, key=terms.get)
        self.model_flops = model_flops
        total = self.flops * chips
        self.useful_ratio = (model_flops / total) if total else 0.0
        return self

    @property
    def eager_bound_s(self) -> float:
        """The least time of the eager program the count ran: its largest
        term (not the step's bound; see `Bound`)."""
        return max(t for t in (self.compute_s, self.memory_s,
                               self.collective_s) if t is not None)

    def to_dict(self):
        return dataclasses.asdict(self)


def analyze(cost, chips: int, model_flops: float = 0.0,
            split: int = 1) -> Roofline:
    """Per-device terms from a `op_cost.CostSummary` of the step.  On one
    device the step runs no collective (term 0).  With `split` > 1 (a
    mesh larger than one device: the port has no SPMD partitioner, so
    the count is the single-device one) FLOPs and bytes are divided
    evenly over `split` devices and the collective term is not counted
    (None)."""
    if split > 1:
        return Roofline(
            flops=cost.flops / split,
            bytes_accessed=cost.bytes_accessed / split,
            fusible_bytes=cost.fusible_bytes / split,
            collective_bytes=None, collectives={},
        ).finalize(chips, model_flops)
    return Roofline(
        flops=cost.flops, bytes_accessed=cost.bytes_accessed,
        fusible_bytes=cost.fusible_bytes, collective_bytes=0.0,
        collectives={},
    ).finalize(chips, model_flops)


@dataclasses.dataclass
class Bound:
    """The least time of a step's function on one device: the larger of
    the FLOPs it needs over PEAK_FLOPS and the bytes it must move over
    HBM_BW (`steps.function_cost`, divided evenly over `split` devices
    on a mesh larger than one, no collective term)."""
    flops: float
    bytes: float
    compute_s: float = 0.0
    memory_s: float = 0.0
    bound_s: float = 0.0
    bound_by: str = ""

    def to_dict(self):
        return dataclasses.asdict(self)


def function_bound(flops: float, nbytes: float, split: int = 1) -> Bound:
    b = Bound(flops / split, nbytes / split)
    b.compute_s = b.flops / PEAK_FLOPS
    b.memory_s = b.bytes / HBM_BW
    b.bound_s = max(b.compute_s, b.memory_s)
    b.bound_by = "operations" if b.compute_s >= b.memory_s else "bytes"
    return b


def memory_summary(cost, argument_bytes: float,
                   temp_split: int = 1) -> Dict[str, float]:
    """Device memory of the step, per device: `argument_bytes` (exact,
    from the arguments' shardings) and `temp_bytes`, the peak of the
    storages the step allocated while it ran (its outputs included),
    divided by `temp_split` (the data-parallel shards of a mesh larger
    than one device).  `total_bytes` = arguments + temp, the peak;
    `fits` compares it with one card's `HBM_BYTES`."""
    temp = cost.peak_bytes / max(temp_split, 1)
    total = argument_bytes + temp
    return {
        "argument_bytes": float(argument_bytes),
        "output_bytes": float(cost.output_bytes / max(temp_split, 1)),
        "temp_bytes": float(temp),
        "alias_bytes": float(cost.alias_bytes),
        "total_bytes": float(total),
        "fits": bool(total <= HBM_BYTES),
    }


def model_flops_estimate(cfg, shape) -> float:
    """6·N_active·D for train; 2·N_active per generated token (+KV reads
    folded into memory, not FLOPs) for decode; 2·N_active·D prefill."""
    n_act = cfg.active_param_count()
    if shape.kind == "train":
        tokens = shape.seq_len * shape.global_batch
        return 6.0 * n_act * tokens
    if shape.kind == "prefill":
        tokens = shape.seq_len * shape.global_batch
        flops = 2.0 * n_act * tokens
        # attention score/attend FLOPs (quadratic part)
        if cfg.n_heads:
            flops += (4.0 * cfg.n_layers * cfg.n_heads * cfg.d_head
                      * shape.seq_len ** 2 * shape.global_batch * 0.5)
        return flops
    # decode: one token per sequence + attention over the KV cache
    flops = 2.0 * n_act * shape.global_batch
    if cfg.n_heads and cfg.family != "ssm":
        flops += (4.0 * cfg.n_layers * cfg.n_heads * cfg.d_head
                  * shape.seq_len * shape.global_batch)
    return flops
