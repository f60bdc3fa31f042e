"""Reliability model (paper §III-D, §V-D, Fig 5a; a copy of
`repro.core.reliability`, which the port never imports).

Tracks per-block cumulative page reads (read disturb) and P/E cycles for
flash-resident KV under a decode workload, and quantifies how KVNAND's
mapping/parallelization reduce PGRD stress:

  * KVNAND-C head-parallel generation: per-block reads drop by
    ≈ k·page/KVbuf  (~128× in the paper's config)
  * KVNAND-D weight/KV die separation: ≈ 2560× total reduction
  * §V-D endurance: 65B @ 3 tok/s for 5 years ≈ 143 TB KV ≈ 1K P/E cycles
    (SLC budget 100K)

Also reproduces Fig 5(a)'s shape: blocks holding EARLY context accumulate
reads ∝ remaining output length; late blocks stay far below the disturb
limit.  Access-aware allocation (§IV-D) randomizes blocks across requests
and retires blocks at the read-disturb limit (trading spare capacity).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np

from repro_torch.configs.base import ModelConfig
from repro_torch.core.flashsim import FlashDie, SystemConfig

READ_DISTURB_LIMIT = 1e6          # intrinsic page-read limit per block [83]
SLC_PE_BUDGET = 100_000           # P/E endurance [2]


@dataclasses.dataclass
class WearState:
    page_reads: np.ndarray        # [blocks]
    pe_cycles: np.ndarray         # [blocks]
    retired: np.ndarray           # [blocks] bool

    @property
    def max_reads(self) -> float:
        return float(self.page_reads[~self.retired].max(initial=0.0))


def kv_pages_per_request(cfg: ModelConfig, ctx: int, abits: int,
                         die: FlashDie) -> int:
    kv_bytes = 2 * cfg.n_layers * cfg.kv_dim * abits / 8 * ctx
    return int(np.ceil(kv_bytes / die.page_bytes))


def simulate_request_reads(cfg: ModelConfig, n_input: int, n_output: int,
                           abits: int, die: FlashDie,
                           pages_per_block: int = 768) -> np.ndarray:
    """Per-block page-read counts for ONE request (Fig 5a).

    Token t's KV pages are read once per subsequent generated token, so a
    block holding tokens [a, b) accumulates Σ_{t∈[a,b)} (n_total - max(t,
    n_input)) reads across its pages.
    """
    n_total = n_input + n_output
    unit = cfg.d_head * abits / 8
    units_per_page = max(int(die.page_bytes // unit), 1)
    # head-major mapping: pages hold contiguous tokens of one (layer, head)
    tokens = np.arange(n_total)
    reads_per_token = (n_total - np.maximum(tokens, n_input)).clip(min=0)
    n_pages_tok = int(np.ceil(n_total / units_per_page))
    page_reads = np.add.reduceat(
        reads_per_token,
        np.arange(0, n_total, units_per_page))[:n_pages_tok]
    # blocks of consecutive pages
    n_blocks = int(np.ceil(n_pages_tok / pages_per_block))
    block_reads = np.zeros(n_blocks)
    for b in range(n_blocks):
        block_reads[b] = page_reads[b * pages_per_block:
                                    (b + 1) * pages_per_block].max(initial=0)
    return block_reads


def pgrd_reduction_factors(cfg: ModelConfig, sys: SystemConfig,
                           abits: int = 16) -> Dict[str, float]:
    """§V-D: mapping + parallelization PGRD reduction factors.

    KVNAND-C: head-parallel generation spreads one (layer, head)'s stream
    across planes — per-block reads drop ≈ k·page_size/KV_size_unit
    (paper: ≈128× at k=8, 256 B units).  KVNAND-D additionally removes
    weight-read interference from KV blocks and stripes KV over dedicated
    G2 dies — paper reports ≈2560× (=128×20); the ×20 die-separation
    factor is adopted from §V-D (weight reads dominate block accesses
    ~20:1 at the 50K-context workload)."""
    die = sys.die
    unit = cfg.d_head * abits / 8
    c_factor = cfg.n_kv_heads * die.page_bytes / unit
    d_factor = c_factor * 20.0
    return {"kvnand_c": c_factor, "kvnand_d": d_factor}


def lifetime_pe_cycles(cfg: ModelConfig, *, tok_per_s: float = 3.0,
                       years: float = 5.0, abits: int = 16,
                       n_dies: int = 8, die: Optional[FlashDie] = None
                       ) -> Dict[str, float]:
    """§V-D endurance check: total KV written over the device lifetime."""
    if die is None:
        die = FlashDie()
    seconds = years * 365 * 24 * 3600
    kv_per_tok = 2 * cfg.n_layers * cfg.kv_dim * abits / 8
    total_bytes = kv_per_tok * tok_per_s * seconds
    capacity = n_dies * die.capacity
    pe = total_bytes / capacity
    return {"total_tb": total_bytes / 1e12, "pe_cycles": pe,
            "budget": SLC_PE_BUDGET,
            "margin_ok": pe < SLC_PE_BUDGET * 0.05}


class BlockAllocator:
    """Access-aware block allocation (§IV-D): randomized across requests,
    read/PE counters per block, migration at limits (trade space for
    reliability)."""

    def __init__(self, n_blocks: int, seed: int = 0):
        self.rng = np.random.default_rng(seed)
        self.state = WearState(np.zeros(n_blocks), np.zeros(n_blocks),
                               np.zeros(n_blocks, bool))

    def allocate(self, n: int) -> np.ndarray:
        free = np.flatnonzero(~self.state.retired)
        order = free[np.argsort(self.state.pe_cycles[free],
                                kind="stable")]
        take = order[:n]
        self.rng.shuffle(take)
        return take

    def record_request(self, blocks: np.ndarray, reads: np.ndarray):
        self.state.page_reads[blocks] += reads[:len(blocks)]
        self.state.pe_cycles[blocks] += 1
        over = self.state.page_reads > READ_DISTURB_LIMIT
        # migrate: reclaim resets reads, costs one P/E
        self.state.pe_cycles[over] += 1
        self.state.page_reads[over] = 0.0
        self.state.retired |= self.state.pe_cycles > SLC_PE_BUDGET

    def utilization(self) -> float:
        return 1.0 - self.state.retired.mean()
