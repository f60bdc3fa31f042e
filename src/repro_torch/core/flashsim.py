"""Analytical flash-system simulator — the paper's evaluation methodology.

Models per-token single-batch decode latency + energy for the four systems
of §V-A, parameterized exactly by Table I:

  Base-1     weight-only IFC (8 dies) + KV in LPDDR5X DRAM (8 ch × 8 GB/s),
             Logit/Attend on the NPU (Lincoln-scaled).
  Base-2     Base-1 with DRAM naively replaced by plain NAND (KV over the
             ONFI 4.8 GB/s external interface).
  KVNAND-D-(G1+G2)  weights on G1 IFC dies, KV on G2 IFC dies; head-group
             pipelining overlaps QKV-gen (G1) with Logit/Attend (G2).
  KVNAND-C-n weights + KV co-located on n IFC dies; phases serialize
             (internal-bandwidth contention) but use all dies.

Removing DRAM lets each channel host a second flash die at cost parity, so
the default KVNAND configs have 16 dies vs Base-1's 8 (paper §V-A).

Validation anchors (asserted in tests/test_flashsim.py):
  * Mixtral-8×7B KV/token = 128 KB (§III-B)
  * naive KV read at 1K ctx ≈ 6.9 ms; FFN read ≈ 44 ms (§III-B)
  * OOM: Base-1 at 100K ctx for all models; GQA models exhaust DRAM ≈ 50K
  * HG-pipelining ablation ≈ 82% latency at 10K (Fig 14a)
  * page-mapping ablation: attention-read time collapses at 100K (Fig 14b)
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict

from repro_torch.configs.base import ModelConfig

GB = 1e9
NPU_ROUNDTRIP = 4e-6   # IFC↔NPU softmax exchange latency per head group


# ---------------------------------------------------------------------------
# Hardware (Table I)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class FlashDie:
    page_bytes: int = 4096
    ecc_bytes: int = 448
    pages_per_block: int = 768
    blocks_per_plane: int = 177
    planes: int = 32
    tR: float = 4e-6
    tP: float = 75e-6
    fmacs_per_plane: int = 16        # KVNAND dies (2 suffices for W-GEMV)
    clock: float = 400e6
    ext_bw: float = 4.8e9            # ONFI 6.0
    e_read: float = 3e-12            # J/bit internal read
    e_prog: float = 7.5e-12
    e_io: float = 4.9e-12            # J/bit interface

    @property
    def int_bw(self) -> float:       # 32 planes × 4KB / 4µs = 32 GB/s
        return self.planes * self.page_bytes / self.tR

    @property
    def prog_bw(self) -> float:      # 32 planes × 4KB / 75µs ≈ 1.75 GB/s
        return self.planes * self.page_bytes / self.tP

    @property
    def mac_rate(self) -> float:     # MAC/s per die
        return self.planes * self.fmacs_per_plane * self.clock

    capacity_bits: float = 132.75e9  # Table I: 132.75 Gb per die

    @property
    def capacity(self) -> float:     # ≈ 16.6 GB
        return self.capacity_bits / 8


@dataclass(frozen=True)
class NPU:
    tops: float = 32e12              # BF16
    power: float = 4.60              # W
    sram_kv_buffer: int = 5 << 20    # KVNAND-D SoC buffer
    sram_power: float = 0.36


@dataclass(frozen=True)
class DRAM:
    bw_per_channel: float = 8e9      # LPDDR5X
    channels: int = 8
    capacity: float = 16 * GB        # 8 × 16 Gb
    # §VI: DRAM also hosts system software + embeddings; 0.4 usable for KV
    # reproduces BOTH textual OOM claims (GQA models exhaust ≈50K; all
    # models OOM at 100K)
    usable_fraction: float = 0.4
    e_bit: float = 7e-12

    @property
    def bw(self) -> float:
        return self.bw_per_channel * self.channels

    @property
    def usable(self) -> float:
        return self.capacity * self.usable_fraction


@dataclass(frozen=True)
class SystemConfig:
    name: str
    kind: str                        # "base1" | "base2" | "kvnand-d" | "kvnand-c"
    weight_dies: int = 8
    kv_dies: int = 8                 # G2 (kvnand-d) / plain NAND (base2)
    wbits: int = 4                   # W4A16 default
    abits: int = 16
    hg_pipeline: bool = True         # kvnand-d dataflow optimization
    page_mapping: bool = True        # §IV-D scheme
    die: FlashDie = FlashDie()
    npu: NPU = NPU()
    dram: DRAM = DRAM()
    kv_bits: int = 0                 # KV page format; 0 -> abits (bf16-ish)

    @property
    def kv_bits_eff(self) -> int:
        """Stored KV bits: the Track-B kv8/kv4 page formats, else abits."""
        return self.kv_bits or self.abits

    @property
    def total_ifc_dies(self) -> int:
        if self.kind == "kvnand-c":
            return self.weight_dies           # co-located
        if self.kind == "kvnand-d":
            return self.weight_dies + self.kv_dies
        return self.weight_dies


def base1(wbits=4, abits=16) -> SystemConfig:
    return SystemConfig("Base-1", "base1", 8, 8, wbits, abits)


def base2(wbits=4, abits=16) -> SystemConfig:
    return SystemConfig("Base-2", "base2", 8, 8, wbits, abits)


def kvnand_d(g1=8, g2=8, wbits=4, abits=16, hg=True, mapping=True,
             kv_bits=0):
    name = f"KVNAND-D-({g1}+{g2})"
    if kv_bits:
        name += f"-kv{kv_bits}"
    return SystemConfig(name, "kvnand-d", g1, g2,
                        wbits, abits, hg, mapping, kv_bits=kv_bits)


def kvnand_c(n=16, wbits=4, abits=16, mapping=True, kv_bits=0):
    name = f"KVNAND-C-{n}" + (f"-kv{kv_bits}" if kv_bits else "")
    return SystemConfig(name, "kvnand-c", n, n, wbits, abits,
                        True, mapping, kv_bits=kv_bits)


# ---------------------------------------------------------------------------
# Workload terms
# ---------------------------------------------------------------------------

def weight_bytes(cfg: ModelConfig, wbits: int) -> Dict[str, float]:
    d = cfg.d_model
    qkv = d * (cfg.q_dim + 2 * cfg.kv_dim)
    o = cfg.q_dim * d
    ffn_mult = 3 if cfg.gated_mlp else 2
    ffn_active = (cfg.top_k if cfg.is_moe else 1) * ffn_mult * d * cfg.d_ff
    ffn_total = ((cfg.n_experts if cfg.is_moe else 1)
                 * ffn_mult * d * cfg.d_ff)
    head = cfg.padded_vocab * d
    b = wbits / 8
    return {
        "qkv": qkv * b, "o": o * b,
        "ffn_active": ffn_active * b, "ffn_total": ffn_total * b,
        "lm_head": head * b,
        "total": (qkv + o + ffn_total) * cfg.n_layers * b + head * b * 2,
    }


def kv_bytes_per_token(cfg: ModelConfig, abits: int) -> float:
    return 2 * cfg.n_layers * cfg.kv_dim * abits / 8


def kv_bytes_layer(cfg: ModelConfig, seq: int, abits: int) -> float:
    return 2 * seq * cfg.kv_dim * abits / 8


# ---------------------------------------------------------------------------
# Latency model
# ---------------------------------------------------------------------------

def _gemv_time(die: FlashDie, n_dies: int, wb: float, wbits: int,
               span: int = 1) -> float:
    """Bandwidth/compute max for a weight GEMV spread over n_dies.

    span > 1 (speculative verification) turns the GEMV into a thin GEMM:
    the weight READ is unchanged — the amortization speculation buys —
    while the MAC count scales with the span.
    """
    if n_dies <= 0:
        return math.inf
    t_read = wb / (n_dies * die.int_bw)
    macs = span * wb * 8 / wbits
    t_mac = macs / (n_dies * die.mac_rate)
    return max(t_read, t_mac)


def _attn_terms(sys: SystemConfig, cfg: ModelConfig, seq: int,
                span: int = 1, partitions: int = 1):
    """Per-layer Logit+Attend (time, transfer_bytes) on the KV medium.

    span > 1: one KV walk serves all span queries (read bytes
    unchanged); Logit/Attend MACs and softmax traffic scale with span.

    partitions > 1 (split-page attention, IFC kinds only): the walk
    emits a locally-normalized partial per partition, so the NPU's
    softmax/exchange stream for partition i overlaps the dies' walk of
    partition i+1 instead of serializing after the full walk — all but
    the last partition's softmax traffic hides under the walk (to the
    extent the walk is long enough to hide it), at the cost of one
    extra NPU merge round trip per partial (`merge_partials`).  Long
    contexts (walk-bound) win; short contexts pay the merge trips for
    nothing, which is what drives `recommend_attn_partitions` to 1.
    """
    die, npu = sys.die, sys.npu
    kvb = kv_bytes_layer(cfg, seq, sys.kv_bits_eff)   # K+V bytes
    macs = span * 2 * cfg.n_heads * seq * cfg.d_head  # logit + attend
    # softmax traffic: logits to NPU and probs back (KVNAND), h×seq each
    sm_bytes = span * 2 * cfg.n_heads * seq * sys.abits / 8

    if sys.kind == "base1":
        t = kvb / sys.dram.bw + 2 * macs / npu.tops
        return t, kvb                               # KV crosses to the NPU
    if sys.kind == "base2":
        t = kvb / (sys.kv_dies * die.ext_bw) + 2 * macs / npu.tops
        return t, kvb
    # IFC attention (kvnand-c/d)
    n = sys.kv_dies if sys.kind == "kvnand-d" else sys.weight_dies
    read_amp = 1.0 if sys.page_mapping else _no_mapping_amplification(
        sys, cfg)
    t_read = kvb * read_amp / (n * die.int_bw)
    t_mac = macs / (n * die.mac_rate)
    # per-head-group NPU softmax round trip (logits out, probs back):
    # k serialized Logit→softmax→Attend exchanges per layer (Fig 10)
    t_sm = (sm_bytes / (n * die.ext_bw)
            + cfg.n_kv_heads * NPU_ROUNDTRIP
            + (span * cfg.n_heads * seq) / npu.tops)
    t_walk = max(t_read, t_mac)
    if partitions > 1:
        # first partition's softmax cannot start before its walk ends
        # and the last partition's cannot overlap anything, so at most
        # (P-1)/P of either stream hides under the other.
        hidden = (partitions - 1) / partitions * min(t_sm, t_walk)
        return (t_walk + t_sm - hidden
                + (partitions - 1) * NPU_ROUNDTRIP), sm_bytes
    return t_walk + t_sm, sm_bytes


def _no_mapping_amplification(sys: SystemConfig, cfg: ModelConfig) -> float:
    """Without §IV-D mapping each 256 B KV unit costs a whole page read
    (+ECC) and random plane conflicts break the multi-plane pipeline
    (calibrated queueing factor 3×, cf. Fig 14b)."""
    unit = cfg.d_head * sys.kv_bits_eff / 8
    page = sys.die.page_bytes + sys.die.ecc_bytes
    return (page / unit) * 3.0


def _kv_write_time(sys: SystemConfig, cfg: ModelConfig) -> float:
    """Per-token KV append, amortized over buffered page-sized flushes."""
    b = kv_bytes_per_token(cfg, sys.kv_bits_eff)
    if sys.kind == "base1":
        return b / sys.dram.bw
    n = sys.kv_dies if sys.kind != "kvnand-c" else sys.weight_dies
    return b / (n * sys.die.prog_bw)


@dataclass
class Breakdown:
    qkv: float = 0.0
    attention: float = 0.0
    o_proj: float = 0.0
    ffn: float = 0.0
    lm_head: float = 0.0
    kv_write: float = 0.0
    transfer: float = 0.0
    overlap_saved: float = 0.0

    @property
    def total(self) -> float:
        return (self.qkv + self.attention + self.o_proj + self.ffn
                + self.lm_head + self.kv_write + self.transfer
                - self.overlap_saved)


def _step_breakdown(sys: SystemConfig, cfg: ModelConfig, seq: int,
                    span: int, kv_writes: float,
                    partitions: int = 1) -> Breakdown:
    """One decode/verify step over `span` tokens writing `kv_writes`
    tokens' KV (sequential decode: span = kv_writes = 1)."""
    die = sys.die
    wb = weight_bytes(cfg, sys.wbits)
    L = cfg.n_layers
    n_w = sys.weight_dies

    b = Breakdown()
    b.qkv = L * _gemv_time(die, n_w, wb["qkv"], sys.wbits, span)
    b.o_proj = L * _gemv_time(die, n_w, wb["o"], sys.wbits, span)
    b.ffn = L * _gemv_time(die, n_w, wb["ffn_active"], sys.wbits, span)
    b.lm_head = _gemv_time(die, n_w, wb["lm_head"], sys.wbits, span)
    t_attn, xfer = _attn_terms(sys, cfg, seq, span, partitions)
    b.attention = L * t_attn
    b.kv_write = kv_writes * _kv_write_time(sys, cfg)
    # activation vectors NPU<->IFC each layer (q, o, ffn in/out)
    act = span * 4 * cfg.d_model * sys.abits / 8
    io_bw = sys.total_ifc_dies * die.ext_bw
    b.transfer = L * (act / io_bw) + L * xfer / max(
        (sys.kv_dies if sys.kind in ("base1", "base2") else
         sys.total_ifc_dies) * die.ext_bw, sys.dram.bw
        if sys.kind == "base1" else 1e-9) * 0.0  # folded into terms above
    if sys.kind == "kvnand-d" and sys.hg_pipeline:
        # Fig 10a: QKV-gen of HG i+1 (G1) overlaps attention of HG i (G2)
        b.overlap_saved = min(b.qkv, b.attention) * (1 - 1 / max(
            cfg.n_kv_heads, 1))
    return b


def decode_token_latency(sys: SystemConfig, cfg: ModelConfig,
                         seq: int, partitions: int = 1) -> Breakdown:
    return _step_breakdown(sys, cfg, seq, span=1, kv_writes=1.0,
                           partitions=partitions)


def decode_throughput(sys: SystemConfig, cfg: ModelConfig,
                      seq: int) -> float:
    if is_oom(sys, cfg, seq):
        return 0.0
    return 1.0 / decode_token_latency(sys, cfg, seq).total


# ---------------------------------------------------------------------------
# Speculative decoding (draft-and-verify) — the speculation_k DSE axis
# ---------------------------------------------------------------------------
#
# A verify step scores k drafted tokens + 1 in one pass: the weight load
# and the KV walk are paid ONCE for up to k+1 emitted tokens — the same
# per-token-traffic lever the paper pulls with in-flash compute, applied
# along the time axis.  The draft overhead is the span-scaled MAC and
# softmax-traffic terms (and the accepted-token KV writes); on a
# bandwidth-bound system those are the cheap side of the max(), which is
# why `recommend_engine_config` trades them off explicitly.

def spec_tokens_per_step(k: int, accept_rate: float) -> float:
    """Expected tokens emitted per verify step with k drafts whose
    per-token acceptance probability is `accept_rate` (geometric prefix
    acceptance + the guaranteed correction/bonus token):
    E = 1 + a + ... + a^k."""
    if k <= 0:
        return 1.0
    a = min(max(accept_rate, 0.0), 1.0)
    if a >= 1.0:
        return float(k + 1)
    return (1.0 - a ** (k + 1)) / (1.0 - a)


def spec_decode_step_latency(sys: SystemConfig, cfg: ModelConfig,
                             seq: int, k: int,
                             accept_rate: float) -> Breakdown:
    """One draft-and-verify step: span = k+1 queries, one weight load,
    one KV walk, E[accepted+1] KV writes."""
    return _step_breakdown(sys, cfg, seq, span=k + 1,
                           kv_writes=spec_tokens_per_step(k, accept_rate))


def spec_decode_token_latency(sys: SystemConfig, cfg: ModelConfig,
                              seq: int, k: int,
                              accept_rate: float) -> float:
    """Expected per-EMITTED-token latency under k-token speculation;
    k = 0 is exactly `decode_token_latency`."""
    if k <= 0:
        return decode_token_latency(sys, cfg, seq).total
    step = spec_decode_step_latency(sys, cfg, seq, k, accept_rate)
    return step.total / spec_tokens_per_step(k, accept_rate)


# ---------------------------------------------------------------------------
# Capacity / OOM — pooled page allocation (§IV-D FTL mapping)
# ---------------------------------------------------------------------------
#
# Track-B's shared page pool admits by ACTUAL footprint: a request holds
# ceil(seq / page_tokens) pages, not a max_context stripe.  The capacity
# model mirrors that: `is_oom` with a request mix charges the page-rounded
# sum, and `pooled_capacity` answers "how many concurrent seq-length
# contexts fit this flash budget" — the admission number serving_bench
# tracks.

def kv_budget(sys: SystemConfig, cfg: ModelConfig) -> float:
    """Bytes of the KV medium available for cache pages."""
    die_cap = sys.die.capacity
    if sys.kind == "base1":
        return sys.dram.usable
    if sys.kind in ("base2", "kvnand-d"):
        return sys.kv_dies * die_cap
    # compact: weights + KV share all dies
    return sys.weight_dies * die_cap - weight_bytes(
        cfg, sys.wbits)["total"]


def kv_pool_bytes(cfg: ModelConfig, seqs, kv_bits: int,
                  page_tokens: int = 64) -> float:
    """Pooled KV footprint of a request mix: page-rounded per sequence,
    summed — versus the stripe model's len(seqs) × max_context charge."""
    per_tok = kv_bytes_per_token(cfg, kv_bits)
    return sum(-(-int(s) // page_tokens) * page_tokens
               for s in seqs) * per_tok


def is_oom(sys: SystemConfig, cfg: ModelConfig, seq: int,
           seqs=None, page_tokens: int = 64) -> bool:
    """Single-context check by default; with `seqs`, a concurrent request
    mix is charged its POOLED page-rounded footprint instead of the
    per-slot worst case."""
    wb = weight_bytes(cfg, sys.wbits)["total"]
    if wb > sys.weight_dies * sys.die.capacity:
        return True
    if seqs is not None:
        kv = kv_pool_bytes(cfg, seqs, sys.kv_bits_eff, page_tokens)
    else:
        kv = kv_bytes_per_token(cfg, sys.kv_bits_eff) * seq
    return kv > kv_budget(sys, cfg)


def pooled_capacity(sys: SystemConfig, cfg: ModelConfig, seq: int,
                    page_tokens: int = 64) -> int:
    """Concurrent seq-length contexts that fit the KV budget under pooled
    allocation (0 when even one does not)."""
    if is_oom(sys, cfg, seq):
        return 0
    per = kv_pool_bytes(cfg, [seq], sys.kv_bits_eff, page_tokens)
    if per <= 0:
        return 10 ** 9        # attention-free: no KV bound
    return int(kv_budget(sys, cfg) // per)


# ---------------------------------------------------------------------------
# Tiered KV hierarchy (DESIGN.md §13): hot-tier staging cost model
# ---------------------------------------------------------------------------
# The serving scheduler's tiered pool keeps `EngineConfig.hot_pages`
# pages staged NPU-side (the SoC SRAM KV buffer of Table I) and leaves
# the rest flash-resident.  These helpers price the tier boundary: what
# one page promotion costs (a flash page-granular read plus the KV bytes
# over the external interface), how many pages the staging buffer holds,
# and the total stall a drain's demand faults charge.  PREFETCHED
# promotions are issued at the end of a step and overlap the next step's
# compute, so only DEMAND faults (`tier_stall_tokens`) are charged.

def kv_page_bytes(cfg: ModelConfig, kv_bits: int,
                  page_tokens: int = 64) -> float:
    """Bytes of one KV page (all layers, K+V) at the stored precision."""
    return kv_bytes_per_token(cfg, kv_bits) * page_tokens


def page_promote_time(sys: SystemConfig, cfg: ModelConfig,
                      page_tokens: int = 64) -> float:
    """Seconds to stage ONE capacity-tier page into the hot tier: a
    page-granular flash read (tR) plus the page's KV bytes over the KV
    medium's external interface, striped over its dies."""
    b = kv_page_bytes(cfg, sys.kv_bits_eff, page_tokens)
    if sys.kind == "base1":
        return b / sys.dram.bw
    n = sys.kv_dies if sys.kind != "kvnand-c" else sys.weight_dies
    return sys.die.tR + b / (n * sys.die.ext_bw)


def hot_tier_pages(sys: SystemConfig, cfg: ModelConfig,
                   page_tokens: int = 64) -> int:
    """Pages of KV the NPU-side SRAM staging buffer holds — the natural
    hot-tier size for this (system, model) pair; 0 when even one page
    overflows the buffer (tiering then needs a device-DRAM-class hot
    tier, which the DRAM-free configs do not have)."""
    b = kv_page_bytes(cfg, sys.kv_bits_eff, page_tokens)
    if b <= 0:
        return 10 ** 9        # attention-free: everything is "hot"
    return int(sys.npu.sram_kv_buffer // b)


def tier_stall_time(sys: SystemConfig, cfg: ModelConfig,
                    demand_faults: int, page_tokens: int = 64) -> float:
    """Modeled wall-clock charged to DEMAND promotions over a drain
    (`stats["tier_stall_tokens"]` × the per-page staging cost);
    prefetched pages are free — their reads hid under compute."""
    return demand_faults * page_promote_time(sys, cfg, page_tokens)


# ---------------------------------------------------------------------------
# Serving step model (DESIGN.md §14): host overhead and overlap
# ---------------------------------------------------------------------------
# A SERVING decode step is device compute plus per-step host work the
# device model cannot see: token emission, finish sweeps, admission and
# page-table bookkeeping.  The synchronous scheduler serializes the two
# (the device idles for the host share every step); the overlapped
# scheduler dispatches step N+1 before collecting step N, so each
# steady-state step costs max(device, host) — classic one-deep software
# pipelining.  `host_s` is measured, not modeled: the serving bench
# derives it from the synchronous loop's host-observed device-idle
# fraction (`stats["device_idle_s"] / steps`).

def serving_step_time(sys: SystemConfig, cfg: ModelConfig, seq: int,
                      host_s: float, *, overlap: bool,
                      span: int = 1, partitions: int = 1) -> float:
    """Seconds per steady-state serving step: device compute for a
    span-wide decode/verify step at context `seq`, serialized with
    (synchronous) or hidden behind (overlapped) `host_s` of host-side
    scheduling work."""
    if host_s < 0:
        raise ValueError(f"host_s must be >= 0, got {host_s}")
    dev = _step_breakdown(sys, cfg, seq, span=span, kv_writes=float(span),
                          partitions=partitions).total
    if overlap:
        return max(dev, host_s)
    return dev + host_s


def overlap_speedup(sys: SystemConfig, cfg: ModelConfig, seq: int,
                    host_s: float, *, span: int = 1,
                    partitions: int = 1) -> float:
    """Synchronous / overlapped steady-state step time: the wall-clock
    factor the pipelined scheduler buys.  Bounded by 2.0 (host and
    device perfectly balanced) and ~1.0 when either side dominates."""
    sync = serving_step_time(sys, cfg, seq, host_s, overlap=False,
                             span=span, partitions=partitions)
    piped = serving_step_time(sys, cfg, seq, host_s, overlap=True,
                              span=span, partitions=partitions)
    return sync / max(piped, 1e-30)


# ---------------------------------------------------------------------------
# Energy model (per decoded token, J)
# ---------------------------------------------------------------------------

def decode_token_energy(sys: SystemConfig, cfg: ModelConfig,
                        seq: int) -> Dict[str, float]:
    die = sys.die
    wb = weight_bytes(cfg, sys.wbits)
    L = cfg.n_layers
    w_read_bits = 8 * (L * (wb["qkv"] + wb["o"] + wb["ffn_active"])
                       + wb["lm_head"])
    kv_bits = 8 * kv_bytes_layer(cfg, seq, sys.kv_bits_eff) * L
    kv_write_bits = 8 * kv_bytes_per_token(cfg, sys.kv_bits_eff)
    act_bits = 8 * 4 * cfg.d_model * sys.abits / 8 * L

    e: Dict[str, float] = {}
    e["weights_read"] = w_read_bits * die.e_read
    if sys.kind == "base1":
        e["kv"] = kv_bits * (sys.dram.e_bit + sys.dram.e_bit)  # read + io
        e["kv_write"] = kv_write_bits * sys.dram.e_bit
    elif sys.kind == "base2":
        e["kv"] = kv_bits * (die.e_read + die.e_io)     # read + ONFI out
        e["kv_write"] = kv_write_bits * (die.e_prog + die.e_io)
    else:
        amp = 1.0 if sys.page_mapping else _no_mapping_amplification(
            sys, cfg)
        e["kv"] = kv_bits * amp * die.e_read            # stays in-die
        sm_bits = 8 * 2 * cfg.n_heads * seq * sys.abits / 8 * L
        e["kv"] += sm_bits * die.e_io                   # softmax traffic
        e["kv_write"] = kv_write_bits * die.e_prog
    e["io"] = act_bits * die.e_io
    lat = decode_token_latency(sys, cfg, seq).total
    e["npu"] = sys.npu.power * 0.15 * lat + sys.npu.sram_power * lat
    n_dies = sys.total_ifc_dies
    logic_w = 6.98e-3 * die.planes                      # per die logic
    e["ifc_logic"] = logic_w * n_dies * lat
    e["total"] = sum(v for k, v in e.items() if k != "total")
    return e
