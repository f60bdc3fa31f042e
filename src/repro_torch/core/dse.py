"""Design-space exploration (paper §V-B Fig 15 + Takeaways 1–2).

Enumerates KVNAND variants over die grouping, quantization, model and
context length under flash-capacity constraints (OOM → blank cell), and
returns the latency heatmap + the argmin configuration.  The same DSE
output drives Track-B engine configuration (`recommend_engine_config`):
software-defined reconfiguration on workload change, §V-B.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional

from repro_torch.configs.base import EngineConfig, ModelConfig, get_config
from repro_torch.core import flashsim as fs


@dataclasses.dataclass
class DSEPoint:
    system: str
    g1: int
    g2: int
    wbits: int
    abits: int
    seq: int
    latency: float            # s/token; inf = OOM
    oom: bool
    kv_bits: int = 0          # stored KV page format (0 -> abits)
    capacity: int = 0         # concurrent seq-length contexts (pooled
                              # page allocation, §IV-D — Track-B admission)
    spec_k: int = 0           # draft tokens per verify step (0 = seq.)
    tokens_per_step: float = 1.0  # E[emitted] at the assumed accept rate


# Track-B paged-KV formats as a DSE axis (0 = keep abits-wide KV, the
# bf16 pool); mirrors how the paper's DSE already sweeps weight bits.
KV_FORMATS = {0: "none", 8: "kv8", 4: "kv4"}

# speculation depths swept by the speculation_k axis (0 = sequential)
SPEC_KS = (0, 2, 4, 8)

# split-page attention partition counts swept by the attn_partitions
# axis (1 = monolithic walk); mirrors the engine's resolve_partitions
# auto ladder.
ATTN_PARTITIONS = (1, 4, 16)


def enumerate_configs(total_dies: int = 8, wbits: int = 4, abits: int = 16,
                      kv_bits: int = 0) -> List[fs.SystemConfig]:
    out = []
    for g1 in range(1, total_dies):
        g2 = total_dies - g1
        out.append(fs.kvnand_d(g1, g2, wbits, abits, kv_bits=kv_bits))
    out.append(fs.kvnand_c(total_dies, wbits, abits, kv_bits=kv_bits))
    return out


def sweep(cfg: ModelConfig, seqs, total_dies: int = 8, wbits: int = 4,
          abits: int = 16, kv_bits: int = 0) -> List[DSEPoint]:
    points = []
    for sys in enumerate_configs(total_dies, wbits, abits, kv_bits):
        for seq in seqs:
            oom = fs.is_oom(sys, cfg, seq)
            lat = math.inf if oom else \
                fs.decode_token_latency(sys, cfg, seq).total
            points.append(DSEPoint(
                sys.name, sys.weight_dies,
                sys.kv_dies if sys.kind == "kvnand-d" else 0,
                wbits, abits, seq, lat, oom, kv_bits,
                capacity=fs.pooled_capacity(sys, cfg, seq)))
    return points


def sweep_kv_formats(cfg: ModelConfig, seqs, total_dies: int = 8,
                     wbits: int = 4, abits: int = 16) -> List[DSEPoint]:
    """Full sweep with the KV bit-width axis unlocked (none/kv8/kv4)."""
    points = []
    for kv_bits in KV_FORMATS:
        points += sweep(cfg, seqs, total_dies, wbits, abits, kv_bits)
    return points


def sweep_speculation(cfg: ModelConfig, seqs, total_dies: int = 8,
                      wbits: int = 4, abits: int = 16, kv_bits: int = 0,
                      accept_rate: float = 0.6,
                      spec_ks=SPEC_KS) -> List[DSEPoint]:
    """Sweep with the speculation_k axis unlocked: per-token latency of
    k-draft verify steps at the assumed per-token `accept_rate` (draft
    overhead — span-scaled MACs/softmax traffic — against one weight
    load and one KV walk amortized over E[accepted+1] tokens)."""
    points = []
    for sys in enumerate_configs(total_dies, wbits, abits, kv_bits):
        for seq in seqs:
            oom = fs.is_oom(sys, cfg, seq)
            for k in spec_ks:
                lat = math.inf if oom else fs.spec_decode_token_latency(
                    sys, cfg, seq, k, accept_rate)
                points.append(DSEPoint(
                    sys.name, sys.weight_dies,
                    sys.kv_dies if sys.kind == "kvnand-d" else 0,
                    wbits, abits, seq, lat, oom, kv_bits,
                    capacity=fs.pooled_capacity(sys, cfg, seq),
                    spec_k=k,
                    tokens_per_step=fs.spec_tokens_per_step(
                        k, accept_rate)))
    return points


def heatmap(cfg: ModelConfig, seqs, total_dies: int = 8, wbits: int = 4,
            abits: int = 16, kv_bits: int = 0) -> Dict[str, Dict[int, float]]:
    """{config_name: {seq: latency}} — Fig 15 layout (inf = OOM blank)."""
    grid: Dict[str, Dict[int, float]] = {}
    for p in sweep(cfg, seqs, total_dies, wbits, abits, kv_bits):
        grid.setdefault(p.system, {})[p.seq] = p.latency
    return grid


def best_config(cfg: ModelConfig, seq: int, total_dies: int = 8,
                wbits: int = 4, abits: int = 16,
                kv_bits: int = 0) -> Optional[DSEPoint]:
    pts = [p for p in sweep(cfg, [seq], total_dies, wbits, abits, kv_bits)
           if not p.oom]
    return min(pts, key=lambda p: p.latency) if pts else None


def _system_of(p: DSEPoint) -> fs.SystemConfig:
    """Rebuild the swept SystemConfig a DSEPoint was scored on."""
    if p.system.startswith("KVNAND-D"):
        return fs.kvnand_d(p.g1, p.g2, p.wbits, p.abits,
                           kv_bits=p.kv_bits)
    return fs.kvnand_c(p.g1, p.wbits, p.abits, kv_bits=p.kv_bits)


def recommend_speculation_k(sys: fs.SystemConfig, cfg: ModelConfig,
                            seq: int, accept_rate: float,
                            spec_ks=SPEC_KS,
                            min_speedup: float = 1.05) -> int:
    """Pick the verify span that minimizes expected per-token latency on
    `sys` at the assumed acceptance rate.  Speculation must BEAT
    sequential decode by `min_speedup` to be recommended at all — a
    compute-bound short-context point where the span-scaled MACs eat
    the amortization keeps speculation_k = 0."""
    base = fs.decode_token_latency(sys, cfg, seq).total
    best_k, best_lat = 0, base
    for k in spec_ks:
        if k <= 0:
            continue
        lat = fs.spec_decode_token_latency(sys, cfg, seq, k, accept_rate)
        if lat < best_lat:
            best_k, best_lat = k, lat
    return best_k if base / max(best_lat, 1e-30) >= min_speedup else 0


def recommend_attn_partitions(sys: fs.SystemConfig, cfg: ModelConfig,
                              seq: int,
                              partition_counts=ATTN_PARTITIONS,
                              min_speedup: float = 1.02) -> int:
    """Pick the split-page partition count that minimizes decode latency
    on `sys`.  Each extra partition buys plane-level KV-read concurrency
    but costs one more NPU merge round trip, so short contexts (where
    the walk is already cheap) keep partitions = 1; the split must BEAT
    the monolithic walk by `min_speedup` to be recommended."""
    base = fs.decode_token_latency(sys, cfg, seq).total
    best_p, best_lat = 1, base
    for p in partition_counts:
        if p <= 1:
            continue
        lat = fs.decode_token_latency(sys, cfg, seq, partitions=p).total
        if lat < best_lat:
            best_p, best_lat = p, lat
    return best_p if base / max(best_lat, 1e-30) >= min_speedup else 1


def recommend_overlap(sys: fs.SystemConfig, cfg: ModelConfig, seq: int,
                      host_s: float, *, span: int = 1,
                      min_speedup: float = 1.02) -> bool:
    """Should the serving loop run the overlapped (dispatch N+1 before
    collect N) schedule on `sys`?  `host_s` is the measured per-step
    host overhead (the serving bench derives it from the synchronous
    loop's `device_idle_s / steps`).  Overlap must BEAT the synchronous
    schedule by `min_speedup` to be recommended — when device compute
    dwarfs host work the pipeline's phantom-step and staging complexity
    buys nothing (DESIGN.md §14)."""
    return fs.overlap_speedup(sys, cfg, seq, host_s,
                              span=span) >= min_speedup


def recommend_hot_pages(sys: fs.SystemConfig, cfg: ModelConfig, seq: int,
                        *, slots: int = 1, page_tokens: int = 64,
                        total_pages: int = 0) -> int:
    """Pick `EngineConfig.hot_pages` for a tiered shared pool on `sys`
    (DESIGN.md §13): the NPU-side SRAM staging buffer sized in KV pages
    (`flashsim.hot_tier_pages`), floored at the pinned working set of
    `slots` concurrent seq-length requests — a mapped hot page is never
    demoted, so admission needs at least that many slots to make
    progress.  Returns 0 (single tier) when the whole flash pool
    (`total_pages`, when known) already fits the hot tier: tiering a
    pool that never demotes buys nothing."""
    if slots <= 0:
        raise ValueError(f"slots must be >= 1, got {slots}")
    working_set = slots * -(-seq // page_tokens)
    hot = max(fs.hot_tier_pages(sys, cfg, page_tokens), working_set)
    if total_pages and hot >= total_pages:
        return 0
    return hot


def recommend_engine_config(arch: str, seq: int, *,
                            total_dies: int = 16,
                            allow_kv_quant: bool = True,
                            spec_accept_rate: float = 0.0) -> EngineConfig:
    """Map the Track-A DSE winner onto Track-B engine knobs:

    KVNAND-D winner  -> discrete plan (HG pipelining on)
    KVNAND-C winner  -> compact plan
    W4A16 vs W8A8    -> whichever quantization wins at this context
    kv8/kv4 pages    -> cheapest KV format, but fidelity-guarded: the
                        bandwidth model is monotone in kv_bits (fewer
                        bits never slows it down), so among candidates
                        within `kv_fidelity_margin` of the best latency
                        the WIDEST format wins.  Low-bit KV is only
                        recommended where KV traffic actually dominates
                        (long context), not as a blanket downgrade.
    speculation_k    -> with `spec_accept_rate` > 0 (the workload's
                        measured/assumed draft acceptance — serving
                        tracks it on `RequestOutput`), the span that
                        minimizes expected per-token latency on the
                        winning system (`recommend_speculation_k`);
                        0 / default keeps sequential decode.
    attn_partitions  -> the split-page partition count that minimizes
                        decode latency on the winning system
                        (`recommend_attn_partitions`): long contexts
                        pick a plane-parallel split, short contexts
                        keep the monolithic walk.
    """
    cfg = get_config(arch)
    kv_axis = tuple(KV_FORMATS) if allow_kv_quant else (0,)
    kv_fidelity_margin = 1.05
    candidates = []
    for wbits, abits, quant in ((4, 16, "w4a16"), (8, 8, "w8a8")):
        for kv_bits in kv_axis:
            p = best_config(cfg, seq, total_dies, wbits, abits, kv_bits)
            if p is not None:
                candidates.append((p.latency, p, quant))
    if not candidates:
        # nothing fits the flash budget — compact + max quantization
        return EngineConfig(variant="compact", quant="w4a16",
                            kv_quant="kv4" if allow_kv_quant else "none")
    best_lat = min(c[0] for c in candidates)
    near = [c for c in candidates if c[0] <= best_lat * kv_fidelity_margin]
    _, p, quant = max(near, key=lambda c: (c[1].kv_bits == 0, c[1].kv_bits,
                                           -c[0]))
    variant = "discrete" if p.system.startswith("KVNAND-D") else "compact"
    spec_k = 0
    if spec_accept_rate > 0.0:
        spec_k = recommend_speculation_k(_system_of(p), cfg, seq,
                                         spec_accept_rate)
    attn_parts = recommend_attn_partitions(_system_of(p), cfg, seq)
    return EngineConfig(variant=variant, quant=quant,
                        hg_pipeline=(variant == "discrete"),
                        kv_quant=KV_FORMATS[p.kv_bits],
                        speculation_k=spec_k,
                        attn_partitions=attn_parts)


def best_discrete(cfg: ModelConfig, seq: int, total_dies: int = 8,
                  wbits: int = 4, abits: int = 16) -> Optional[DSEPoint]:
    pts = [p for p in sweep(cfg, [seq], total_dies, wbits, abits)
           if not p.oom and p.system.startswith("KVNAND-D")]
    return min(pts, key=lambda p: p.latency) if pts else None


def takeaways(cfg30b: ModelConfig, cfg70b: ModelConfig) -> Dict[str, bool]:
    """Machine-checkable versions of the paper's Takeaways 1-2.

    Note (DESIGN.md): at bandwidth granularity the optimal discrete split
    equals compact — max(t_w/g1, t_kv/g2) minimized over g1+g2=N gives
    (t_w+t_kv)/N.  The paper's D-beyond-2K preference rests on buffer-
    pressure/reliability effects; what the bandwidth model *does* predict
    (and the paper also states: "optimal configuration reaching 4 dies in
    G2 at 100K") is that the optimal G2 allocation grows with context.
    """
    out = {}
    # T1: the optimal G2 (KV) die allocation grows with context length
    d_short = best_discrete(cfg70b, 1_000, 8, 4, 16)
    d_long = best_discrete(cfg70b, 100_000, 8, 4, 16)
    out["t1_g2_allocation_grows_with_context"] = (
        d_short is not None and d_long is not None
        and d_long.g2 > d_short.g2)
    # T1b: short context — compact or G1-heavy discrete wins
    s_best = best_config(cfg70b, 1_000, 8, 4, 16)
    out["t1_short_ctx_prefers_compact_or_g1heavy"] = (
        s_best is not None and (s_best.system.startswith("KVNAND-C")
                                or s_best.g1 >= s_best.g2))
    # T2: W8A8 optimum is more G1-heavy than W4A16 optimum (30B, 50K)
    p8 = best_discrete(cfg30b, 50_000, 8, 8, 8)
    p4 = best_discrete(cfg30b, 50_000, 8, 4, 16)
    if p8 and p4:
        out["t2_w8a8_more_g1_heavy"] = p8.g1 >= p4.g1
    return out
