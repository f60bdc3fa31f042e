"""Prometheus-format serving metrics for the HTTP front end (a copy of
`repro.serving.metrics` over the port's `RequestOutput`, which the port
never imports).

`ServingMetrics` aggregates the per-request latency surface
(`RequestOutput.ttft` / `.tpot` over a sliding window) plus lifecycle
counters the HTTP layer owns (finishes by reason, 429 rejections), and
`render()` joins them with the scheduler's live `stats` dict and a few
caller-supplied gauges into the Prometheus text exposition format,
exported live at ``GET /metrics`` (serving/async_server.py).

Everything is stdlib: counters behind one lock (the engine thread
observes finishes, the asyncio thread renders scrapes), quantiles via
`latency_percentile` over a bounded deque.  Metric names and help texts
are the reference's, so a dashboard reads either server.
"""
from __future__ import annotations

import threading
import time
from collections import Counter, deque
from typing import Dict, Optional, Sequence

from repro_torch.serving.api import RequestOutput, latency_percentile

__all__ = ["ServingMetrics"]

_QUANTILES = (50.0, 95.0, 99.0)

# scheduler stats exported verbatim as monotonic counters
_STAT_COUNTERS = (
    ("steps", "kvnand_scheduler_steps_total",
     "Scheduler steps (dispatch/collect pairs) executed"),
    ("decode_tokens", "kvnand_decode_tokens_total",
     "Tokens emitted by decode/verify steps"),
    ("admits", "kvnand_admits_total",
     "Requests admitted into a batch slot"),
    ("prefill_chunks", "kvnand_prefill_chunks_total",
     "Chunked-prefill ticks processed"),
    ("spec_drafted", "kvnand_spec_drafted_total",
     "Draft tokens offered for verification"),
    ("spec_accepted", "kvnand_spec_accepted_total",
     "Draft tokens accepted by verification"),
    ("cow_copies", "kvnand_cow_copies_total",
     "Copy-on-write page forks"),
    ("tier_hit_pages", "kvnand_tier_hit_pages_total",
     "Cached pages mapped while hot-resident (tiered pool)"),
    ("tier_miss_pages", "kvnand_tier_miss_pages_total",
     "Cached pages demand-promoted at admission (tiered pool)"),
    ("tier_stall_tokens", "kvnand_tier_stall_tokens_total",
     "Demand promotions charged as decode stalls (tiered pool)"),
    ("tier_promotes", "kvnand_tier_promotes_total",
     "Capacity-to-hot page promotions (tiered pool)"),
    ("tier_demotes", "kvnand_tier_demotes_total",
     "Hot-to-capacity page demotions (tiered pool)"),
    ("tier_prefetch_pages", "kvnand_tier_prefetch_pages_total",
     "Pages promoted ahead of admission by the prefetch tick"),
    ("phantom_tokens", "kvnand_phantom_tokens_total",
     "Overlapped-pipeline rows discarded at collect (DESIGN.md §14)"),
    ("deadline_drops", "kvnand_deadline_drops_total",
     "Queued requests expired past their deadline"),
)


def _fmt(v: float) -> str:
    """Prometheus float formatting: plain repr, no exponent surprises."""
    return repr(float(v)) if v == v else "NaN"


class ServingMetrics:
    """Sliding-window latency + lifecycle counters, rendered on scrape."""

    def __init__(self, window: int = 1024):
        self._lock = threading.Lock()
        self._ttft = deque(maxlen=window)
        self._tpot = deque(maxlen=window)
        self._finished: Counter = Counter()
        self._rejected = 0
        self._t0 = time.monotonic()

    # -- observation (engine / HTTP threads) ---------------------------
    def observe(self, out: RequestOutput) -> None:
        """Record one finished request."""
        with self._lock:
            self._finished[out.finish_reason] += 1
            if out.ttft is not None:
                self._ttft.append(out.ttft)
            if out.tpot is not None:
                self._tpot.append(out.tpot)

    def observe_rejected(self) -> None:
        """Record one admission rejection (HTTP 429)."""
        with self._lock:
            self._rejected += 1

    # -- rendering (scrape thread) -------------------------------------
    def _summary(self, lines: list, name: str, help_: str,
                 vals: Sequence[float]) -> None:
        lines.append(f"# HELP {name} {help_}")
        lines.append(f"# TYPE {name} summary")
        for q in _QUANTILES:
            lines.append(f'{name}{{quantile="{q / 100:g}"}} '
                         f"{_fmt(latency_percentile(list(vals), q))}")
        lines.append(f"{name}_count {len(vals)}")

    def render(self, stats: Optional[Dict] = None,
               gauges: Optional[Dict[str, float]] = None) -> str:
        """The /metrics payload.  `stats` is the scheduler's live stats
        dict; `gauges` adds caller-computed point-in-time values (e.g.
        ``kvnand_pool_util``, ``kvnand_queue_depth``) exported verbatim
        with a ``kvnand_`` prefix expected already in the key."""
        stats = stats or {}
        with self._lock:
            lines: list = []
            self._summary(lines, "kvnand_ttft_seconds",
                          "Time to first token (sliding window)",
                          list(self._ttft))
            self._summary(lines, "kvnand_tpot_seconds",
                          "Time per output token after the first "
                          "(sliding window)", list(self._tpot))
            lines.append("# HELP kvnand_requests_finished_total "
                         "Finished requests by finish_reason")
            lines.append("# TYPE kvnand_requests_finished_total counter")
            for reason in sorted(self._finished):
                lines.append(
                    f'kvnand_requests_finished_total{{reason="{reason}"}} '
                    f"{self._finished[reason]}")
            lines.append("# HELP kvnand_rejected_total "
                         "Requests rejected with HTTP 429 (backpressure)")
            lines.append("# TYPE kvnand_rejected_total counter")
            lines.append(f"kvnand_rejected_total {self._rejected}")
        for key, name, help_ in _STAT_COUNTERS:
            if key in stats:
                lines.append(f"# HELP {name} {help_}")
                lines.append(f"# TYPE {name} counter")
                lines.append(f"{name} {stats[key]}")
        # derived rates the benches also report
        prompt_pages = stats.get("prompt_pages", 0)
        if prompt_pages:
            lines.append("# HELP kvnand_prefix_hit_rate "
                         "Prompt pages served from the prefix cache")
            lines.append("# TYPE kvnand_prefix_hit_rate gauge")
            lines.append("kvnand_prefix_hit_rate "
                         f"{_fmt(stats.get('prefix_hit_pages', 0) / prompt_pages)}")
        idle = stats.get("device_idle_s")
        if idle is not None:
            elapsed = max(time.monotonic() - self._t0, 1e-9)
            lines.append("# HELP kvnand_device_idle_fraction "
                         "Host-observed fraction of wall time with no "
                         "step in flight (DESIGN.md §14)")
            lines.append("# TYPE kvnand_device_idle_fraction gauge")
            lines.append("kvnand_device_idle_fraction "
                         f"{_fmt(min(idle / elapsed, 1.0))}")
        for name, val in sorted((gauges or {}).items()):
            lines.append(f"# TYPE {name} gauge")
            lines.append(f"{name} {_fmt(val)}")
        return "\n".join(lines) + "\n"
