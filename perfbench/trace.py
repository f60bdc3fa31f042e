"""Device trace of a few served steps, and its reduction.  Nothing here
imports the program.

`capture` traces in two phases, each written as a Chrome trace into a
directory it is given, read back and deleted:

  * busy: `torch.profiler` with CUDA activity only (no host op is
    recorded, so the host runs at nearly its own pace) over `busy_steps`
    steps between two marker kernels (`torch.cuda._sleep`, a
    "spin_kernel") launched after a synchronize.  The window runs from
    the first marker's start to the last one's end; busy time is the
    union of the kernel, memcpy and memset intervals inside it, the
    markers left out; the idle share is the rest.
  * ranges: CPU and CUDA activity over `range_steps` steps inside the
    caller's `ranges` context, which opens "perfbench.<name>" ranges
    around the program's entry points.  Each device op is attributed to
    the ranges that contain the host call that launched it (matched by
    the CUPTI correlation id), and each idle gap is named by the
    innermost host operation or range open when it began.  Recording
    every host op slows the host, so this phase's idle share is not
    reported; device times are its own.
"""
from __future__ import annotations

import bisect
import json
import os
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Tuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "python_function")
MARKER = "spin_kernel"


@dataclass
class DeviceOp:
    name: str
    start: float        # microseconds
    dur: float
    ranges: Tuple[str, ...] = ()


@dataclass
class Trace:
    window_s: float                  # busy phase
    busy_s: float                    # busy phase
    top: List[List]                  # busy phase: [name, seconds]
    ops: List[DeviceOp] = field(default_factory=list)     # ranges phase
    gaps: List[Tuple[str, float]] = field(default_factory=list)
    ranges_busy_s: float = 0.0       # ranges phase

    def time_in(self, rng: str, name_has: str = "") -> float:
        """Seconds of device ops launched inside range `rng` (and whose
        name contains `name_has`), in the ranges phase."""
        return sum(o.dur for o in self.ops
                   if rng in o.ranges and name_has in o.name) / 1e6

    def top_ops(self, n: int = 10) -> List[List]:
        return self.top[:n]

    def top_gaps(self, n: int = 10) -> List[List]:
        tot: Dict[str, float] = defaultdict(float)
        for name, s in self.gaps:
            tot[name] += s
        return [[k, v] for k, v in sorted(tot.items(),
                                          key=lambda kv: -kv[1])[:n]]


def _export(prof, tmpdir: str, tag: str) -> List[Dict]:
    path = os.path.join(tmpdir, f"perfbench-{tag}-{os.getpid()}.json")
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            return json.load(f)["traceEvents"]
    finally:
        if os.path.exists(path):
            os.unlink(path)


def capture(step: Callable[[], None], busy_steps: int, range_steps: int,
            tmpdir: str, ranges) -> Trace:
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        torch.cuda._sleep(1000)
        for _ in range(busy_steps):
            step()
        torch.cuda._sleep(1000)
        torch.cuda.synchronize()
    tr = reduce_busy(_export(prof, tmpdir, "busy"))
    with ranges(), profile(activities=[ProfilerActivity.CPU,
                                       ProfilerActivity.CUDA],
                           record_shapes=False, with_stack=False) as prof:
        for _ in range(range_steps):
            with record_function("perfbench.step"):
                step()
        torch.cuda.synchronize()
    reduce_ranges(_export(prof, tmpdir, "ranges"), tr)
    return tr


def _union(ivs: List[Tuple[float, float]], w0: float, w1: float):
    """(busy microseconds, idle gaps) of intervals inside [w0, w1]."""
    ivs = sorted((max(a, w0), min(b, w1)) for a, b in ivs if b > w0 and a < w1)
    busy, gaps, cur = 0.0, [], w0
    for a, b in ivs:
        if a > cur:
            gaps.append((cur, a))
        if b > cur:
            busy += b - max(a, cur)
            cur = b
    if cur < w1:
        gaps.append((cur, w1))
    return busy, gaps


def reduce_busy(events: List[Dict]) -> Trace:
    """The busy phase: window, busy time and the ops taking most time."""
    ops = [(e.get("name", ""), float(e["ts"]), float(e.get("dur", 0.0)))
           for e in events
           if e.get("ph") == "X" and e.get("cat", "") in DEVICE_CATS]
    marks = sorted((ts, ts + dur) for name, ts, dur in ops if MARKER in name)
    work = [o for o in ops if MARKER not in o[0]]
    if not work:
        return Trace(0.0, 0.0, [])
    if len(marks) >= 2:
        w0, w1 = marks[0][0], marks[-1][1]
    else:
        w0 = min(ts for _, ts, _ in work)
        w1 = max(ts + dur for _, ts, dur in work)
    busy, _ = _union([(ts, ts + dur) for _, ts, dur in work], w0, w1)
    tot: Dict[str, float] = defaultdict(float)
    for name, _, dur in work:
        tot[name] += dur / 1e6
    top = [[k, v] for k, v in sorted(tot.items(), key=lambda kv: -kv[1])]
    return Trace((w1 - w0) / 1e6, busy / 1e6, top)


def _host_names(host: List[tuple], points: List[float]) -> List[str]:
    """For each time in `points` (sorted), the innermost host interval
    open then: a sweep over the intervals in start order, keeping the
    open ones on a stack (host ranges of one thread nest)."""
    out, stack, i = [], [], 0
    for t in points:
        while i < len(host) and host[i][0] <= t:
            while stack and stack[-1][1] < host[i][0]:
                stack.pop()
            stack.append(host[i])
            i += 1
        while stack and stack[-1][1] < t:
            stack.pop()
        out.append(stack[-1][2] if stack else "no host op")
    return out


def _tags(ranges: List[tuple], starts: List[float], t: float):
    """Names of the "perfbench.<name>" ranges containing time t."""
    j = bisect.bisect_right(starts, t) - 1
    tags = []
    for i in range(j, max(j - 3, -1), -1):
        if ranges[i][1] >= t:
            tags.append(ranges[i][2])
    return tuple(tags)


def reduce_ranges(events: List[Dict], tr: Trace) -> Trace:
    """The ranges phase, into `tr`: device ops tagged with the ranges
    that launched them, idle gaps named by the host."""
    steps, ranges, host, launch_ts, dev = [], [], [], {}, []
    for e in events:
        if e.get("ph") != "X":
            continue
        cat, name = e.get("cat", ""), e.get("name", "")
        ts, dur = float(e["ts"]), float(e.get("dur", 0.0))
        if cat in DEVICE_CATS:
            dev.append((name, ts, dur,
                        (e.get("args") or {}).get("correlation")))
        elif cat in ("cuda_runtime", "cuda_driver"):
            corr = (e.get("args") or {}).get("correlation")
            if corr is not None:
                launch_ts[corr] = ts
        elif cat in HOST_CATS:
            host.append((ts, ts + dur, name))
            if name == "perfbench.step":
                steps.append((ts, ts + dur))
            elif name.startswith("perfbench."):
                ranges.append((ts, ts + dur, name.split(".", 1)[1]))
    if not steps:
        return tr
    w0, w1 = min(s for s, _ in steps), max(e for _, e in steps)
    ranges.sort()
    starts = [r[0] for r in ranges]
    for name, ts, dur, corr in dev:
        t_launch = launch_ts.get(corr)
        tags = () if t_launch is None else _tags(ranges, starts, t_launch)
        tr.ops.append(DeviceOp(name, ts, dur, tags))
    busy, gaps = _union([(o.start, o.start + o.dur) for o in tr.ops], w0, w1)
    tr.ranges_busy_s = busy / 1e6
    host.sort()
    names = _host_names(host, [a for a, _ in gaps])
    tr.gaps = [(n, (b - a) / 1e6) for n, (a, b) in zip(names, gaps)]
    return tr
