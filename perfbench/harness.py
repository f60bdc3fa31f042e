"""One run of one cell: set-up, the measured window, the traced steps,
the comparison, and the result line's numbers.

The window drives the port's normal serving path: `KVNANDServer.submit`
and the synchronous `step()` (the interleaved `ContinuousBatcher`, the
engine's `prefill_chunk` and `decode_step`, the paged pools and kernels
B1 / B2 / B3, greedy sampling), fed by a closed loop of clients
(`traffic.py`).  A token's arrival is the host's clock when the `step()`
that returned it came back.
"""
from __future__ import annotations

import contextlib
import gc
import importlib.util
import sys
import tempfile
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

import numpy as np

from perfbench import check, cost, spec, traffic as traffic_mod, weights

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


@dataclass
class ReqRec:
    uid: int
    req: traffic_mod.Request
    submit_t: float
    arrivals: List[float] = field(default_factory=list)
    tokens: List[int] = field(default_factory=list)
    logprobs: List[float] = field(default_factory=list)
    finish: Optional[str] = None
    finish_t: Optional[float] = None

    @property
    def client(self) -> int:
        return self.req.client


@dataclass
class StepRec:
    t0: float
    t1: float
    decode: List[tuple]        # (context, doc, prefix_len) a decode row
    chunks: List[tuple]        # (start, valid tokens) a prefill chunk
    tokens: int                # tokens that arrived


class Loop:
    """A closed loop: every client keeps one request in the server and
    sends its next when the reply ends."""

    def __init__(self, srv, adapter, traffic, clients: int):
        self.srv, self.ad, self.traffic = srv, adapter, traffic
        self.recs: Dict[int, ReqRec] = {}
        self.done: List[ReqRec] = []
        self.next_k = [0] * clients
        self.first: Dict[int, ReqRec] = {}
        self.steps: List[StepRec] = []
        self.chunk_log: List[tuple] = []
        adapter.record_chunks(srv, self.chunk_log)

    def send(self, req: traffic_mod.Request) -> None:
        uid = self.srv.submit(req.prompt, self.ad.sampling(req.max_new))
        rec = ReqRec(uid, req, time.monotonic())
        self.recs[uid] = rec
        if req.client >= 0 and req.index == 0:
            self.first[req.client] = rec

    def send_next(self, client: int) -> None:
        k = self.next_k[client]
        self.next_k[client] += 1
        self.send(self.traffic.request(client, k))

    def step(self) -> StepRec:
        n_chunks = len(self.chunk_log)
        t0 = time.monotonic()
        events = self.srv.step()
        t1 = time.monotonic()
        decode, arrived, ended = [], 0, []
        for ev in events:
            rec = self.recs[ev.uid]
            if ev.token is not None:
                rec.arrivals.append(t1)
                rec.tokens.append(int(ev.token))
                rec.logprobs.append(float(ev.logprob))
                arrived += 1
                if ev.index >= 1:
                    decode.append((len(rec.req.prompt) + ev.index,
                                   rec.req.doc, rec.req.prefix_len))
            if ev.finish_reason is not None:
                rec.finish, rec.finish_t = ev.finish_reason, t1
                ended.append(rec)
        for rec in ended:
            self.srv.release(rec.uid)
            del self.recs[rec.uid]
            self.done.append(rec)
            if rec.client >= 0:
                self.send_next(rec.client)
        s = StepRec(t0, t1, decode, self.chunk_log[n_chunks:], arrived)
        self.steps.append(s)
        return s

    def all_records(self) -> List[ReqRec]:
        return self.done + list(self.recs.values())


@dataclass
class Run:
    """What the metric readers read (see `metrics/`)."""
    model: Dict[str, Any]
    cell: Dict[str, Any]
    slots: int
    t_open: float
    t_close: float
    setup_s: float
    steps: List[StepRec]
    stats: Dict[str, float]
    records: List[ReqRec]
    weight_bytes: float
    trace: Any = None
    trace_steps: List[StepRec] = field(default_factory=list)
    launches: List[tuple] = field(default_factory=list)

    @property
    def window_s(self) -> float:
        return self.t_close - self.t_open

    def passes(self, steps: List[StepRec]):
        """(FLOPs, bytes) that each engine pass of `steps` needs: its
        prefill chunks, then its decode pass."""
        out = []
        for s in steps:
            out += [cost.chunk_pass(self.model, start, length,
                                    self.weight_bytes)
                    for start, length in s.chunks]
            if s.decode:
                out.append(cost.decode_pass(
                    self.model, [c for c, _, _ in s.decode],
                    self.weight_bytes, shared_tokens(s.decode)))
        return out


def shared_tokens(decode: List[tuple]) -> int:
    """Positions that rows of one decode pass read from a shared prefix,
    beyond the first row that reads each prefix."""
    seen, extra = set(), 0
    for _, doc, plen in decode:
        if doc < 0:
            continue
        if doc in seen:
            extra += plen
        seen.add(doc)
    return extra


def percentile(values: List[float], q: float) -> Optional[float]:
    """The q-th percentile (numpy's linear interpolation); None when
    there are no values."""
    if not values:
        return None
    return float(np.percentile(np.asarray(values, np.float64), q))


def load_reader(name: str) -> Callable:
    path = spec.reader_path(name)
    mod_name = "perfbench.metrics." + name.replace(".", "_")
    sp = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(sp)
    sp.loader.exec_module(mod)
    return mod.read


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name (before the first dot) is
    jax, jaxlib, flax or repro."""
    return sorted({m for m in sys.modules if m.split(".")[0] in FORBIDDEN})


def host_reading() -> tuple:
    """(this process's CPU seconds, the machine's steal and total
    jiffies from /proc/stat, 0 where it cannot be read): read at the
    window's ends, they tell a slow host from a slow program."""
    try:
        with open("/proc/stat") as f:
            v = [int(x) for x in f.readline().split()[1:]]
        steal, total = (v[7] if len(v) > 7 else 0), sum(v[:8])
    except (OSError, ValueError):
        steal, total = 0, 0
    return time.process_time(), steal, total


def log(*a) -> None:
    print(*a, file=sys.stderr, flush=True)


def run_cell(cell: Dict[str, Any], seed: int, seconds: float, trace: bool,
             device: str, t_start: float, *, control: bool = False,
             fault: Optional[Callable] = None,
             tmpdir: Optional[str] = None,
             window_steps: Optional[int] = None) -> Dict[str, Any]:
    """One run of `cell` (a resolved spec: `spec.resolve`).  `t_start`:
    the process's start on `time.monotonic()`'s clock.  `control` serves
    the configuration's lower-precision control (kv8 pages, W8A8 2-D
    projections); `fault(server)` breaks the timed path and
    `window_steps` makes the window that many steps instead of
    `seconds` (tests).
    Returns {"run": Run, "check": {...}, "memory_peak_bytes": ...}."""
    import torch
    from perfbench import adapter
    model, srv_spec = cell["model"], cell["server"]
    slots = srv_spec["batch_slots"]
    t0 = time.monotonic()
    w = weights.draw(model, seed, device)
    log(f"set-up: weights {weights.nbytes(w) / 1e9:.2f} GB drawn in "
        f"{time.monotonic() - t0:.2f} s")
    cfg = adapter.model_config(cell["config_name"], model)
    tree = adapter.params(w, w8a8_2d=control)
    srv = adapter.server(cfg, tree, srv_spec, device,
                         "kv8" if control else "none")
    if fault is not None:
        fault(srv)
    traffic = traffic_mod.Traffic(cell["traffic"], seed, slots,
                                  model["vocab_size"])
    loop = Loop(srv, adapter, traffic, slots)
    if traffic.prefill_documents:
        for req in traffic.warm_requests():
            loop.send(req)
        while loop.recs:
            loop.step()
        log(f"set-up: {len(traffic.docs)} documents prefilled in "
            f"{len(loop.steps)} steps, {time.monotonic() - t_start:.1f} s "
            "from the process's start")
    for c in range(slots):
        loop.send_next(c)
    while not all(c in loop.first and loop.first[c].arrivals
                  for c in range(slots)):
        loop.step()
    sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)
    sync()
    log(f"set-up: steady after {len(loop.steps)} steps, "
        f"{time.monotonic() - t_start:.1f} s from the process's start")
    stats0 = dict(srv.stats)
    n0 = len(loop.steps)
    host0 = host_reading()
    t_open = time.monotonic()
    setup_s = t_open - t_start
    while (len(loop.steps) - n0 < window_steps if window_steps
           else time.monotonic() - t_open < seconds):
        loop.step()
    window = loop.steps[n0:]
    t_close = window[-1].t1
    stats = {k: v - stats0.get(k, 0) for k, v in srv.stats.items()
             if isinstance(v, (int, float))}
    run = Run(model, cell, slots, t_open, t_close, setup_s, window, stats,
              [], weights.nbytes(w))
    cpu, steal, total = (b - a for a, b in zip(host0, host_reading()))
    log(f"window: {len(window)} steps, "
        f"{sum(s.tokens for s in window)} tokens in {run.window_s:.3f} s; "
        f"host: {cpu:.3f} s of this process's CPU, steal "
        f"{100.0 * steal / max(total, 1):.3f}% of the machine's")
    if trace:
        from perfbench import trace as trace_mod
        t0 = time.monotonic()
        first = {}

        @contextlib.contextmanager
        def ranges():
            first["step"] = len(loop.steps)
            with adapter.trace_ranges(srv, run.launches):
                yield

        busy_steps, range_steps = cell["trace_steps"]
        run.trace = trace_mod.capture(loop.step, busy_steps, range_steps,
                                      tmpdir or tempfile.gettempdir(),
                                      ranges)
        run.trace_steps = loop.steps[first["step"]:]
        log(f"trace: busy {run.trace.busy_s:.4f} of "
            f"{run.trace.window_s:.4f} s over {busy_steps} steps; "
            f"{len(run.trace.ops)} device ops in {range_steps} steps with "
            f"ranges; {time.monotonic() - t0:.1f} s")
    peak = (torch.cuda.max_memory_allocated() if device == "cuda" else 0)
    t_end = loop.steps[-1].t1
    run.records = loop.all_records()
    finished = [r for r in run.records
                if r.client >= 0 and r.finish is not None
                and t_open < r.finish_t <= t_end]
    del srv, loop.srv, tree
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()
    sample = check.draw_sample(finished, seed,
                               cell["check"]["sample_tokens"],
                               cell["check"].get("sample_requests", 1))
    t0 = time.monotonic()
    res = check.compare(model, w, sample, srv_spec["prefill_chunk_tokens"],
                        device)
    res["reference_s"] = time.monotonic() - t0
    return {"run": run, "check": res, "memory_peak_bytes": peak}


def result(out: Dict[str, Any], bench: Dict[str, Any], name: str,
           trace: bool, device: str):
    """(the result line, the numbers compared with their limits)."""
    run, chk = out["run"], out["check"]
    metrics = {}
    for m in spec.metrics_for(name, trace, bench):
        v = load_reader(m["name"])(run)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    in_window = [r for r in run.records if r.client >= 0
                 and r.submit_t <= run.t_close
                 and (r.finish_t is None or r.finish_t > run.t_open)]
    failed = sum(1 for r in in_window
                 if r.finish not in (None, "length", "stop", "capacity"))
    limits = run.cell["check"]["limits"]
    checks = {k: {"value": chk[k], "limit": v} for k, v in limits.items()}
    correct = chk["tokens"] > 0 and all(c["value"] <= c["limit"]
                                        for c in checks.values())
    if device == "cuda":
        import torch
        kind, count = torch.cuda.get_device_name(0), run.cell["chips"]
    else:
        kind, count = "cpu", 0
    dev = {"platform": "gpu" if device == "cuda" else "cpu", "kind": kind,
           "count": count, "memory_peak_bytes": out["memory_peak_bytes"]}
    line: Dict[str, Any] = {"correct": bool(correct),
                            "attempted": len(in_window), "failed": failed,
                            "metrics": metrics, "device": dev}
    if trace and run.trace is not None:
        dev["busy_s"] = run.trace.busy_s
        dev["window_s"] = run.trace.window_s
        line["breakdown"] = {"device_ops": run.trace.top_ops(10),
                             "idle_gaps": run.trace.top_gaps(10)}
    checks["tokens_compared"] = {"value": chk["tokens"], "limit": 1}
    log(f"check: {chk['requests']} requests, {chk['tokens']} served tokens "
        f"against the reference in {chk['reference_s']:.1f} s; MoE pairs "
        f"dropped {chk['dropped_pairs']} of {chk['routed_pairs']}; "
        f"tokens off the reference's argmax {chk['mismatch']:.4f}; widest "
        f"logprob error {chk['logprob_err_max']:.6g}")
    line["checks"] = checks
    return line, checks


# -- shared by the metric readers ----------------------------------------

def in_window(run: Run, t: float) -> bool:
    return run.t_open < t <= run.t_close


def itl_ms(run: Run) -> List[float]:
    """Every gap between two consecutive tokens of one request, both of
    which arrived in the window."""
    out = []
    for r in run.records:
        a = r.arrivals
        out += [1e3 * (a[i] - a[i - 1]) for i in range(1, len(a))
                if in_window(run, a[i - 1]) and in_window(run, a[i])]
    return out


def ttft_ms(run: Run) -> List[float]:
    """Submit to first token, of every request whose first token arrived
    in the window."""
    return [1e3 * (r.arrivals[0] - r.submit_t) for r in run.records
            if r.client >= 0 and r.arrivals and in_window(run, r.arrivals[0])]


def launch_passes(run: Run, kind: str) -> List[tuple]:
    """(launch info, pass) of every traced launch of kernel `kind` ("b1",
    "b2", "b3"): the pass is ("chunk", (start, length)) or ("decode",
    rows), matched to the engine calls in launch order."""
    chunks = iter([c for s in run.trace_steps for c in s.chunks])
    decodes = iter([s.decode for s in run.trace_steps if s.decode])
    cur, out = None, []
    for name, info in run.launches:
        if name == "prefill_chunk":
            cur = ("chunk", next(chunks, None))
        elif name == "decode_step":
            cur = ("decode", next(decodes, None))
        elif name == kind and cur is not None and cur[1] is not None:
            out.append((info, cur))
    return out


def roofline_pct(run: Run, bound_s: float, rng: str,
                 name_has: str) -> Optional[float]:
    """100 x bound / device time of the kernels named `name_has` launched
    in range `rng`; None when the trace has none."""
    if run.trace is None:
        return None
    t = run.trace.time_in(rng, name_has)
    if t <= 0 or bound_s <= 0:
        return None
    return 100.0 * bound_s / t
