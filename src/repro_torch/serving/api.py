"""Request-centric serving API (port of `repro.serving.api`).

`ServerConfig` + `KVNANDServer` stand up the model, the engine and the
continuous-batching scheduler on one device — the CUDA card unless
``ServerConfig.device`` says otherwise — and offer `generate()` for
batch-synchronous use, `submit()` / `step()` / `stream()` for
incremental use, `dispatch()` / `collect()` for a pipelined driver
(`serving/async_server.py`) and `abort()` for cancellation at any
stage.

Entry points set `torch.backends.cuda.matmul.allow_tf32` and
`torch.backends.cudnn.allow_tf32` to False: the reference computes in
float32 (`Runtime.activ_dtype`), and TF32 would keep ~3 decimal digits.

Both pool layouts are served: the per-slot stripe (the default) and the
shared pool with its prefix cache and copy-on-write
(``EngineConfig(shared_pool=True)``), each with bf16/f32 pages or kv8/kv4
codes (``EngineConfig(kv_quant=...)``).  Quantized weights are served as
the reference serves them: the caller passes ``params`` from
`core.quant.quantize_params` (W8A8 or W4A16), and every 2-D quantized
matmul runs in the `quant_gemv` kernel; the server does not quantize on
its own.  Two schedulers: "interleaved" (chunked prefill sharing each
step with the decode batch, the default) and "splice" (the baseline:
one-shot prefill at admit, then a slot splice).  RWKV6
(``arch="rwkv6-3b"``) is served on either scheduler from per-slot
recurrent state instead of a KV pool, its prompts prefilled whole.
Both decode variants of the engine are served (compact, and the discrete
head-group pipeline, ``EngineConfig(variant="discrete")``), and
``ServerConfig.speculation_k`` turns each decode step into a prompt-lookup
draft-and-verify step with the same output tokens (``None`` takes
``EngineConfig.speculation_k``, 0 decodes sequentially; a request caps or
opts out with `SamplingParams.speculation`; `RequestOutput` carries its
acceptance counts).  Sliding-window archs (``arch="gemma3-12b"``) are
served on every path, their local layers from window rings, and so is
the hybrid family (``arch="hymba-1.5b"``: a selective-SSM mixer beside
attention over window rings, a 128-token meta prefix, per-slot SSM
state; speculation refused, as for RWKV6), and the MoE family
(``arch="mixtral-8x7b"``: capacity-based top-2 dispatch over 8 experts,
W4A16 expert weights dequantized per call, as in the reference).  The
VLM family (``arch="pixtral-12b"``) serves as text on every path, as the
reference's does (neither scheduler feeds patch embeddings; the engine's
one-shot prefill takes them).  An encoder-decoder arch
(``arch="whisper-base"``) constructs, and its first step fails where the
reference's does: the interleaved scheduler's chunked prefill refuses it
(ValueError), the splice scheduler's batches carry no frames (KeyError);
its encoder and cross-attention run at the engine level.  A tiered
shared pool (``EngineConfig(hot_pages=...)``) keeps only its hot tier on
the device and stages the rest through a host capacity store, with a
queue-ahead prefetch (``ServerConfig.tier_prefetch``); `RequestOutput`
carries each request's hot-tier hits and stalls.  With
``ServerConfig.overlap`` `stream()` / `run()` / `generate()` dispatch
step N+1 before collecting step N, so the host's emission and
bookkeeping run while the card computes; the tokens are the synchronous
schedule's.  The server runs on one device, as the reference's does; a
device mesh is the engine's (`KVNANDEngine(mesh=...)`).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, Iterator, List, Optional, Sequence, Union

import numpy as np
import torch

from repro_torch.configs.base import EngineConfig, ModelConfig, get_config
from repro_torch.models.registry import Model
from repro_torch.models.transformer import Runtime
from repro_torch.serving.sampler import SamplingParams
from repro_torch.serving.scheduler import (ContinuousBatcher, Request,
                                           SpliceBatcher)

__all__ = ["SamplingParams", "RequestOutput", "StreamEvent",
           "ServerConfig", "KVNANDServer", "latency_percentile",
           "accepted_tokens_per_step"]


def accepted_tokens_per_step(accepted: int, steps: int) -> Optional[float]:
    """Mean tokens emitted per verify step: `steps` spans each emitted
    their accepted drafts plus the correction / bonus token.  None when
    nothing decoded speculatively."""
    if steps == 0:
        return None
    return (accepted + steps) / steps

_SCHEDULERS = {"interleaved": ContinuousBatcher, "splice": SpliceBatcher}


@dataclasses.dataclass(frozen=True)
class ServerConfig:
    """Everything needed to stand up a `KVNANDServer`; `device` is where
    the weights, the KV pool and every kernel live."""
    arch: str = "qwen1.5-0.5b"
    reduced: bool = False           # paper-scale vs CI-scale model dims
    engine: Optional[EngineConfig] = None   # None -> paged ragged default
    scheduler: str = "interleaved"  # "interleaved" | "splice" (baseline)
    batch_slots: int = 4
    max_context: int = 256
    prefill_chunk_tokens: int = 64
    step_token_budget: Optional[int] = None
    seed: int = 0                   # params init + default request streams
    max_steps: int = 100_000        # drain guard for generate()/run()
    speculation_k: Optional[int] = None     # None -> engine.speculation_k
    # tiered pool (EngineConfig.hot_pages > 0): promote the next
    # admission's prefix-hit pages at the end of each step; off, every
    # capacity-tier map-in stalls.  Ignored by single-tier pools
    tier_prefetch: bool = True
    # stream() / run() / generate() dispatch step N+1 before collecting
    # step N (the same tokens; speculation runs synchronously)
    overlap: bool = False
    device: str = "cuda"

    def __post_init__(self):
        if self.scheduler not in _SCHEDULERS:
            raise ValueError(
                f"unknown scheduler {self.scheduler!r}; pick one of "
                f"{sorted(_SCHEDULERS)}")
        if self.speculation_k is not None and self.speculation_k < 0:
            raise ValueError(f"speculation_k must be >= 0, "
                             f"got {self.speculation_k}")


@dataclasses.dataclass(frozen=True)
class StreamEvent:
    """One incrementally generated token of one request.  Every request
    ends with exactly one event carrying `finish_reason`; a request
    aborted without a fresh token gets a marker event with token=None."""
    uid: int
    token: Optional[int]
    index: int
    logprob: Optional[float] = None
    finish_reason: Optional[str] = None


@dataclasses.dataclass
class RequestOutput:
    """A finished request with its timing counters and, under speculative
    decoding, its acceptance counts (`spec_steps` verify steps in which it
    offered drafts, `spec_drafted` drafts offered, `spec_accepted` drafts
    accepted; all 0 under sequential decode).  Under a tiered pool,
    `tier_hit_pages` counts the cached pages it mapped while they were
    hot-resident and `tier_stall_tokens` those it had to promote from the
    capacity tier at admission (0 on single-tier pools)."""
    uid: int
    prompt: List[int]
    token_ids: List[int]
    logprobs: Optional[List[float]]
    finish_reason: str      # stop | length | capacity | aborted | deadline
    submit_time: float
    first_token_time: Optional[float]
    finish_time: float
    spec_steps: int = 0
    spec_drafted: int = 0
    spec_accepted: int = 0
    tier_hit_pages: int = 0
    tier_stall_tokens: int = 0

    @property
    def accepted_tokens_per_step(self) -> Optional[float]:
        """Mean tokens emitted per verify step (accepted drafts + the
        correction / bonus token); None when the request never decoded
        speculatively."""
        return accepted_tokens_per_step(self.spec_accepted,
                                        self.spec_steps)

    @property
    def ttft(self) -> Optional[float]:
        """Time to first token (seconds), None if none was generated."""
        if self.first_token_time is None:
            return None
        return self.first_token_time - self.submit_time

    @property
    def tpot(self) -> Optional[float]:
        """Mean time per output token after the first (seconds)."""
        if self.first_token_time is None or len(self.token_ids) < 2:
            return None
        return ((self.finish_time - self.first_token_time)
                / (len(self.token_ids) - 1))


class KVNANDServer:
    """Facade over model, engine and scheduler construction and the
    request lifecycle.  `cfg` / `params` / `rt` let callers serve a model
    they already built (e.g. weights carried over by `bridge`)."""

    def __init__(self, config: Optional[ServerConfig] = None, *,
                 cfg: Optional[ModelConfig] = None, params=None,
                 rt: Optional[Runtime] = None):
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        self.config = config = config or ServerConfig()
        if cfg is None:
            cfg = get_config(config.arch)
            if config.reduced:
                cfg = cfg.reduced()
        self.cfg = cfg
        rt = rt or Runtime()
        device = torch.device(config.device)
        if params is None:
            gen = torch.Generator(device=device).manual_seed(config.seed)
            params = Model(cfg, rt).init(gen)
        spec_k = config.speculation_k
        if spec_k is None:
            spec_k = (config.engine.speculation_k
                      if config.engine is not None else 0)
        self._batcher = _SCHEDULERS[config.scheduler](
            cfg, params, batch_slots=config.batch_slots,
            max_context=config.max_context, eng=config.engine, rt=rt,
            seed=config.seed,
            prefill_chunk_tokens=config.prefill_chunk_tokens,
            step_token_budget=config.step_token_budget,
            speculation_k=spec_k, tier_prefetch=config.tier_prefetch,
            device=device)
        self._requests: Dict[int, Request] = {}
        self._streamed: Dict[int, int] = {}
        self._done_emitted: set = set()
        self._next_uid = 0

    # -- introspection --------------------------------------------------
    @property
    def stats(self) -> Dict[str, int]:
        return self._batcher.stats

    @property
    def engine(self):
        return self._batcher.engine

    @property
    def params(self):
        return self._batcher.params

    def _busy(self) -> bool:
        b = self._batcher
        return bool(b.queue) or any(r is not None for r in b.slots)

    # -- request lifecycle ----------------------------------------------
    def submit(self, prompt: Sequence[int],
               params: Optional[SamplingParams] = None, *,
               uid: Optional[int] = None, priority: int = 0,
               deadline: Optional[float] = None) -> int:
        """Queue one prompt; returns its uid.  Raises (and records
        nothing) on invalid prompts."""
        if uid is None:
            uid = self._next_uid
        if uid in self._requests:
            raise ValueError(f"uid {uid} already submitted")
        if deadline is not None and deadline <= 0:
            raise ValueError(f"deadline must be > 0 seconds, "
                             f"got {deadline}")
        params = params or SamplingParams()
        req = Request(uid=uid, prompt=list(prompt),
                      max_new=params.max_new_tokens, params=params,
                      priority=priority,
                      deadline_ts=(time.monotonic() + deadline
                                   if deadline is not None else None))
        self._batcher.submit(req)
        self._requests[uid] = req
        self._streamed[uid] = 0
        self._next_uid = max(self._next_uid, uid + 1)
        return uid

    def abort(self, uid: int) -> bool:
        """Cancel a queued or running request (`finish_reason="aborted"`).
        False for unknown/finished uids."""
        req = self._requests.get(uid)
        if req is None or req.done:
            return False
        return self._batcher.abort(uid)

    def step(self) -> List[StreamEvent]:
        """One scheduler step; returns the tokens that became available,
        in submission order, plus terminal markers for aborts."""
        self._batcher.step()
        return self._drain_events()

    def dispatch(self) -> int:
        """Pipelined driver surface: enqueue the next step's device work
        without waiting for its tokens.  Pair every dispatch with a later
        `collect()`; `step()` is the two back to back."""
        return self._batcher.dispatch()

    def collect(self) -> List[StreamEvent]:
        """Wait for the oldest dispatched step and return its events
        (shaped as `step()`'s)."""
        self._batcher.collect()
        return self._drain_events()

    def pending_steps(self) -> int:
        """Dispatched, uncollected scheduler steps."""
        return self._batcher.pending_steps

    def _drain_events(self) -> List[StreamEvent]:
        events: List[StreamEvent] = []
        for uid, req in self._requests.items():
            n0 = self._streamed[uid]
            out = req.output
            done_now = req.done and uid not in self._done_emitted
            if n0 == len(out) and not done_now:
                continue
            want_lp = req.params.logprobs
            for j in range(n0, len(out)):
                last = done_now and j == len(out) - 1
                events.append(StreamEvent(
                    uid=uid, token=out[j], index=j,
                    logprob=req.logprobs[j] if want_lp else None,
                    finish_reason=req.finish_reason if last else None))
            self._streamed[uid] = len(out)
            if done_now:
                if n0 == len(out):      # finished with no fresh token
                    events.append(StreamEvent(
                        uid=uid, token=None, index=len(out),
                        finish_reason=req.finish_reason))
                self._done_emitted.add(uid)
        return events

    def stream(self) -> Iterator[StreamEvent]:
        """Step until every submitted request finishes, yielding each new
        token as its step produces it.  With ``ServerConfig.overlap`` the
        loop dispatches step N+1, then collects step N, so the host work
        behind each yield runs while the card computes the next step;
        each request's events are the same either way (only the
        interleaving across requests may shift by a step)."""
        steps = 0
        if not self.config.overlap:
            while self._busy():
                if steps >= self.config.max_steps:
                    raise RuntimeError(
                        f"stream: max_steps={self.config.max_steps} "
                        "exhausted with requests still pending")
                yield from self.step()
                steps += 1
            yield from self._drain_events()
            return
        if self._busy():
            self._batcher.dispatch()        # prime the pipeline (step 0)
        while self._busy() or self._batcher.pending_steps:
            if steps >= self.config.max_steps:
                raise RuntimeError(
                    f"stream: max_steps={self.config.max_steps} exhausted "
                    "with requests still pending")
            if self._busy():
                self._batcher.dispatch()    # step N+1 onto the card
            yield from self.collect()       # step N's tokens
            steps += 1
        # aborts between steps retire requests without a step: flush
        # their terminal marker events
        yield from self._drain_events()

    def run(self) -> List[StreamEvent]:
        """Drain every pending request; returns all events."""
        return list(self.stream())

    def generate(self, prompts: Sequence[Sequence[int]],
                 params: Union[SamplingParams, Sequence[SamplingParams],
                               None] = None) -> List[RequestOutput]:
        """Submit `prompts` and drain to completion; outputs in prompt
        order.  `params`: one SamplingParams for all, a list, or None."""
        if isinstance(params, SamplingParams) or params is None:
            plist = [params] * len(prompts)
        else:
            plist = list(params)
            if len(plist) != len(prompts):
                raise ValueError(
                    f"{len(plist)} SamplingParams for "
                    f"{len(prompts)} prompts")
        uids = [self.submit(p, sp) for p, sp in zip(prompts, plist)]
        self.run()
        outs = [self.output(u) for u in uids]
        for u in uids:
            self.release(u)
        return outs

    def output(self, uid: int) -> RequestOutput:
        """The finished request's RequestOutput."""
        req = self._requests.get(uid)
        if req is None:
            raise KeyError(f"unknown uid {uid}")
        if not req.done:
            raise ValueError(f"request {uid} still in flight")
        return RequestOutput(
            uid=uid, prompt=list(req.prompt), token_ids=list(req.output),
            logprobs=list(req.logprobs) if req.params.logprobs else None,
            finish_reason=req.finish_reason, submit_time=req.submit_ts,
            first_token_time=req.first_ts, finish_time=req.finish_ts,
            spec_steps=req.spec_steps, spec_drafted=req.spec_drafted,
            spec_accepted=req.spec_accepted, tier_hit_pages=req.tier_hits,
            tier_stall_tokens=req.tier_stalls)

    def outputs(self) -> List[RequestOutput]:
        """Every finished, unreleased request, in uid order."""
        return [self.output(u) for u in sorted(self._requests)
                if self._requests[u].done]

    def release(self, uid: int) -> None:
        """Drop a FINISHED request's host bookkeeping."""
        req = self._requests.get(uid)
        if req is None:
            return
        if not req.done:
            raise ValueError(f"request {uid} still in flight")
        del self._requests[uid]
        del self._streamed[uid]
        self._done_emitted.discard(uid)
        self._batcher.completed.pop(uid, None)


def latency_percentile(vals: Sequence[float], q: float) -> float:
    """Percentile over TTFT/TPOT samples (NaN when none exist — e.g.
    every request aborted before its first token)."""
    vals = [v for v in vals if v is not None]
    if not vals:
        return float("nan")
    return float(np.percentile(np.asarray(vals, np.float64), q))
