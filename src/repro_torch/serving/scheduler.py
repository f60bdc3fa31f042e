"""Continuous batching over the KVNAND engine (port of
`repro.serving.scheduler.ContinuousBatcher`, stripe layout, synchronous).

  * a fixed decode batch of B slots; empty slots are refilled from the
    queue between steps, by (priority, deadline, submit order);
  * an admitted prompt is prefilled chunk by chunk (page-aligned chunks
    of `prefill_chunk_tokens`) straight into its slot's stripe
    (`engine.prefill_chunk`);
  * every step spends a token budget: the decode batch (one token per
    decoding slot) is funded first, the remainder funds prefill chunks,
    and at least one chunk always runs;
  * the decode step carries an `active` mask, so slots that are empty or
    mid-prefill get no append and no length advance;
  * each request samples from its own (seed, tokens emitted) stream.

`step()` is the reference's synchronous schedule (dispatch, then
collect, back to back).  Not ported yet, and refused at construction:
the shared/tiered pool and prefix cache, speculative verify, the
overlapped dispatch/collect pipeline and the splice baseline (ROADMAP).
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Deque, Dict, List, Optional

import numpy as np
import torch

from repro_torch.configs.base import EngineConfig, ModelConfig
from repro_torch.core.engine import KVNANDEngine
from repro_torch.models.transformer import Runtime
from repro_torch.serving.sampler import (SamplingParams, request_noise,
                                         sample_with_logprobs)


@dataclasses.dataclass
class Request:
    """One in-flight request; timing marks feed `RequestOutput`."""
    uid: int
    prompt: List[int]
    max_new: int
    output: List[int] = dataclasses.field(default_factory=list)
    done: bool = False
    params: Optional[SamplingParams] = None
    logprobs: List[float] = dataclasses.field(default_factory=list)
    finish_reason: Optional[str] = None   # stop|length|capacity|aborted|deadline
    priority: int = 0
    deadline_ts: Optional[float] = None
    order: int = 0
    submit_ts: Optional[float] = None
    first_ts: Optional[float] = None
    finish_ts: Optional[float] = None


@dataclasses.dataclass
class _PrefillState:
    """Host-side carry-over of one slot's in-progress chunked prefill."""
    req: Request
    tokens: np.ndarray      # prompt, padded to the chunk grid
    n: int                  # true prompt length
    pos: int = 0            # next chunk's first token
    order: int = 0          # admission order (FIFO chunk scheduling)


class ContinuousBatcher:
    def __init__(self, cfg: ModelConfig, params, *, batch_slots: int = 4,
                 max_context: int = 512, eng: Optional[EngineConfig] = None,
                 rt: Optional[Runtime] = None, seed: int = 0,
                 prefill_chunk_tokens: int = 64,
                 step_token_budget: Optional[int] = None, device="cuda"):
        eng = eng or EngineConfig(page_tokens=16, uniform_lengths=False)
        if eng.uniform_lengths:
            raise ValueError(
                "continuous batching needs the ragged append path: pass "
                "an EngineConfig with uniform_lengths=False")
        if prefill_chunk_tokens % eng.page_tokens:
            raise ValueError(
                f"prefill_chunk_tokens={prefill_chunk_tokens} must be a "
                f"multiple of page_tokens={eng.page_tokens} so chunk "
                "starts stay page-aligned")
        if eng.speculation_k:
            raise NotImplementedError(
                "speculative draft-and-verify decoding is not ported yet "
                "(ROADMAP A11)")
        self.cfg = cfg
        self.device = torch.device(device)
        self.engine = KVNANDEngine(cfg, eng, rt or Runtime(),
                                   device=self.device)
        self.params = params
        self.B = batch_slots
        self.max_context = max_context
        self.chunk_tokens = prefill_chunk_tokens
        self.step_token_budget = (step_token_budget
                                  or prefill_chunk_tokens + batch_slots)
        self.seed = seed
        self.queue: Deque[Request] = deque()
        self.slots: List[Optional[Request]] = [None] * batch_slots
        self.cache = self.engine.init_cache(batch_slots, max_context)
        self._lengths = np.zeros(batch_slots, np.int64)
        self._prefill_live: Dict[int, _PrefillState] = {}
        self._admit_seq = 0
        self._submit_seq = 0
        # per-slot sampling params (host arrays, staged each decode step)
        self._temps = np.zeros(batch_slots, np.float32)
        self._topk = np.zeros(batch_slots, np.int64)
        self._topp = np.ones(batch_slots, np.float32)
        self._seeds = np.zeros(batch_slots, np.uint32)
        self.completed: Dict[int, Request] = {}
        self.stats = {"steps": 0, "admits": 0, "prefill_chunks": 0,
                      "decode_steps": 0, "decode_tokens": 0,
                      "deadline_drops": 0}

    # -- per-request sampling / lifecycle ------------------------------
    def _seed_of(self, req: Request) -> np.uint32:
        """The request's stream seed: its explicit `params.seed`, or a
        (batcher seed, uid) hash — independent of batch composition."""
        if req.params is not None and req.params.seed is not None:
            return np.uint32(req.params.seed & 0xFFFFFFFF)
        return np.uint32((self.seed * 0x9E3779B1 + req.uid * 0x85EBCA77
                          + 0x165667B1) & 0xFFFFFFFF)

    def _set_slot_params(self, i: int, req: Request):
        p = req.params
        self._temps[i] = p.temperature
        self._topk[i] = p.top_k
        self._topp[i] = p.top_p
        self._seeds[i] = self._seed_of(req)

    def _sample(self, logits: torch.Tensor, rows: List[int],
                positions: List[int]):
        """Sample `rows` (slot indices, one per logits row) through their
        own params and (seed, position) streams -> host (toks, lps)."""
        V = logits.shape[-1]
        idx = np.asarray(rows)
        temps = self._temps[idx]
        noise = None
        if (temps > 0).any():
            noise = request_noise(self._seeds[idx], positions, V,
                                  logits.device)
        dev = logits.device
        toks, lps = sample_with_logprobs(
            logits, noise, true_vocab=self.cfg.vocab_size,
            temperature=torch.as_tensor(temps, device=dev),
            top_k=torch.as_tensor(self._topk[idx], device=dev),
            top_p=torch.as_tensor(self._topp[idx], device=dev))
        return toks.cpu().numpy(), lps.cpu().numpy()

    def _finish(self, i: int, reason: str):
        """Retire slot i's request; its stripe is overwritten in place by
        the next occupant."""
        req = self.slots[i]
        req.done = True
        req.finish_reason = reason
        req.finish_ts = time.monotonic()
        self.completed[req.uid] = req
        self.slots[i] = None
        self._lengths[i] = 0

    def _emit_token(self, i: int, req: Request, tok: int, lp: float):
        """Append one sampled token and apply the finish rules (stop
        token beats length; capacity is checked by the decode sweep)."""
        req.output.append(tok)
        if req.params.logprobs:
            req.logprobs.append(lp)
        if req.first_ts is None:
            req.first_ts = time.monotonic()
        if tok in req.params.stop_token_ids:
            self._finish(i, "stop")
        elif len(req.output) >= req.max_new:
            self._finish(i, "length")

    def abort(self, uid: int) -> bool:
        """Cancel a request wherever it is: queued, mid-chunked-prefill,
        or decoding.  Returns False for unknown/finished uids."""
        for r in self.queue:
            if r.uid == uid:
                self.queue.remove(r)
                r.done = True
                r.finish_reason = "aborted"
                r.finish_ts = time.monotonic()
                self.completed[uid] = r
                return True
        for i, r in enumerate(self.slots):
            if r is not None and r.uid == uid:
                self._prefill_live.pop(i, None)
                self._finish(i, "aborted")
                return True
        return False

    def submit(self, req: Request):
        if req.params is None:
            req.params = SamplingParams(max_new_tokens=req.max_new)
        else:
            req.max_new = req.params.max_new_tokens
        if req.submit_ts is None:
            req.submit_ts = time.monotonic()
        req.order = self._submit_seq
        self._submit_seq += 1
        n = len(req.prompt)
        cap = self.max_context - 1
        if n == 0:
            raise ValueError(f"request {req.uid}: empty prompt")
        if n > cap:
            raise ValueError(
                f"request {req.uid}: prompt of {n} tokens exceeds the slot "
                f"capacity of {cap} (max_context={self.max_context} minus "
                "1 decode token); truncate the prompt or enlarge "
                "max_context")
        self.queue.append(req)

    @staticmethod
    def _admission_key(r: Request):
        return (r.priority,
                r.deadline_ts if r.deadline_ts is not None else float("inf"),
                r.order)

    def _queue_pick(self) -> Optional[Request]:
        """Sweep queued requests whose deadline passed (they finish as
        "deadline"), then return the best admission candidate."""
        now = time.monotonic()
        for r in [r for r in self.queue
                  if r.deadline_ts is not None and now >= r.deadline_ts]:
            self.queue.remove(r)
            r.done = True
            r.finish_reason = "deadline"
            r.finish_ts = now
            self.completed[r.uid] = r
            self.stats["deadline_drops"] += 1
        if not self.queue:
            return None
        return min(self.queue, key=self._admission_key)

    def _admit(self):
        for i in range(self.B):
            if self.slots[i] is None and self.queue:
                req = self._queue_pick()
                if req is None:
                    break
                self.queue.remove(req)
                self.slots[i] = req
                self._set_slot_params(i, req)
                self._start_prefill(i, req)
                self.stats["admits"] += 1

    def _start_prefill(self, i: int, req: Request):
        n = len(req.prompt)
        C = self.chunk_tokens
        toks = np.zeros(-(-n // C) * C, np.int64)
        toks[:n] = req.prompt
        self._prefill_live[i] = _PrefillState(req, toks, n,
                                              order=self._admit_seq)
        self._admit_seq += 1

    def _prefill_tick(self, i: int, ps: _PrefillState):
        """Process ONE chunk of slot i's prompt into the cache."""
        c0 = ps.pos
        chunk = ps.tokens[c0:c0 + self.chunk_tokens]
        cl = min(self.chunk_tokens, ps.n - c0)
        logits, self.cache = self.engine.prefill_chunk(
            self.params, self.cache,
            {"tokens": torch.as_tensor(chunk, device=self.device)[None]},
            i, c0, cl, first=(c0 == 0))
        ps.pos = c0 + len(chunk)
        self.stats["prefill_chunks"] += 1
        if ps.pos >= ps.n:                         # prompt fully prefilled
            del self._prefill_live[i]
            self._lengths[i] = ps.n
            toks, lps = self._sample(logits, [i], [len(ps.req.output)])
            self._emit_token(i, ps.req, int(toks[0]), float(lps[0]))

    def step(self) -> int:
        """One interleaved step: admissions, budgeted prefill chunks,
        then one decode step over every decoding slot.  Returns the
        number of prefill chunks plus tokens decoded."""
        self._admit()
        decoding = [i for i, r in enumerate(self.slots)
                    if r is not None and i not in self._prefill_live]
        budget = self.step_token_budget - len(decoding)
        chunks_done = 0
        for i, ps in sorted(self._prefill_live.items(),
                            key=lambda kv: kv[1].order):
            cost = self.chunk_tokens
            # always fund at least one chunk; extra chunks within budget
            if chunks_done and budget < cost:
                break
            self._prefill_tick(i, ps)
            budget -= cost
            chunks_done += 1
        active = [i for i, r in enumerate(self.slots)
                  if r is not None and i not in self._prefill_live]
        self.stats["steps"] += 1
        return chunks_done + self._decode_batch(active)

    def _decode_batch(self, active: List[int]) -> int:
        """One synchronous decode step over `active` slots."""
        if not active:
            return 0
        return self._collect_decode(active, *self._dispatch_sequential(active))

    def _dispatch_sequential(self, active: List[int]):
        """Run one masked decode over `active` slots and sample each
        row through its own params and stream; returns device (toks,
        lps) for `_collect_decode`."""
        tokens = np.zeros((self.B, 1), np.int64)
        mask = np.zeros(self.B, bool)
        for i in active:
            tokens[i, 0] = self.slots[i].output[-1]
            mask[i] = True
        logits, self.cache = self.engine.decode_step(
            self.params, self.cache,
            torch.as_tensor(tokens, device=self.device),
            active=torch.as_tensor(mask, device=self.device))
        self.stats["decode_steps"] += 1
        self._lengths[active] += 1
        return self._sample(logits[active], active,
                            [len(self.slots[i].output) for i in active])

    def _collect_decode(self, active: List[int], toks, lps) -> int:
        """Emit one decode step's tokens through the finish rules."""
        for j, i in enumerate(active):
            req = self.slots[i]
            self._emit_token(i, req, int(toks[j]), float(lps[j]))
            self.stats["decode_tokens"] += 1
            if self.slots[i] is req and self._lengths[i] + 1 >= \
                    self.max_context:
                self._finish(i, "capacity")
        return len(active)

    def run_to_completion(self, max_steps: int = 10_000):
        steps = 0
        while self.queue or any(r is not None for r in self.slots):
            if steps >= max_steps:
                stuck = sorted([r.uid for r in self.queue]
                               + [r.uid for r in self.slots if r is not None])
                raise RuntimeError(
                    f"run_to_completion: max_steps={max_steps} exhausted "
                    f"with requests still pending (uids {stuck})")
            self.step()
            steps += 1
        return self.completed
