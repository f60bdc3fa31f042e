"""Multi-replica request router with disaggregated prefill/decode (port
of `repro.serving.router`).

`ReplicaRouter` spreads requests over N `KVNANDServer` replicas.  Two
modes:

  * **routed** (default): every request runs end to end on the
    least-loaded replica (queue depth + occupied slots; ties rotate, so
    an idle fleet still spreads).  Priority and deadline pass straight
    through to the replica's admission order, so backpressure, deadline
    expiry and abort with page conservation behave as on one server.

  * **disaggregated** (``disaggregate=True``): replica 0 PREFILLS and the
    rest decode.  A request chunk-prefills on replica 0 with its slot
    HELD (`Request.hold` keeps it out of decode dispatch); then its KV
    state crosses to the least-loaded decode replica as a `KVEnvelope`,
    always through the real wire bytes (`to_bytes` / `from_bytes`), so
    ``stats["migration_bytes"]`` is the transfer's true size.  The source
    keeps its pages until the import lands; a destination that cannot
    take the request yet (no free slot, pool or hot-tier pressure) is
    retried at the next step, so no admission bound is ever bypassed.

A `PrefixPageIndex` collects full-page chains from whichever replica
finishes (or migrates) a prompt and warms them into the chosen replica's
prefix cache right before submit (routed mode).

`step()` steps every busy replica once, then pumps migrations.  A
replica built with ``ServerConfig(overlap=True)`` is stepped as its own
`stream()` steps it: step N+1 is dispatched before step N is collected,
so one step stays in flight across router steps, and the migration pump
exports and imports while it is (the pump's reads and writes are
enqueued on the same stream, after it).  Tokens are the synchronous
schedule's either way.

The router never reads the clock: timing lives in the replicas'
schedulers, so fake-clock soak tests patch `scheduler.time` /
`api.time` as usual.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence

from repro_torch.serving.api import KVNANDServer, RequestOutput, StreamEvent
from repro_torch.serving.replica import (KVEnvelope, PrefixPageIndex,
                                         export_request, finish_migrated,
                                         import_request)
from repro_torch.serving.sampler import SamplingParams


class ReplicaRouter:
    """Route requests across replicas; optionally disaggregate prefill
    from decode with token-identical KV page migration."""

    def __init__(self, replicas: Sequence[KVNANDServer], *,
                 disaggregate: bool = False,
                 prefix_index: Optional[PrefixPageIndex] = None,
                 share_prefix: bool = True):
        if not replicas:
            raise ValueError("ReplicaRouter needs at least one replica")
        if disaggregate and len(replicas) < 2:
            raise ValueError("disaggregated mode needs a prefill replica "
                             "plus at least one decode replica")
        self.servers: List[KVNANDServer] = list(replicas)
        self.disaggregate = disaggregate
        self.index = prefix_index
        if self.index is None and share_prefix:
            for s in self.servers:
                if s._batcher.prefix_cache is not None:
                    self.index = PrefixPageIndex(
                        s._batcher.engine.eng.page_tokens)
                    break
        self._home: Dict[int, int] = {}     # uid -> replica index
        self._rr = 0                        # rotating tie-break cursor
        self._next_uid = 0
        self.stats: Dict[str, int] = {
            "migrations": 0, "migration_bytes": 0,
            "migration_retries": 0, "prefix_warmed_pages": 0,
            "prefix_published_pages": 0,
        }

    # -- placement -------------------------------------------------------

    def _load(self, k: int) -> int:
        b = self.servers[k]._batcher
        return len(b.queue) + sum(r is not None for r in b.slots)

    def _decode_indices(self) -> List[int]:
        return (list(range(1, len(self.servers))) if self.disaggregate
                else list(range(len(self.servers))))

    def _least_loaded(self, candidates: Sequence[int]) -> int:
        """Minimum load; ties rotate (a round-robin cursor), so an idle
        fleet still spreads and prefix warming really crosses replicas."""
        n = len(self.servers)
        k = min(candidates,
                key=lambda k: (self._load(k), (k - self._rr) % n))
        self._rr = (k + 1) % n
        return k

    def replica_of(self, uid: int) -> int:
        """The replica holding `uid` now (its slot, queue entry or
        finished output)."""
        return self._home[uid]

    # -- request lifecycle ----------------------------------------------

    def submit(self, prompt: Sequence[int],
               params: Optional[SamplingParams] = None, *,
               uid: Optional[int] = None, priority: int = 0,
               deadline: Optional[float] = None) -> int:
        """Queue one prompt on the chosen replica (the prefill replica
        when disaggregated, else the least-loaded); uids are router-wide.
        Priority and deadline mean what they mean on one server."""
        if uid is None:
            uid = self._next_uid
        if uid in self._home:
            raise ValueError(f"uid {uid} already submitted")
        k = 0 if self.disaggregate else self._least_loaded(
            self._decode_indices())
        server = self.servers[k]
        if self.index is not None and not self.disaggregate:
            self.stats["prefix_warmed_pages"] += self.index.warm(
                server._batcher, prompt)
        server.submit(prompt, params, uid=uid, priority=priority,
                      deadline=deadline)
        if self.disaggregate:
            # held through prefill: the slot joins no decode dispatch
            # until its KV state migrates to a decode replica
            server._requests[uid].hold = True
        self._home[uid] = k
        self._next_uid = max(self._next_uid, uid + 1)
        return uid

    def abort(self, uid: int) -> bool:
        """Abort wherever the request lives now; pages are conserved per
        replica (a request awaiting migration still owns its source
        pages, so the source's abort frees them all)."""
        k = self._home.get(uid)
        if k is None:
            return False
        return self.servers[k].abort(uid)

    # -- stepping --------------------------------------------------------

    @staticmethod
    def _step_one(s: KVNANDServer) -> List[StreamEvent]:
        if not s.config.overlap:
            return s.step()
        # the replica's own stream() order: keep one step in flight
        if s.pending_steps() == 0 and s._busy():
            s.dispatch()
        if s._busy():
            s.dispatch()
        return s.collect()

    def step(self) -> List[StreamEvent]:
        """One step of every busy replica, then (disaggregated) the
        migration pump.  Events merge in replica order; each uid's
        stream stays gap-free across the handoff (the decode replica
        resumes at the next index)."""
        events: List[StreamEvent] = []
        for s in self.servers:
            if s._busy() or s.pending_steps():
                events.extend(self._step_one(s))
        if self.disaggregate:
            self._pump_migrations()
        if self.index is not None:
            self._publish_finished(events)
        return events

    def _pump_migrations(self) -> None:
        pre = self.servers[0]
        b = pre._batcher
        ready = [r.uid for i, r in enumerate(b.slots)
                 if r is not None and r.hold and not r.done
                 and r.output and i not in b._prefill_live]
        for uid in ready:
            env = export_request(b, uid)
            wire = env.to_bytes()
            env = KVEnvelope.from_bytes(wire)
            if self.index is not None:
                self.stats["prefix_published_pages"] += \
                    self.index.publish_from(b, env.arrays["prompt"])
            req = None
            for k in sorted(self._decode_indices(),
                            key=lambda k: (self._load(k), k)):
                req = import_request(self.servers[k]._batcher, env)
                if req is not None:
                    break
            if req is None:             # destination pressure: the source
                self.stats["migration_retries"] += 1
                continue                # keeps its pages; retry next step
            dec = self.servers[k]
            dec._requests[uid] = req
            dec._streamed[uid] = len(req.output)    # the handoff token
            dec._next_uid = max(dec._next_uid, uid + 1)  # is streamed
            finish_migrated(b, uid)
            pre.release(uid)            # drops the "migrated" record too
            self._home[uid] = k
            self.stats["migrations"] += 1
            self.stats["migration_bytes"] += len(wire)

    def _publish_finished(self, events: Sequence[StreamEvent]) -> None:
        for e in events:
            if e.finish_reason not in ("stop", "length", "capacity"):
                continue
            s = self.servers[self._home[e.uid]]
            req = s._requests.get(e.uid)
            if req is not None:
                self.stats["prefix_published_pages"] += \
                    self.index.publish_from(s._batcher, req.prompt)

    def _busy(self) -> bool:
        return any(s._busy() or s.pending_steps() for s in self.servers)

    def run(self, max_steps: int = 10_000) -> List[StreamEvent]:
        """Drain every replica (and every pending migration)."""
        events: List[StreamEvent] = []
        steps = 0
        while self._busy():
            if steps >= max_steps:
                raise RuntimeError(
                    f"ReplicaRouter.run: max_steps={max_steps} exhausted "
                    "with requests still pending")
            events.extend(self.step())
            steps += 1
        return events

    # -- results ---------------------------------------------------------

    def output(self, uid: int) -> RequestOutput:
        return self.servers[self._home[uid]].output(uid)

    def outputs(self) -> List[RequestOutput]:
        return [self.output(u) for u in sorted(self._home)
                if self.servers[self._home[u]]._requests[u].done]

    def release(self, uid: int) -> None:
        k = self._home.pop(uid)
        self.servers[k].release(uid)

    def replica_stats(self) -> List[Dict[str, int]]:
        return [dict(s.stats) for s in self.servers]
