"""PyTorch port: `ReplicaRouter` fuzz / soak on the CPU (the reference's
`tests/test_router.py` on the port).

Randomized submit / abort / deadline mixes over 3 FAKE-CLOCK replicas:
the queues drain, no priority class starves (every surviving request
finishes with a real reason and its full output), and pages are
conserved on every replica at the drain, routed and disaggregated (where
aborts land while a request is held awaiting migration), with
synchronous and overlapped replicas.  Replicas built by
`build_replica(device="cpu")` share one set of weights and serve one
server's tokens; a deadline expires only queued requests.
"""
import dataclasses
import random

import jax
import numpy as np
import pytest
import torch

import repro_torch.serving.api as api_mod
import repro_torch.serving.scheduler as sched_mod
from repro.configs import get_config
from repro.models.registry import Model
from repro_torch import bridge
from repro_torch.configs import EngineConfig
from repro_torch.configs import get_config as tget
from repro_torch.serving.api import KVNANDServer, ServerConfig
from repro_torch.serving.replica import build_replica
from repro_torch.serving.router import ReplicaRouter
from repro_torch.serving.sampler import SamplingParams

torch.set_num_threads(2)

TOTAL_PAGES = 48
_CACHE = {}


class FakeClock:
    """Deterministic stand-in for the `time` module: the scheduler and
    server only call `monotonic()`."""

    def __init__(self):
        self.t = 1000.0

    def monotonic(self):
        return self.t

    def advance(self, dt):
        self.t += dt


def _model():
    if "m" not in _CACHE:
        params = Model(get_config("qwen1.5-0.5b").reduced()).init(
            jax.random.PRNGKey(0))
        _CACHE["m"] = (tget("qwen1.5-0.5b").reduced(),
                       bridge.params_from_numpy(
                           jax.tree.map(np.asarray, params), "cpu"))
    return _CACHE["m"]


@pytest.fixture()
def clock(monkeypatch):
    clk = FakeClock()
    monkeypatch.setattr(sched_mod, "time", clk)
    monkeypatch.setattr(api_mod, "time", clk)
    return clk


def _config(slots=2, overlap=False):
    eng = EngineConfig(page_tokens=16, uniform_lengths=False,
                       shared_pool=True, total_pages=TOTAL_PAGES)
    return ServerConfig(engine=eng, batch_slots=slots, max_context=64,
                        prefill_chunk_tokens=16, seed=7, overlap=overlap,
                        device="cpu")


def _server(slots=2, overlap=False):
    cfg, params = _model()
    return KVNANDServer(_config(slots, overlap), cfg=cfg, params=params)


def _conserved(server):
    b = server._batcher
    assert not b.queue and all(r is None for r in b.slots)
    assert b.pending_steps == 0
    b.alloc.check()
    if b.tier is not None:
        b.tier.check()
        assert b.tier.pinned_count == 0
    # every page still live must belong to the prefix cache: evict it
    # all and the pool must be whole again (nothing leaked)
    if b.prefix_cache is not None:
        while b.prefix_cache.evict_lru():
            pass
    b.alloc.check()
    assert b.alloc.free_count == b.alloc.total, "leaked pages at drain"


def _soak(clock, *, disaggregate, seed, overlap=False, n_requests=18):
    rng = random.Random(seed)
    vocab = _model()[0].vocab_size
    servers = [_server(overlap=overlap) for _ in range(3)]
    router = ReplicaRouter(servers, disaggregate=disaggregate)
    meta = {}           # uid -> (priority, deadline, max_new)
    submitted = []
    aborted = set()
    steps = 0
    while len(meta) < n_requests or router._busy():
        if len(meta) < n_requests and rng.random() < 0.6:
            prompt = [rng.randrange(1, vocab)
                      for _ in range(rng.randint(1, 30))]
            prio = rng.randrange(3)
            deadline = rng.choice([None, None, 0.02, 300.0])
            max_new = rng.randint(1, 5)
            uid = router.submit(
                prompt, SamplingParams(max_new_tokens=max_new),
                priority=prio, deadline=deadline)
            meta[uid] = (prio, deadline, max_new)
            submitted.append(uid)
        if submitted and rng.random() < 0.15:
            uid = rng.choice(submitted)
            if router.abort(uid):
                aborted.add(uid)
        router.step()
        clock.advance(0.01)
        steps += 1
        assert steps < 3000, "soak failed to drain"

    finished = {u: router.output(u) for u in meta}
    for u, out in finished.items():
        prio, deadline, max_new = meta[u]
        assert out.finish_reason in ("stop", "length", "aborted",
                                     "deadline")
        if out.finish_reason == "deadline":
            assert deadline is not None and out.token_ids == []
        if out.finish_reason == "length":
            assert len(out.token_ids) == max_new
        # NO STARVED CLASS: every request neither aborted nor
        # deadline-bound ran to a real finish, whatever its priority
        if u not in aborted and deadline is None:
            assert out.finish_reason in ("stop", "length"), \
                f"uid {u} (priority {prio}) starved: {out.finish_reason}"
    for s in servers:
        _conserved(s)
    return router


@pytest.mark.parametrize("seed", [0, 1])
def test_routed_fuzz_soak(clock, seed):
    router = _soak(clock, disaggregate=False, seed=seed)
    # the fleet actually spread: more than one replica did work
    assert sum(1 for s in router.servers if s.stats["admits"] > 0) >= 2


@pytest.mark.parametrize("overlap", [False, True], ids=["sync", "overlap"])
def test_disaggregated_fuzz_soak(clock, overlap):
    router = _soak(clock, disaggregate=True, seed=2, overlap=overlap)
    assert router.stats["migrations"] > 0
    # the prefill replica never decoded past the handoff token; decode
    # replicas never admitted from their own queues
    pre = router.servers[0]
    assert pre.stats.get("migrations_out", 0) == router.stats["migrations"]
    assert pre.stats["decode_steps"] == 0
    for s in router.servers[1:]:
        assert s.stats["admits"] == s.stats.get("migrations_in", 0)


def test_replicas_built_on_one_device_share_weights():
    """`build_replica(device="cpu")` for every replica: one set of
    weights, and the router serves one server's tokens.  (The
    reference's counterpart, `test_replicas_on_distinct_devices`, puts
    each replica on its own forced host device.)"""
    cfg, params = _model()
    config = dataclasses.replace(_config(), device="cuda")
    servers = [build_replica(config, cfg=cfg, params=params,
                             device="cpu") for _ in range(3)]
    for s in servers:
        assert s.engine.device == torch.device("cpu")
        assert s.params["embedding"] is params["embedding"]
        assert s.params["layers"]["attn"]["wq_w"] is \
            params["layers"]["attn"]["wq_w"]
    router = ReplicaRouter(servers, disaggregate=True)
    rng = random.Random(5)
    prompts = [[rng.randrange(1, cfg.vocab_size)
                for _ in range(rng.randint(4, 25))] for _ in range(3)]
    sp = SamplingParams(max_new_tokens=5)
    solo = _server()
    for i, p in enumerate(prompts):
        router.submit(p, sp, uid=i)
        solo.submit(p, sp, uid=i)
    router.run()
    solo.run()
    assert router.stats["migrations"] == len(prompts)
    for i in range(len(prompts)):
        assert router.output(i).token_ids == solo.output(i).token_ids
    assert [o.uid for o in router.outputs()] == [0, 1, 2]
    for i in range(len(prompts)):
        router.release(i)
    assert router.outputs() == []
    for s in servers:
        _conserved(s)


def test_deadline_expires_only_queued(clock):
    """A queued request expires at its fake-clock deadline; a running one
    does not."""
    servers = [_server(slots=1) for _ in range(2)]
    router = ReplicaRouter(servers, disaggregate=True)
    vocab = _model()[0].vocab_size
    rng = random.Random(9)
    long_p = [rng.randrange(1, vocab) for _ in range(20)]
    u_run = router.submit(long_p, SamplingParams(max_new_tokens=6),
                          deadline=30.0)
    # admission is (priority, nearest deadline): park u_queued in a LOWER
    # priority class so u_run's slot claim wins despite its later deadline
    u_queued = router.submit(long_p[:5],
                             SamplingParams(max_new_tokens=2),
                             priority=1, deadline=0.05)
    router.step()               # u_run admits into the only slot
    clock.advance(1.0)          # u_queued's deadline passes in queue
    router.run()
    assert router.output(u_run).finish_reason in ("stop", "length")
    assert router.output(u_queued).finish_reason == "deadline"
    for s in servers:
        _conserved(s)


def test_router_guards_and_stats():
    with pytest.raises(ValueError, match="at least one"):
        ReplicaRouter([])
    with pytest.raises(ValueError, match="decode replica"):
        ReplicaRouter([_server()], disaggregate=True)
    router = ReplicaRouter([_server(), _server()])
    uid = router.submit([1, 2, 3], SamplingParams(max_new_tokens=2))
    with pytest.raises(ValueError, match="already submitted"):
        router.submit([1, 2, 3], uid=uid)
    assert router.abort(12345) is False
    router.run()
    stats = router.replica_stats()
    assert len(stats) == 2 and sum(s["admits"] for s in stats) == 1
