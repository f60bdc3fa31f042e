"""PyTorch port: the overlapped dispatch / collect pipeline, on the CPU
(the reference's `tests/test_pipeline.py`, on the port).

The pipelined schedule — dispatch step N+1 before collecting step N —
must serve the synchronous loop's tokens, logprobs and finish reasons,
over striped, shared and tiered pools, with speculation off and at 4,
under mixed SamplingParams; and the overlapped port must serve the JAX
reference's overlapped tokens on the same weights.  Plus the pipeline's
hazards: phantom rows (slots that finish or abort between dispatch and
collect) are dropped with the shared pool's conservation intact, first-
token times come from collect(), the pipeline stays at most two steps
deep, and priority / deadline order admission.
"""
import time

import jax
import numpy as np
import pytest
import torch

from repro.configs import EngineConfig, get_config
from repro.models.registry import Model
from repro.serving.api import KVNANDServer as JServer
from repro.serving.api import SamplingParams as JParams
from repro.serving.api import ServerConfig as JConfig
from repro_torch import bridge
from repro_torch.configs import EngineConfig as TEngineConfig
from repro_torch.configs import get_config as tget
from repro_torch.serving.api import KVNANDServer, SamplingParams, ServerConfig

torch.set_num_threads(2)

ARCH = "qwen1.5-0.5b"

_CACHE = {}


def _model():
    """(reference cfg, reference params, port cfg, port params)."""
    if "m" not in _CACHE:
        cfg = get_config(ARCH).reduced()
        params = Model(cfg).init(jax.random.PRNGKey(0))
        _CACHE["m"] = (cfg, params, tget(ARCH).reduced(),
                       bridge.params_from_numpy(
                           jax.tree.map(np.asarray, params), "cpu"))
    return _CACHE["m"]


POOLS = {
    "striped": dict(),
    "shared": dict(shared_pool=True),
    "tiered": dict(shared_pool=True, total_pages=64, hot_pages=12),
}


def _server(pool="striped", *, overlap, spec_k=0, slots=2, ctx=96,
            chunk=16, **kw):
    _, _, tcfg, tparams = _model()
    eng = TEngineConfig(page_tokens=16, uniform_lengths=False,
                        kv_dtype="float32", **POOLS[pool])
    return KVNANDServer(
        ServerConfig(engine=eng, batch_slots=slots, max_context=ctx,
                     prefill_chunk_tokens=chunk, overlap=overlap,
                     speculation_k=spec_k, device="cpu", **kw),
        cfg=tcfg, params=tparams)


def _ref_server(pool, *, overlap, spec_k=0):
    cfg, params, _, _ = _model()
    eng = EngineConfig(page_tokens=16, uniform_lengths=False,
                       kv_dtype="float32", **POOLS[pool])
    return JServer(JConfig(engine=eng, batch_slots=2, max_context=96,
                           prefill_chunk_tokens=16, overlap=overlap,
                           speculation_k=spec_k), cfg=cfg, params=params)


PROMPTS = [list(range(1, 8)), list(range(3, 24)), list(range(2, 13)),
           [5, 4, 3], list(range(4, 20))]

# mixed params: greedy, seeded-hot, top-k/p, stop tokens, logprobs
MIXED = [SamplingParams(max_new_tokens=6, logprobs=True),
         SamplingParams(max_new_tokens=8, temperature=0.9, seed=3),
         SamplingParams(max_new_tokens=7, temperature=1.2, top_k=5,
                        seed=9),
         SamplingParams(max_new_tokens=5, temperature=0.8, top_p=0.9,
                        top_k=7, seed=11),
         SamplingParams(max_new_tokens=9, stop_token_ids=(2, 7))]


def _signature(outs):
    return [(o.token_ids, o.logprobs, o.finish_reason) for o in outs]


# ---------------------------------------------------------------------------
# parity matrix: overlap == sync, every pool, spec on/off, mixed params
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("pool", sorted(POOLS))
@pytest.mark.parametrize("spec_k", [0, 4], ids=["seq", "spec4"])
def test_overlap_matches_sync(pool, spec_k):
    sync = _server(pool, overlap=False, spec_k=spec_k)
    o_sync = sync.generate(PROMPTS, MIXED)
    over = _server(pool, overlap=True, spec_k=spec_k)
    o_over = over.generate(PROMPTS, MIXED)
    assert _signature(o_over) == _signature(o_sync)
    # the same work, though not in the same steps: an overlapped
    # dispatch cannot admit into a slot its own collect frees
    for key in ("decode_tokens", "prefill_chunks", "admits",
                "verify_steps", "cow_copies", "prefix_hit_pages"):
        assert over.stats[key] == sync.stats[key], key
    if spec_k == 0:
        assert over.stats["steps"] > 0
    else:
        # verify steps draft from host-visible history: dispatch()
        # degrades to the synchronous schedule, acceptance still fires
        assert over.stats["spec_accepted"] == sync.stats["spec_accepted"]
        assert over.stats["phantom_tokens"] == 0


@pytest.mark.parametrize("pool", sorted(POOLS))
@pytest.mark.parametrize("spec_k", [0, 4], ids=["seq", "spec4"])
def test_overlapped_port_matches_overlapped_reference(pool, spec_k):
    """The overlapped port against the overlapped reference on the same
    weights at f32 pages: greedy tokens (stop tokens among them), finish
    reasons, logprobs within 1e-4.  Seeded sampling draws each
    framework's own noise, so only greedy requests are compared."""
    greedy = [SamplingParams(max_new_tokens=6, logprobs=True),
              SamplingParams(max_new_tokens=9, stop_token_ids=(2, 7),
                             logprobs=True)] * 3
    port = _server(pool, overlap=True, spec_k=spec_k)
    got = port.generate(PROMPTS + [PROMPTS[1]], greedy)
    ref = _ref_server(pool, overlap=True, spec_k=spec_k)
    want = ref.generate(PROMPTS + [PROMPTS[1]],
                        [JParams(max_new_tokens=p.max_new_tokens,
                                 stop_token_ids=p.stop_token_ids,
                                 logprobs=True) for p in greedy])
    for g, w in zip(got, want):
        assert g.token_ids == w.token_ids
        assert g.finish_reason == w.finish_reason
        np.testing.assert_allclose(g.logprobs, w.logprobs, atol=1e-4)
    for key in ("tier_hit_pages", "tier_stall_tokens", "tier_promotes",
                "tier_demotes", "cow_copies", "prefix_hit_pages"):
        assert port.stats[key] == ref.stats[key], key


def test_overlap_stream_events_identical_per_request():
    """Not just final outputs: each request's event stream (token,
    index, finish_reason) matches event for event, in order and
    gapless.  Only the interleaving across requests may shift."""
    def trace(overlap):
        srv = _server("shared", overlap=overlap)
        uids = [srv.submit(p, sp) for p, sp in zip(PROMPTS, MIXED)]
        per = {u: [] for u in uids}
        for ev in srv.stream():
            assert ev.index == len(per[ev.uid])     # in order, gapless
            per[ev.uid].append((ev.token, ev.index, ev.finish_reason))
        return per
    assert trace(True) == trace(False)


def test_overlap_capacity_finish_parity():
    """Capacity finishes are foreseen at dispatch (cap_finish), so the
    pipeline never dispatches a doomed row; tokens still match."""
    kw = dict(ctx=64, slots=1)
    prompts = [list(range(1, 41))]
    sp = SamplingParams(max_new_tokens=100)
    o_sync = _server("shared", overlap=False, **kw).generate(prompts, sp)
    over = _server("shared", overlap=True, **kw)
    o_over = over.generate(prompts, sp)
    assert _signature(o_over) == _signature(o_sync)
    assert o_over[0].finish_reason == "capacity"
    assert over.stats["phantom_tokens"] == 0


def test_overlap_stop_token_leaves_a_phantom_row():
    """A stop token is not known at dispatch: the overlapped schedule
    dispatches the next step for that row anyway, and collect drops it
    as a phantom, without a token and with the pool balanced."""
    srv = _server("shared", overlap=False, slots=1)
    toks = srv.generate([PROMPTS[2]], SamplingParams(max_new_tokens=8))[0]
    j = next(j for j in range(2, 8) if toks.token_ids[j]
             not in toks.token_ids[:j])
    sp = SamplingParams(max_new_tokens=8,
                        stop_token_ids=(toks.token_ids[j],))
    over = _server("shared", overlap=True, slots=1)
    out = over.generate([PROMPTS[2]], sp)[0]
    assert out.token_ids == toks.token_ids[:j + 1]
    assert out.finish_reason == "stop"
    assert over.stats["phantom_tokens"] == 1
    _assert_pool_clean(over._batcher)


# ---------------------------------------------------------------------------
# timing: times taken at collect(), monotone in both modes
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("overlap", [False, True], ids=["sync", "overlap"])
def test_timing_monotonic(overlap):
    """first_token_time is stamped when the token reaches the host at
    collect(), never at dispatch: submit <= first <= finish holds in
    both modes."""
    srv = _server("shared", overlap=overlap)
    outs = srv.generate(PROMPTS[:3], SamplingParams(max_new_tokens=5))
    for o in outs:
        assert o.submit_time <= o.first_token_time <= o.finish_time
        assert o.ttft > 0.0 and o.tpot > 0.0


def test_device_idle_accounting():
    """A synchronous drain accumulates host-observed device idle time
    (every collect empties the pipeline); it stays a float >= 0."""
    srv = _server("striped", overlap=False)
    srv.generate(PROMPTS[:2], SamplingParams(max_new_tokens=6))
    assert isinstance(srv.stats["device_idle_s"], float)
    assert srv.stats["device_idle_s"] > 0.0
    assert srv.stats["steps"] > 0


# ---------------------------------------------------------------------------
# phantom rows: abort between dispatch and collect, pages conserved
# ---------------------------------------------------------------------------

def _cache_refs(pc):
    refs = {}
    for p in pc._full.values():
        refs[p] = refs.get(p, 0) + 1
    for e in pc._exact.values():
        for p in e.pages:
            refs[p] = refs.get(p, 0) + 1
    return refs


def _assert_pool_clean(b):
    b.alloc.check()
    refs = _cache_refs(b.prefix_cache) if b.prefix_cache else {}
    for p, r in refs.items():
        assert b.alloc.refcount[p] >= r, (p, int(b.alloc.refcount[p]), r)
    assert b.alloc.live_count == len(refs), \
        (b.alloc.live_count, len(refs))
    assert int(b._resv.sum()) == 0 and b._outstanding == 0


@pytest.mark.parametrize("pool", ["shared", "tiered"])
def test_abort_between_dispatch_and_collect(pool):
    """A slot aborted while its step is in flight: collect() drops the
    stale row (no token to the dead request, none to a successor in the
    slot) and the pool balances through the drain."""
    srv = _server(pool, overlap=True, slots=2)
    b = srv._batcher
    u0 = srv.submit(list(range(1, 30)), SamplingParams(max_new_tokens=20))
    u1 = srv.submit(list(range(2, 12)), SamplingParams(max_new_tokens=6))
    # drive both into decode synchronously, then leave one step in flight
    while not (srv._requests[u0].output and srv._requests[u1].output):
        srv.step()
    srv.dispatch()
    assert srv.pending_steps() == 1
    n0 = len(srv._requests[u0].output)
    assert srv.abort(u0)                  # mid-flight: row becomes phantom
    b.alloc.check()                       # conservation before the collect
    events = srv.collect()
    assert srv.stats["phantom_tokens"] >= 1
    assert len(srv._requests[u0].output) == n0    # no post-abort token
    assert all(ev.uid != u0 or ev.token is None for ev in events)
    events += srv.run()
    out0, out1 = srv.output(u0), srv.output(u1)
    assert out0.finish_reason == "aborted"
    assert out1.finish_reason == "length" and len(out1.token_ids) == 6
    # exactly one terminal event each, the aborted one token-free
    terms = {}
    for ev in events:
        if ev.finish_reason is not None:
            assert ev.uid not in terms
            terms[ev.uid] = ev
    assert terms[u0].token is None
    _assert_pool_clean(b)
    if b.tier is not None:
        b.tier.check()
        assert b.tier.pinned_count == 0


def test_abort_whole_pipeline_then_resubmit():
    """Abort EVERY in-flight request, then reuse the server: the phantom
    steps drain away and fresh traffic decodes normally."""
    srv = _server("shared", overlap=True, slots=2)
    us = [srv.submit(p, SamplingParams(max_new_tokens=30))
          for p in PROMPTS[:2]]
    while not all(srv._requests[u].output for u in us):
        srv.step()
    srv.dispatch()
    for u in us:
        srv.abort(u)
    srv.run()
    assert all(srv.output(u).finish_reason == "aborted" for u in us)
    ref = _server("shared", overlap=False).generate(
        PROMPTS[:1], SamplingParams(max_new_tokens=4))
    got = srv.generate(PROMPTS[:1], SamplingParams(max_new_tokens=4))
    assert _signature(got) == _signature(ref)
    _assert_pool_clean(srv._batcher)


def test_dispatch_depth_is_bounded():
    """dispatch() hammered without collect() does not grow the pipeline:
    the scheduler collects by itself past two steps in flight."""
    srv = _server("striped", overlap=True, slots=1)
    srv.submit(PROMPTS[0], SamplingParams(max_new_tokens=20))
    for _ in range(6):
        srv.dispatch()
    assert srv.pending_steps() <= 2
    srv.run()
    assert len(srv.output(0).token_ids) == 20


def test_overlapped_splice_scheduler_matches_sync():
    """The splice baseline keeps its synchronous step(); an overlapped
    driver runs it through dispatch() / collect() with the same tokens."""
    got = [_server(overlap=o, scheduler="splice").generate(PROMPTS, MIXED)
           for o in (False, True)]
    assert _signature(got[1]) == _signature(got[0])


# ---------------------------------------------------------------------------
# admission order: priority and deadlines
# ---------------------------------------------------------------------------

def test_priority_orders_admission():
    """With one slot busy, the queue admits by (priority, deadline,
    submit order): a later high-priority submit overtakes an earlier
    low-priority one."""
    srv = _server("striped", overlap=False, slots=1)
    u_run = srv.submit(PROMPTS[0], SamplingParams(max_new_tokens=12))
    u_low = srv.submit(PROMPTS[1], SamplingParams(max_new_tokens=3),
                       priority=5)
    u_high = srv.submit(PROMPTS[2], SamplingParams(max_new_tokens=3),
                        priority=0)
    srv.run()
    o = {u: srv.output(u) for u in (u_run, u_low, u_high)}
    assert all(x.finish_reason == "length" for x in o.values())
    assert o[u_high].first_token_time < o[u_low].first_token_time


def test_ties_fall_back_to_submit_order():
    srv = _server("striped", overlap=False, slots=1)
    us = [srv.submit(p, SamplingParams(max_new_tokens=2))
          for p in PROMPTS[:3]]
    srv.run()
    firsts = [srv.output(u).first_token_time for u in us]
    assert firsts == sorted(firsts)


def test_deadline_expiry_drops_queued_request():
    """A request still queued past its deadline finishes as "deadline"
    without pages or steps; the running request is untouched."""
    srv = _server("shared", overlap=True, slots=1)
    u0 = srv.submit(PROMPTS[0], SamplingParams(max_new_tokens=10))
    u1 = srv.submit(PROMPTS[1], SamplingParams(max_new_tokens=10),
                    deadline=1e-4)
    time.sleep(2e-3)                      # let the deadline lapse
    events = srv.run()
    out = srv.output(u1)
    assert out.finish_reason == "deadline"
    assert out.token_ids == [] and out.ttft is None
    assert srv.stats["deadline_drops"] == 1
    assert len(srv.output(u0).token_ids) == 10
    term = [ev for ev in events if ev.uid == u1]
    assert len(term) == 1 and term[0].token is None
    _assert_pool_clean(srv._batcher)


def test_deadline_validation():
    srv = _server("striped", overlap=False)
    with pytest.raises(ValueError, match="deadline"):
        srv.submit(PROMPTS[0], deadline=0.0)
