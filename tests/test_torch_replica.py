"""PyTorch port: disaggregated prefill/decode (`serving/replica.py`,
`serving/router.py`) on the CPU.

The reference's `tests/test_replica_parity.py` on the port: a request
that chunk-prefills on one replica, migrates as a `KVEnvelope` through
the real wire bytes and decodes on another emits EXACTLY the tokens and
logprobs of one port server, over {none, kv8, kv4} x {flat, tiered},
synchronous and overlapped (where imports land while a decode step is in
flight); the wire roundtrip; import backpressure; an abort while held;
the cross-replica prefix index (flat, and tiered, where warmed pages
land in the capacity store); a layout mismatch.  Also a window-ring
arch (gemma3-12b) and RWKV6, which the reference migrates too, and the
page reader and slot-row writer against the reference's on the same
pool.

Across the packages: envelopes exported by a reference replica import
into a port replica and decode to the reference single server's tokens
(greedy and seeded), and the reverse, with logprobs within the pool
format's gap (ROADMAP §C: 1e-4 on float32 pools, 1e-2 kv8, 1e-1 kv4);
both packages' envelopes carry the same paths, dtypes and header.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import EngineConfig as JEngineConfig
from repro.configs import get_config
from repro.core import paged_kv as jkv
from repro.models.registry import Model
from repro.serving import replica as jrep
from repro.serving.api import KVNANDServer as JServer
from repro.serving.api import ServerConfig as JConfig
from repro.serving.sampler import SamplingParams as JParams
from repro_torch import bridge
from repro_torch.configs import EngineConfig
from repro_torch.configs import get_config as tget
from repro_torch.core import paged_kv
from repro_torch.serving import replica as replica_mod
from repro_torch.serving import router as router_mod
from repro_torch.serving.api import KVNANDServer, ServerConfig
from repro_torch.serving.replica import KVEnvelope, export_request
from repro_torch.serving.router import ReplicaRouter
from repro_torch.serving.sampler import SamplingParams

torch.set_num_threads(2)

ARCH = "qwen1.5-0.5b"
TOTAL_PAGES = 64
HOT_PAGES = 12
LOGPROB_TOL = {"none": 1e-4, "kv8": 1e-2, "kv4": 1e-1}

_CACHE = {}


def _weights(arch=ARCH):
    """(reference cfg, reference params, port cfg, port params): the same
    weights in both packages."""
    if arch not in _CACHE:
        cfg = get_config(arch).reduced()
        params = Model(cfg).init(jax.random.PRNGKey(0))
        _CACHE[arch] = (cfg, params, tget(arch).reduced(),
                        bridge.params_from_numpy(
                            jax.tree.map(np.asarray, params), "cpu"))
    return _CACHE[arch]


def _eng_kw(kv_quant="none", hot_pages=0, **kw):
    return dict(page_tokens=16, uniform_lengths=False, shared_pool=True,
                total_pages=TOTAL_PAGES, hot_pages=hot_pages,
                kv_quant=kv_quant, **kw)


def _server(kv_quant="none", hot_pages=0, slots=3, overlap=False,
            arch=ARCH, max_context=64, **eng):
    _, _, cfg, params = _weights(arch)
    sc = ServerConfig(engine=EngineConfig(**_eng_kw(kv_quant, hot_pages,
                                                    **eng)),
                      batch_slots=slots, max_context=max_context,
                      prefill_chunk_tokens=16, seed=7, overlap=overlap,
                      device="cpu")
    return KVNANDServer(sc, cfg=cfg, params=params)


def _jserver(kv_quant="none", slots=3, arch=ARCH, max_context=64, **eng):
    cfg, params, _, _ = _weights(arch)
    sc = JConfig(engine=JEngineConfig(**_eng_kw(kv_quant, **eng)),
                 batch_slots=slots, max_context=max_context,
                 prefill_chunk_tokens=16, seed=7)
    return JServer(sc, cfg=cfg, params=params)


def _prompts(vocab):
    rng = np.random.default_rng(11)
    sysp = rng.integers(1, vocab, 18).tolist()
    return [sysp + rng.integers(1, vocab, k).tolist() for k in (3, 9, 1)]


PARAMS = [dict(max_new_tokens=8, temperature=0.0, logprobs=True),
          dict(max_new_tokens=8, temperature=0.9, top_k=20, logprobs=True),
          dict(max_new_tokens=6, temperature=0.7, top_p=0.9,
               logprobs=True, seed=123)]


def _solo(server, prompts, params_cls=SamplingParams):
    uids = [server.submit(p, params_cls(**sp), uid=100 + i)
            for i, (p, sp) in enumerate(zip(prompts, PARAMS))]
    server.run()
    return {u: server.output(u) for u in uids}


def _conserved(servers):
    for s in servers:
        b = s._batcher
        for a in (b.alloc, b.alloc_w):
            if a is not None:
                a.check()
        if b.tier is not None:
            b.tier.check()
            assert b.tier.pinned_count == 0


@pytest.mark.parametrize("overlap", [False, True], ids=["sync", "overlap"])
@pytest.mark.parametrize("hot_pages", [0, HOT_PAGES],
                         ids=["flat", "tiered"])
@pytest.mark.parametrize("kv_quant", ["none", "kv8", "kv4"])
def test_disaggregated_token_identity(kv_quant, hot_pages, overlap,
                                      monkeypatch):
    prompts = _prompts(_weights()[2].vocab_size)
    ref = _solo(_server(kv_quant, hot_pages), prompts)

    in_flight = []
    real_import = router_mod.import_request

    def spy(batcher, env):
        in_flight.append(batcher.pending_steps)
        return real_import(batcher, env)

    monkeypatch.setattr(router_mod, "import_request", spy)
    servers = [_server(kv_quant, hot_pages, overlap=overlap)
               for _ in range(3)]
    router = ReplicaRouter(servers, disaggregate=True)
    uids = [router.submit(p, SamplingParams(**sp), uid=100 + i)
            for i, (p, sp) in enumerate(zip(prompts, PARAMS))]
    router.run()

    assert router.stats["migrations"] == len(uids)
    assert router.stats["migration_bytes"] > 0
    # overlapped decode replicas take imports with a step in flight
    assert any(in_flight) == overlap
    for u in uids:
        out, want = router.output(u), ref[u]
        assert router.replica_of(u) in (1, 2)      # decoded off-replica
        assert out.token_ids == want.token_ids
        assert out.logprobs == want.logprobs
        assert out.finish_reason == want.finish_reason
    assert servers[0].stats["migrations_out"] == len(uids)
    assert sum(s.stats.get("migrations_in", 0) for s in servers[1:]) == \
        len(uids)
    _conserved(servers)


@pytest.mark.parametrize("arch", ["gemma3-12b", "rwkv6-3b", "hymba-1.5b",
                                  "mixtral-8x7b"])
def test_disaggregated_window_and_recurrent_archs(arch):
    """Window rings (ring pages + `page_pos_w`), RWKV6 state rows and
    hymba's (ring and global pages, SSM state and conv tail, a length
    that counts the meta tokens) migrate, and mixtral's pages (its MoE
    runs on the prefill replica's chunks as on one server's): the router
    serves one server's tokens exactly."""
    vocab = _weights(arch)[2].vocab_size
    rng = np.random.default_rng(1)
    prompts = [rng.integers(1, vocab, k).tolist() for k in (5, 90, 30)]
    kw = dict(arch=arch, max_context=160, kv_dtype="float32")
    ref = _server(**kw)
    sp = SamplingParams(max_new_tokens=8, logprobs=True, temperature=0.8,
                        top_k=10)
    for i, p in enumerate(prompts):
        ref.submit(p, sp, uid=i)
    ref.run()
    servers = [_server(slots=2, **kw) for _ in range(2)]
    router = ReplicaRouter(servers, disaggregate=True)
    for i, p in enumerate(prompts):
        router.submit(p, sp, uid=i)
    router.run()
    assert router.stats["migrations"] == len(prompts)
    for i in range(len(prompts)):
        assert router.output(i).token_ids == ref.output(i).token_ids
        assert router.output(i).logprobs == ref.output(i).logprobs
    _conserved(servers)


def _hold_until_handoff(server, prompts, params, steps=50):
    """Submit held requests and step until each has its prefill handoff
    token (works on either package's server)."""
    uids = [server.submit(p, sp, uid=100 + i)
            for i, (p, sp) in enumerate(zip(prompts, params))]
    b = server._batcher
    for u in uids:
        server._requests[u].hold = True
    for _ in range(steps):
        if all(server._requests[u].output for u in uids) \
                and not b._prefill_live:
            return uids
        server.step()
    raise AssertionError("prefill handoff never reached")


@pytest.mark.parametrize("mode", ["sync", "overlap", "spec"])
def test_held_slot_is_left_out_of_every_decode_dispatch(mode):
    """A held request keeps its handoff token, its length and its page
    bytes while a neighbour decodes beside it: synchronous steps, an
    overlapped dispatch / collect chain, and speculative verify steps."""
    prompts = _prompts(_weights()[2].vocab_size)
    srv = _server(slots=2)
    b = srv._batcher
    b.spec_k = 2 if mode == "spec" else 0
    (held,) = _hold_until_handoff(srv, prompts[:1],
                                  [SamplingParams(**PARAMS[0])])
    i = next(j for j, r in enumerate(b.slots) if r is not None)
    pages = dict(b._slot_pages[i])
    before = {p: paged_kv.read_page_bytes(b.cache, p, b._pool_leaves)
              for p in pages.values()}
    other = srv.submit(prompts[1] * 2, SamplingParams(max_new_tokens=10))
    steps0 = b.stats["decode_steps"] + b.stats["verify_steps"]
    for _ in range(14):
        if mode == "overlap":
            b.dispatch()
            b.dispatch()
            b.collect()
        else:
            srv.step()
    while b.pending_steps:
        b.collect()
    assert b.stats["decode_steps"] + b.stats["verify_steps"] > steps0
    assert srv._requests[other].done
    if mode == "spec":
        assert b.stats["verify_steps"] > 0
    req = srv._requests[held]
    assert len(req.output) == 1 and not req.done
    assert b._lengths[i] == len(req.prompt)
    assert int(b.cache.lengths[i]) == len(req.prompt)
    assert b._slot_pages[i] == pages
    for p, vals in before.items():
        now = paged_kv.read_page_bytes(b.cache, p, b._pool_leaves)
        for n in vals:
            assert np.array_equal(now[n], vals[n]), (p, n)


def test_envelope_wire_roundtrip():
    """from_bytes(to_bytes(env)) reproduces every leaf and the header; a
    kv8 envelope carries the scale leaves."""
    prompts = _prompts(_weights()[2].vocab_size)
    srv = _server(kv_quant="kv8")
    (uid,) = _hold_until_handoff(srv, prompts[1:2],
                                 [SamplingParams(**PARAMS[1])])
    env = export_request(srv._batcher, uid)
    assert any(k.endswith("k_scale_g") for k in env.arrays), \
        "kv8 scales missing from envelope"
    env2 = KVEnvelope.from_bytes(env.to_bytes())
    assert env2.meta == env.meta
    assert set(env2.arrays) == set(env.arrays)
    for k in env.arrays:
        np.testing.assert_array_equal(env2.arrays[k], env.arrays[k])
    assert len(env.to_bytes()) >= env.nbytes()
    bad = dataclasses.replace(env, meta={**env.meta, "version": 2})
    with pytest.raises(ValueError, match="version"):
        KVEnvelope.from_bytes(bad.to_bytes())


def test_import_backpressure_retries_then_lands():
    """A decode replica with no free slot refuses the import (the source
    keeps its pages); the migration lands once a slot frees."""
    prompts = _prompts(_weights()[2].vocab_size)
    pre = _server(slots=2)
    dec = _server(slots=1)
    router = ReplicaRouter([pre, dec], disaggregate=True)
    sp = SamplingParams(**{**PARAMS[0], "max_new_tokens": 12})
    uids = [router.submit(p, sp, uid=i) for i, p in enumerate(prompts)]
    router.run()
    assert router.stats["migrations"] == len(uids)
    assert router.stats["migration_retries"] > 0, \
        "1-slot decode replica never exerted backpressure"
    srv = _server()
    for i, p in enumerate(prompts):
        srv.submit(p, sp, uid=i)
    srv.run()
    for u in uids:
        assert router.output(u).token_ids == srv.output(u).token_ids
    _conserved([pre, dec])


def test_import_refuses_a_footprint_the_pool_cannot_fund():
    """Pool pressure, not slots: a destination whose free pages net of
    reservations cannot fund the worst case returns None and changes
    nothing."""
    prompts = _prompts(_weights()[2].vocab_size)
    pre = _server()
    (uid,) = _hold_until_handoff(pre, prompts[:1],
                                 [SamplingParams(**PARAMS[0])])
    env = export_request(pre._batcher, uid)
    dec = _server()
    b = dec._batcher
    b._outstanding = b.alloc.free_count        # every free page reserved
    live = b.alloc.live_count
    assert replica_mod.import_request(b, env) is None
    assert b.alloc.live_count == live and all(r is None for r in b.slots)
    b._outstanding = 0
    assert replica_mod.import_request(b, env) is not None


def test_abort_held_request_conserves_pages():
    """Aborting a request while it sits HELD awaiting migration frees its
    source pages; nothing reaches the decode replica."""
    prompts = _prompts(_weights()[2].vocab_size)
    pre = _server(slots=2)
    dec = _server(slots=1)
    router = ReplicaRouter([pre, dec], disaggregate=True)
    uids = [router.submit(p, SamplingParams(**PARAMS[0]), uid=i)
            for i, p in enumerate(prompts)]
    for _ in range(30):
        pre.step()
    held = [r.uid for r in pre._batcher.slots
            if r is not None and r.hold and r.output]
    assert held, "no request reached the held state"
    assert router.abort(held[0])
    router.run()
    assert router.output(held[0]).finish_reason == "aborted"
    for u in uids:
        if u != held[0]:
            assert router.output(u).finish_reason in ("stop", "length")
    _conserved([pre, dec])
    assert dec._batcher.stats.get("migrations_in", 0) == len(uids) - 1


@pytest.mark.parametrize("hot_pages", [0, HOT_PAGES],
                         ids=["flat", "tiered"])
def test_cross_replica_prefix_index(hot_pages):
    """Routed mode: pages warmed on one replica admit as prefix hits on
    another through the PrefixPageIndex, token-identically (a tiered
    replica takes them into its capacity store and promotes them)."""
    cfg = _weights()[2]
    rng = np.random.default_rng(3)
    sysp = rng.integers(1, cfg.vocab_size, 32).tolist()
    prompts = [sysp + rng.integers(1, cfg.vocab_size, 5).tolist()
               for _ in range(4)]
    sp = SamplingParams(max_new_tokens=6)
    ref = {}
    solo = _server(hot_pages=hot_pages)
    for i, p in enumerate(prompts):
        u = solo.submit(p, sp, uid=i)
        solo.run()
        ref[u] = solo.output(u).token_ids

    servers = [_server(hot_pages=hot_pages), _server(hot_pages=hot_pages)]
    router = ReplicaRouter(servers, share_prefix=True)
    assert router.index is not None
    for i, p in enumerate(prompts):
        router.submit(p, sp, uid=i)
        router.run()
    for i in range(len(prompts)):
        assert router.output(i).token_ids == ref[i]
    assert router.stats["prefix_published_pages"] > 0
    assert router.stats["prefix_warmed_pages"] > 0, \
        "warm path never imported a page cross-replica"
    hits = sum(s.stats.get("prefix_hit_pages", 0) for s in servers)
    assert hits > 0, "warmed pages never produced a prefix hit"
    if hot_pages:
        assert sum(s.stats["tier_promotes"] for s in servers) > 0
    _conserved(servers)


def test_import_rejects_layout_mismatch():
    prompts = _prompts(_weights()[2].vocab_size)
    pre = _server(kv_quant="kv8")
    dec = _server(kv_quant="kv4")
    (uid,) = _hold_until_handoff(pre, prompts[:1],
                                 [SamplingParams(**PARAMS[0])])
    env = export_request(pre._batcher, uid)
    with pytest.raises(ValueError, match="kv_quant"):
        replica_mod.import_request(dec._batcher, env)
    stripe = KVNANDServer(ServerConfig(
        engine=EngineConfig(page_tokens=16, uniform_lengths=False),
        batch_slots=2, max_context=64, device="cpu"),
        cfg=_weights()[2], params=_weights()[3])
    with pytest.raises(ValueError, match="shared-pool"):
        replica_mod.import_request(stripe._batcher, env)


def test_page_reader_and_row_writer_match_the_reference():
    """`paged_kv.read_page_bytes` reads what the reference's
    `_page_bytes` reads from the same pool bytes, and `import_slot_rows`
    writes what the reference's writer writes."""
    rng = np.random.default_rng(4)
    k = rng.standard_normal((2, 2, 5, 16, 8)).astype(np.float32)
    jc = jkv.DecodeCache(k_pages_g=jnp.asarray(k), v_pages_g=jnp.asarray(-k),
                         page_pos_w=jnp.zeros((3, 4), jnp.int32),
                         lengths=jnp.zeros(3, jnp.int32))
    tc = paged_kv.DecodeCache(k_pages_g=torch.from_numpy(k.copy()),
                              v_pages_g=torch.from_numpy(-k),
                              page_pos_w=torch.zeros((3, 4),
                                                     dtype=torch.int32),
                              lengths=torch.zeros(3, dtype=torch.int32))
    leaves = ("k_pages_g", "v_pages_g")
    got = paged_kv.read_page_bytes(tc, 3, leaves)
    for n in leaves:
        want = np.asarray(getattr(jc, n)[:, :, 3])
        assert got[n].dtype == want.dtype and np.array_equal(got[n], want)
    rows = {"lengths": np.asarray(37),
            "page_pos_w": np.array([32, 48, -5, 16], np.int32)}
    jc = jkv.import_slot_rows(jc, 1, rows)
    paged_kv.import_slot_rows(tc, 1, rows)
    for n in ("lengths", "page_pos_w"):
        assert np.array_equal(getattr(tc, n).numpy(),
                              np.asarray(getattr(jc, n)))


# ---------------------------------------------------------------------------
# envelopes cross between the packages
# ---------------------------------------------------------------------------

def _import_all(server, mod, envs):
    for env in envs:
        req = mod.import_request(server._batcher, env)
        assert req is not None
        server._requests[req.uid] = req
        server._streamed[req.uid] = len(req.output)
        server._next_uid = max(server._next_uid, req.uid + 1)
    server.run()
    return {e.uid: server.output(e.uid) for e in envs}


def _close(got, want, tol):
    for u in want:
        assert got[u].token_ids == want[u].token_ids, u
        np.testing.assert_allclose(got[u].logprobs, want[u].logprobs,
                                   atol=tol)


@pytest.mark.parametrize("kv_quant", ["none", "kv8", "kv4"])
def test_envelopes_cross_between_the_packages(kv_quant):
    """A reference replica's envelope decodes in a port replica to the
    reference single server's tokens, and a port replica's in a
    reference replica to the port single server's."""
    _cross_packages(kv_quant, _prompts(_weights()[2].vocab_size))


@pytest.mark.parametrize("kv_quant", ["none", "kv8"])
def test_hybrid_envelopes_cross_between_the_packages(kv_quant):
    """hymba's envelopes (ring and global pages, `page_pos_w`, the SSM
    state and conv tail rows, a length counting the meta tokens) cross
    both ways, one prompt wrapping the ring."""
    arch = "hymba-1.5b"
    rng = np.random.default_rng(11)
    prompts = [rng.integers(1, _weights(arch)[2].vocab_size, k).tolist()
               for k in (5, 80, 21)]
    _cross_packages(kv_quant, prompts, arch=arch, max_context=160)


def _cross_packages(kv_quant, prompts, **server_kw):
    eng = dict(kv_dtype="float32", **server_kw)
    jparams = [JParams(**sp) for sp in PARAMS]
    tparams = [SamplingParams(**sp) for sp in PARAMS]
    want_j = _solo(_jserver(kv_quant, **eng), prompts, JParams)
    want_t = _solo(_server(kv_quant, **eng), prompts)

    jpre, tpre = _jserver(kv_quant, **eng), _server(kv_quant, **eng)
    juids = _hold_until_handoff(jpre, prompts, jparams)
    tuids = _hold_until_handoff(tpre, prompts, tparams)
    jenvs = [jrep.export_request(jpre._batcher, u) for u in juids]
    tenvs = [export_request(tpre._batcher, u) for u in tuids]
    for je, te in zip(jenvs, tenvs):
        assert set(je.arrays) == set(te.arrays)
        for k in je.arrays:
            assert je.arrays[k].dtype == te.arrays[k].dtype, k
            assert je.arrays[k].shape == te.arrays[k].shape, k
        skip = ("submit_ts", "first_ts")
        assert {k: v for k, v in je.meta.items() if k not in skip} == \
            {k: v for k, v in te.meta.items() if k not in skip}

    tol = LOGPROB_TOL[kv_quant]
    got = _import_all(_server(kv_quant, **eng), replica_mod,
                      [KVEnvelope.from_bytes(e.to_bytes()) for e in jenvs])
    _close(got, want_j, tol)
    got = _import_all(_jserver(kv_quant, **eng), jrep,
                      [jrep.KVEnvelope.from_bytes(e.to_bytes())
                       for e in tenvs])
    _close(got, want_t, tol)
