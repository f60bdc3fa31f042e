"""PyTorch port: mixtral (reduced: 2 layers, 4 experts, top-2) served end to
end on the CPU against the JAX server on the same bridged weights, at the
reference's capacity factor 1.25, where tokens past an expert's capacity
are dropped.

`moe` is a different function at every length it is called with (its
capacity C is taken from the call's padded length), so each scheduler is
held to its own reference counterpart: the interleaved scheduler calls
it on 16-token chunk buckets, the splice scheduler on power-of-two
one-shot buckets, a verify step on its k + 1 span, decode on single
tokens.  16-token pages and chunks (C = 10 of a chunk's 32 pairs), 2
slots, prompts of 3-70 tokens, two of them behind one 32-token prefix so
that the shared pool's prefix cache maps pages and the later chunk starts
at the hit.

  * Both schedulers, stripe and shared pools, compact and discrete,
    synchronous and overlapped, f32 / kv8 / kv4 pages, W4A16 / W8A8
    experts, speculation at k = 4: greedy tokens identical to the
    reference's (on kv4 they may part at a near tie only, as
    tests/test_torch_window_server.py explains, and so may speculation
    over kv8, whose verify the reference computes from the span's
    full-precision K/V: ROADMAP §C), logprobs within 1e-4 at
    f32, the format's tolerance otherwise (tests/test_torch_quant_server.py),
    and the scheduler's counters (prefix hits and COW copies included)
    equal.
  * The capacity shows: at 1.25 the splice and interleaved schedulers
    serve other tokens than each other in BOTH packages, and at E / top_k
    (no drops) they serve the same ones, as do speculative and sequential
    decode (the mirror of tests/test_torch_speculative.py's
    `test_spec_matches_sequential`).
  * The HTTP front end over a shared mixtral pool answers concurrent
    completions with `generate()`'s tokens."""
import http.client
import json
import threading

import jax
import numpy as np
import pytest
import torch

from repro.configs import EngineConfig, get_config
from repro.core.quant import quantize_params
from repro.models.registry import Model
from repro.models.transformer import Runtime as JRuntime
from repro.serving.api import KVNANDServer as JServer
from repro.serving.api import SamplingParams as JParams
from repro.serving.api import ServerConfig as JConfig
from repro_torch import bridge
from repro_torch.configs import EngineConfig as TEngineConfig
from repro_torch.configs import get_config as tget
from repro_torch.models.transformer import Runtime
from repro_torch.serving.api import KVNANDServer, SamplingParams, ServerConfig
from repro_torch.serving.async_server import (AsyncServerConfig,
                                              BackgroundServer)

torch.set_num_threads(2)

ARCH = "mixtral-8x7b"
SERVE = dict(batch_slots=2, max_context=160, prefill_chunk_tokens=16)
MAX_NEW = 12
LOGPROB_TOL = {"f32": 1e-4, "kv8": 1e-2, "kv4": 1e-1, "w4a16": 1e-2,
               "w8a8": 7e-2}
FORMATS = {"f32": dict(kv_dtype="float32"), "kv8": dict(kv_quant="kv8"),
           "kv4": dict(kv_quant="kv4"), "w4a16": dict(kv_dtype="float32"),
           "w8a8": dict(kv_dtype="float32")}
COUNTERS = ("admits", "prefill_chunks", "steps", "prefix_hit_pages",
            "cow_copies")
NO_DROP = 2.0                      # E / top_k at the reduced 4 experts
_CACHE = {}
_REFS = {}


def _weights(quant="none"):
    """(reference cfg, reference params, port cfg, port params)."""
    if quant not in _CACHE:
        cfg = get_config(ARCH).reduced()
        params = quantize_params(Model(cfg).init(jax.random.PRNGKey(0)),
                                 quant)
        tparams = bridge.params_from_numpy(jax.tree.map(np.asarray, params),
                                           "cpu")
        _CACHE[quant] = (cfg, params, tget(ARCH).reduced(), tparams)
    return _CACHE[quant]


def _prompts(vocab=512):
    """Six prompts; the first and the fourth share a 32-token prefix (two
    pages), and the fourth is admitted after the first has registered
    it."""
    r = np.random.default_rng(0)
    prefix = r.integers(1, vocab, 32).tolist()
    return [prefix + r.integers(1, vocab, 8).tolist(),
            r.integers(1, vocab, 5).tolist(),
            r.integers(1, vocab, 70).tolist(),
            prefix + r.integers(1, vocab, 40).tolist(),
            r.integers(1, vocab, 17).tolist(),
            r.integers(1, vocab, 3).tolist()]


def _eng_kw(fmt="f32", **kw):
    return dict(page_tokens=16, uniform_lengths=False, **FORMATS[fmt], **kw)


def _quant(fmt):
    return fmt if fmt in ("w4a16", "w8a8") else "none"


def _port(fmt="f32", scheduler="interleaved", overlap=False, spec=0,
          capacity=1.25, **kw):
    _, _, tcfg, tparams = _weights(_quant(fmt))
    return KVNANDServer(ServerConfig(
        engine=TEngineConfig(**_eng_kw(fmt, **kw)), scheduler=scheduler,
        overlap=overlap, speculation_k=spec, device="cpu", **SERVE),
        cfg=tcfg, params=tparams, rt=Runtime(moe_capacity=capacity))


def _reference(fmt="f32", scheduler="interleaved", overlap=False, spec=0,
               capacity=1.25, **kw):
    cfg, params, _, _ = _weights(_quant(fmt))
    return JServer(JConfig(engine=EngineConfig(**_eng_kw(fmt, **kw)),
                           scheduler=scheduler, overlap=overlap,
                           speculation_k=spec, **SERVE),
                   cfg=cfg, params=params,
                   rt=JRuntime(moe_capacity=capacity))


def _tokens(srv):
    outs = srv.generate(_prompts(), SamplingParams(max_new_tokens=MAX_NEW))
    return [o.token_ids for o in outs]


def _reference_outputs(fmt="f32", scheduler="interleaved", overlap=False,
                       spec=0, **kw):
    """The reference server's outputs (logprobs on) and stats for one
    configuration, served once per module and shared by every test that
    holds a port server to it."""
    key = (fmt, scheduler, overlap, spec, tuple(sorted(kw.items())))
    if key not in _REFS:
        ref = _reference(fmt, scheduler, overlap, spec, **kw)
        outs = ref.generate(_prompts(), JParams(max_new_tokens=MAX_NEW,
                                                logprobs=True))
        _REFS[key] = (outs, dict(ref.stats))
    return _REFS[key]


# (scheduler, shared, fmt, variant, overlap, speculation_k)
CASES = [("interleaved", False, "f32", "compact", False, 0),
         ("interleaved", True, "f32", "compact", False, 0),
         ("splice", False, "f32", "compact", False, 0),
         ("interleaved", False, "f32", "discrete", False, 0),
         ("interleaved", True, "f32", "discrete", True, 0),
         ("interleaved", False, "f32", "compact", True, 0),
         ("interleaved", False, "f32", "compact", False, 4),
         ("interleaved", True, "f32", "compact", False, 4),
         ("interleaved", False, "kv8", "compact", False, 0),
         ("interleaved", True, "kv8", "compact", False, 4),
         ("interleaved", False, "kv4", "compact", False, 0),
         ("interleaved", True, "kv4", "discrete", False, 0),
         ("interleaved", False, "w4a16", "compact", False, 0),
         ("interleaved", True, "w8a8", "compact", False, 0)]


@pytest.mark.parametrize(
    "scheduler,shared,fmt,variant,overlap,spec", CASES,
    ids=[f"{s}-{'shared' if sh else 'stripe'}-{f}-{v}"
         f"{'-overlap' if o else ''}{f'-spec{k}' if k else ''}"
         for s, sh, f, v, o, k in CASES])
def test_server_matches_reference(scheduler, shared, fmt, variant, overlap,
                                  spec):
    kw = dict(shared_pool=shared, variant=variant)
    want, ref_stats = _reference_outputs(fmt, scheduler, overlap, spec, **kw)
    prompts = _prompts()
    sp = dict(max_new_tokens=MAX_NEW, logprobs=True)
    srv = _port(fmt, scheduler, overlap, spec, **kw)
    got = srv.generate(prompts, SamplingParams(**sp))
    tol = LOGPROB_TOL[fmt]
    for w, g in zip(want, got):
        assert g.finish_reason == w.finish_reason == "length"
        n = len(w.token_ids)
        if (fmt == "kv4" or fmt == "kv8" and spec) \
                and g.token_ids != w.token_ids:
            # the step where a kv4 code tie (or, under speculation, the
            # reference's full-precision span against the port's
            # requantized pages, ROADMAP §C) parted them, and its picks
            n = next(i for i, (a, b) in enumerate(zip(g.token_ids,
                                                      w.token_ids)) if a != b)
            np.testing.assert_allclose(g.logprobs[n], w.logprobs[n],
                                       atol=tol)
        assert g.token_ids[:n] == w.token_ids[:n]
        np.testing.assert_allclose(g.logprobs[:n], w.logprobs[:n], atol=tol)
    for key in COUNTERS:
        assert srv.stats.get(key, 0) == ref_stats.get(key, 0), key
    if spec:
        assert srv.stats["spec_accepted"] > 0
        for w, g in zip(want, got):
            if g.token_ids == w.token_ids:
                assert (g.spec_steps, g.spec_drafted, g.spec_accepted) == (
                    w.spec_steps, w.spec_drafted, w.spec_accepted)
    b = srv._batcher
    if shared:
        if scheduler == "interleaved":
            assert srv.stats["prefix_hit_pages"] >= 2
        b.alloc.check()


def test_capacity_sets_the_schedulers_apart_in_both_packages():
    """At the reference capacity the interleaved scheduler (16-token
    chunks) and the splice scheduler (one-shot buckets of 32-128 tokens)
    run `moe` at other lengths, drop other tokens and serve other
    tokens: in the reference and in the port alike.  At E / top_k nothing
    drops, and the two serve the same tokens."""
    inter, splice = _tokens(_port()), _tokens(_port(scheduler="splice"))
    assert inter != splice
    for scheduler, tokens in (("interleaved", inter), ("splice", splice)):
        outs, _ = _reference_outputs(scheduler=scheduler,
                                     shared_pool=False, variant="compact")
        assert [o.token_ids for o in outs] == tokens
    assert _tokens(_port(capacity=NO_DROP)) == _tokens(
        _port(scheduler="splice", capacity=NO_DROP))


@pytest.mark.parametrize("shared", [False, True], ids=["stripe", "shared"])
def test_spec_matches_sequential_without_drops(shared):
    """A verify step runs `moe` on the k + 1 span, where sequential decode
    runs it on one token: with no drops the two compute the same
    function, and speculation serves sequential decode's tokens."""
    seq = _tokens(_port(capacity=NO_DROP, shared_pool=shared))
    srv = _port(spec=4, capacity=NO_DROP, shared_pool=shared)
    assert _tokens(srv) == seq
    assert srv.stats["verify_steps"] > 0


def test_http_front_end_serves_mixtral():
    _, _, tcfg, tparams = _weights()
    config = ServerConfig(engine=TEngineConfig(**_eng_kw(shared_pool=True)),
                          device="cpu", **SERVE)
    prompts = _prompts()[:3]
    want = KVNANDServer(config, cfg=tcfg, params=tparams).generate(
        prompts, SamplingParams(max_new_tokens=6))
    got = [None] * len(prompts)

    def post(i):
        conn = http.client.HTTPConnection(*srv.address, timeout=120)
        try:
            conn.request("POST", "/v1/completions",
                         json.dumps({"prompt": prompts[i], "max_tokens": 6}),
                         {"Content-Type": "application/json"})
            r = conn.getresponse()
            got[i] = (r.status, json.loads(r.read()))
        finally:
            conn.close()

    with BackgroundServer(config=config,
                          async_config=AsyncServerConfig(overlap=True),
                          cfg=tcfg, params=tparams) as srv:
        threads = [threading.Thread(target=post, args=(i,))
                   for i in range(len(prompts))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=180)
    for w, (status, body) in zip(want, got):
        assert status == 200
        assert body["choices"][0]["token_ids"] == w.token_ids
