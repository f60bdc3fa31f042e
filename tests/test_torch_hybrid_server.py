"""PyTorch port: hymba (reduced: window 64 on layer 0, global layer 1, 8
meta tokens, ssm_state 8) served end to end on the CPU against the JAX
server on the same bridged weights.

16-token pages, so a ring holds 5 pages (80 tokens); the prompts wrap it
in prefill (8 meta + 90 tokens) and in decode (8 + 70 + 16).  More
prompts than slots.

  * Interleaved and splice schedulers, stripe and shared pools, compact
    and discrete variants, f32 / kv8 / kv4 pages, synchronous and
    overlapped: greedy tokens identical to the reference's (on kv4 they
    may part at a near tie only, as tests/test_torch_window_server.py
    explains for the ring writers' code ties), logprobs within 1e-4 at
    f32, 1e-2 at kv8, 1e-1 at kv4; the scheduler's counters equal.
  * W4A16 weights (the DSE's pick for hymba) on the stripe and shared
    pools against the reference's quantized server.
  * The reference's own hymba checks on the port (tests/test_interleave.py
    `test_interleaved_recurrent_and_prefix`, tests/test_shared_pool.py
    `test_shared_matches_stripe_recurrent_prefix_archs`): every prompt is
    ONE whole-prompt chunk, interleaved == splice, shared == stripe with
    the prefix cache off and both allocators clean.
  * The slot capacity counts the meta tokens, as in the reference.
  * The HTTP front end (`BackgroundServer`, overlapped engine loop) over
    a shared hymba pool answers concurrent completions with
    `generate()`'s tokens."""
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
from repro.serving.api import KVNANDServer as JServer
from repro.serving.api import SamplingParams as JParams
from repro.serving.api import ServerConfig as JConfig
from repro_torch import bridge
from repro_torch.configs import EngineConfig as TEngineConfig
from repro_torch.configs import get_config as tget
from repro_torch.serving.api import KVNANDServer, SamplingParams, ServerConfig
from repro_torch.serving.async_server import (AsyncServerConfig,
                                              BackgroundServer)

torch.set_num_threads(2)

ARCH = "hymba-1.5b"
SERVE = dict(batch_slots=2, max_context=192, prefill_chunk_tokens=16)
PROMPT_LENS = (5, 90, 17, 70, 3)
MAX_NEW = 16
LOGPROB_TOL = {"f32": 1e-4, "kv8": 1e-2, "kv4": 1e-1, "w4a16": 1e-2}
FORMATS = {"f32": dict(kv_dtype="float32"), "kv8": dict(kv_quant="kv8"),
           "kv4": dict(kv_quant="kv4"), "w4a16": dict(kv_dtype="float32")}
COUNTERS = ("admits", "prefill_chunks", "steps")
_CACHE = {}


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
    r = np.random.default_rng(0)
    return [r.integers(1, vocab, n).tolist() for n in PROMPT_LENS]


def _eng_kw(fmt="f32", **kw):
    return dict(page_tokens=16, uniform_lengths=False, **FORMATS[fmt], **kw)


def _port(fmt="f32", scheduler="interleaved", overlap=False, **kw):
    _, _, tcfg, tparams = _weights("w4a16" if fmt == "w4a16" else "none")
    return KVNANDServer(ServerConfig(
        engine=TEngineConfig(**_eng_kw(fmt, **kw)), scheduler=scheduler,
        overlap=overlap, device="cpu", **SERVE), cfg=tcfg, params=tparams)


def _tokens(srv):
    outs = srv.generate(_prompts(), SamplingParams(max_new_tokens=MAX_NEW))
    return [o.token_ids for o in outs]


CASES = [("interleaved", False, "f32", "compact", False),
         ("interleaved", True, "f32", "compact", False),
         ("splice", False, "f32", "compact", False),
         ("interleaved", False, "f32", "discrete", False),
         ("interleaved", True, "f32", "discrete", False),
         ("interleaved", False, "f32", "compact", True),
         ("interleaved", True, "f32", "compact", True),
         ("interleaved", False, "kv8", "compact", False),
         ("interleaved", True, "kv8", "compact", False),
         ("splice", False, "kv8", "compact", False),
         ("interleaved", False, "kv4", "compact", False),
         ("interleaved", True, "kv4", "discrete", False),
         ("interleaved", False, "w4a16", "compact", False),
         ("interleaved", True, "w4a16", "compact", False)]


@pytest.mark.parametrize(
    "scheduler,shared,fmt,variant,overlap", CASES,
    ids=[f"{s}-{'shared' if sh else 'stripe'}-{f}-{v}"
         f"{'-overlap' if o else ''}" for s, sh, f, v, o in CASES])
def test_server_matches_reference(scheduler, shared, fmt, variant, overlap):
    cfg, params, _, _ = _weights("w4a16" if fmt == "w4a16" else "none")
    kw = _eng_kw(fmt, shared_pool=shared, variant=variant)
    ref = JServer(JConfig(engine=EngineConfig(**kw), scheduler=scheduler,
                          overlap=overlap, **SERVE), cfg=cfg, params=params)
    prompts = _prompts(cfg.vocab_size)
    sp = dict(max_new_tokens=MAX_NEW, logprobs=True)
    want = ref.generate(prompts, JParams(**sp))
    srv = _port(fmt, scheduler, overlap, shared_pool=shared, variant=variant)
    got = srv.generate(prompts, SamplingParams(**sp))
    tol = LOGPROB_TOL[fmt]
    for w, g in zip(want, got):
        assert g.finish_reason == w.finish_reason == "length"
        n = len(w.token_ids)
        if fmt == "kv4" and g.token_ids != w.token_ids:
            # the step where a kv4 code tie parted them, and its picks
            n = next(i for i, (a, b) in enumerate(zip(g.token_ids,
                                                      w.token_ids)) if a != b)
            np.testing.assert_allclose(g.logprobs[n], w.logprobs[n],
                                       atol=tol)
        assert g.token_ids[:n] == w.token_ids[:n]
        np.testing.assert_allclose(g.logprobs[:n], w.logprobs[:n], atol=tol)
    for key in COUNTERS:
        assert srv.stats[key] == ref.stats[key], key
    b = srv._batcher
    if shared:
        assert b.prefix_cache is None          # prefix sharing off
        b.alloc.check()
        b.alloc_w.check()
        assert b.alloc_w.live_count == 0       # rings fully reclaimed


@pytest.mark.parametrize("fmt", ["f32", "kv8"])
def test_interleaved_matches_splice(fmt):
    """Every prompt is one whole-prompt chunk (8 meta + prompt tokens):
    still spliceless, still in place, the splice scheduler's tokens."""
    inter = _port(fmt)
    o1 = _tokens(inter)
    assert _tokens(_port(fmt, "splice")) == o1
    assert inter.stats["prefill_chunks"] == len(PROMPT_LENS)
    assert not inter._batcher.bucket_prompts


def test_shared_matches_stripe():
    o1 = _tokens(_port())
    srv = _port(shared_pool=True)
    assert _tokens(srv) == o1
    b = srv._batcher
    assert b.prefix_cache is None
    b.alloc.check()
    b.alloc_w.check()


def test_capacity_counts_the_meta_tokens():
    """A prompt may take max_context - 1 - n_meta_tokens tokens, and a
    slot's length counts the prefix, as in the reference."""
    srv = _port()
    b = srv._batcher
    cap = SERVE["max_context"] - 1 - 8
    with pytest.raises(ValueError, match="8 prefix tokens"):
        srv.submit(list(range(1, cap + 2)), SamplingParams(max_new_tokens=1))
    uid = srv.submit(list(range(1, 21)), SamplingParams(max_new_tokens=3))
    srv.step()          # the whole-prompt chunk, then its first decode
    assert b._lengths[0] == int(b.cache.lengths[0]) == 8 + 20 + 1
    srv.run()
    assert len(srv.output(uid).token_ids) == 3


def test_http_front_end_serves_hymba():
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
            t.join(timeout=120)
    for w, (status, body) in zip(want, got):
        assert status == 200
        assert body["choices"][0]["token_ids"] == w.token_ids
