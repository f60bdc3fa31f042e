"""PyTorch port: `KVNANDServer` end to end on the CPU.

Greedy tokens must be identical to the JAX `KVNANDServer` built from the
same weights at a float32 pool, for an MHA (qwen1.5-0.5b) and a GQA
(llama3.1-8b) reduced config — with more prompts than slots, prompts
longer than one chunk (the past-page partial runs) and generations that
cross page boundaries; gemma3-12b's window rings the same way.  Also:
`outputs()` against the reference's, abort mid-prefill, the
NotImplementedError guard of what the port does not serve yet (a mesh),
pixtral's server serving and whisper's failing where the reference's
does, and the ValueError for an unknown scheduler name."""
import collections

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
from repro_torch.core.engine import KVNANDEngine
from repro_torch.serving.api import KVNANDServer, SamplingParams, ServerConfig

torch.set_num_threads(2)

SERVE = dict(batch_slots=2, max_context=96, prefill_chunk_tokens=16)
PROMPT_LENS = (5, 40, 17, 33, 3)      # 5 prompts > 2 slots; 3 span chunks
MAX_NEW = 20                          # decode crosses 16-token pages


def _prompts(vocab):
    r = np.random.default_rng(0)
    return [r.integers(1, vocab, n).tolist() for n in PROMPT_LENS]


def _port(arch, params=None, **kw):
    cfg = tget(arch).reduced()
    eng = TEngineConfig(page_tokens=16, uniform_lengths=False,
                        kv_dtype="float32")
    return KVNANDServer(ServerConfig(engine=eng, device="cpu", **SERVE, **kw),
                        cfg=cfg, params=params)


@pytest.mark.parametrize("arch", ["qwen1.5-0.5b", "llama3.1-8b"])
def test_greedy_tokens_identical_to_reference_server(arch):
    cfg = get_config(arch).reduced()
    params = Model(cfg).init(jax.random.PRNGKey(0))
    prompts = _prompts(cfg.vocab_size)
    eng = EngineConfig(page_tokens=16, uniform_lengths=False,
                       kv_dtype="float32")
    ref = JServer(JConfig(engine=eng, **SERVE), cfg=cfg, params=params)
    want = ref.generate(prompts, JParams(max_new_tokens=MAX_NEW,
                                         logprobs=True))
    srv = _port(arch, bridge.params_from_numpy(
        jax.tree.map(np.asarray, params), "cpu"))
    got = srv.generate(prompts, SamplingParams(max_new_tokens=MAX_NEW,
                                               logprobs=True))
    assert srv.stats["prefill_chunks"] > len(prompts)   # multi-chunk prompts
    for w, g in zip(want, got):
        assert g.token_ids == w.token_ids
        assert g.finish_reason == w.finish_reason == "length"
        np.testing.assert_allclose(g.logprobs, w.logprobs, atol=1e-4)


def test_window_arch_serves_the_reference_tokens():
    """gemma3-12b (reduced: a local layer over a 64-token window, then a
    global one) serves the JAX server's greedy tokens, a prompt of 90
    tokens wrapping its 80-token ring in prefill."""
    cfg = get_config("gemma3-12b").reduced()
    params = Model(cfg).init(jax.random.PRNGKey(0))
    prompts = _prompts(cfg.vocab_size)
    prompts[1] = prompts[1] + prompts[3] + prompts[2]
    eng = EngineConfig(page_tokens=16, uniform_lengths=False,
                       kv_dtype="float32")
    serve = {**SERVE, "max_context": 128}
    want = JServer(JConfig(engine=eng, **serve), cfg=cfg,
                   params=params).generate(
        prompts, JParams(max_new_tokens=MAX_NEW, logprobs=True))
    srv = KVNANDServer(ServerConfig(engine=TEngineConfig(
        page_tokens=16, uniform_lengths=False, kv_dtype="float32"),
        device="cpu", **serve), cfg=tget("gemma3-12b").reduced(),
        params=bridge.params_from_numpy(jax.tree.map(np.asarray, params),
                                        "cpu"))
    got = srv.generate(prompts, SamplingParams(max_new_tokens=MAX_NEW,
                                               logprobs=True))
    assert len(prompts[1]) == 90
    for w, g in zip(want, got):
        assert g.token_ids == w.token_ids
        np.testing.assert_allclose(g.logprobs, w.logprobs, atol=1e-4)


def test_outputs_matches_reference_before_and_after_release():
    """`outputs()`: every finished, unreleased request in uid order, as
    the reference's; a released request leaves it, one in flight is not
    in it."""
    cfg = get_config("qwen1.5-0.5b").reduced()
    params = Model(cfg).init(jax.random.PRNGKey(0))
    eng = EngineConfig(page_tokens=16, uniform_lengths=False,
                       kv_dtype="float32")
    ref = JServer(JConfig(engine=eng, **SERVE), cfg=cfg, params=params)
    srv = _port("qwen1.5-0.5b", bridge.params_from_numpy(
        jax.tree.map(np.asarray, params), "cpu"))
    prompts = _prompts(cfg.vocab_size)
    lens = (3, 5, 2, 4, 6)

    def fields(outs):
        return [(o.uid, o.prompt, o.token_ids, o.finish_reason)
                for o in outs]

    for server, params_of in ((ref, JParams), (srv, SamplingParams)):
        for p, n in zip(prompts, lens):
            server.submit(p, params_of(max_new_tokens=n))
    assert srv.outputs() == [] and ref.outputs() == []
    for _ in range(4):
        ref.step()
        srv.step()
        assert fields(srv.outputs()) == fields(ref.outputs())
    assert 0 < len(srv.outputs()) < len(prompts)
    ref.run()
    srv.run()
    assert fields(srv.outputs()) == fields(ref.outputs())
    assert [o.uid for o in srv.outputs()] == list(range(len(prompts)))
    for u in (3, 0):
        ref.release(u)
        srv.release(u)
    assert fields(srv.outputs()) == fields(ref.outputs())
    assert [o.uid for o in srv.outputs()] == [1, 2, 4]


def test_stream_events_concatenate_to_outputs():
    srv = _port("qwen1.5-0.5b")
    prompts = _prompts(512)[:3]
    uids = [srv.submit(p, SamplingParams(max_new_tokens=6)) for p in prompts]
    seen = collections.defaultdict(list)
    for ev in srv.stream():
        seen[ev.uid].append(ev.token)
    for u in uids:
        assert seen[u] == srv.output(u).token_ids
        assert len(seen[u]) == 6


def test_seeded_sampling_is_independent_of_batch_company():
    """A seeded stochastic request draws the same tokens alone and next to
    other requests: its noise is keyed by (seed, tokens emitted) only."""
    prompts = _prompts(512)
    hot = SamplingParams(temperature=0.9, top_k=40, top_p=0.9, seed=7,
                         max_new_tokens=12)
    alone = _port("qwen1.5-0.5b").generate([prompts[1]], hot)[0]
    crowd = _port("qwen1.5-0.5b").generate(
        [prompts[0], prompts[1], prompts[2]],
        [SamplingParams(max_new_tokens=5), hot,
         SamplingParams(temperature=1.3, seed=1, max_new_tokens=9)])
    assert crowd[1].token_ids == alone.token_ids
    assert len(set(alone.token_ids)) > 1


def test_abort_mid_prefill_frees_the_slot():
    srv = _port("qwen1.5-0.5b", step_token_budget=1)
    long = _prompts(512)[1]                       # 40 tokens: 3 chunks
    a = srv.submit(long, SamplingParams(max_new_tokens=4))
    b = srv.submit([7, 8, 9], SamplingParams(max_new_tokens=4))
    srv.step()                                    # first chunk of each
    assert 0 in srv._batcher._prefill_live        # `a` is mid-prefill
    assert srv.abort(a)
    assert not srv.abort(a)                       # already finished
    events = srv.run()
    assert srv.output(a).finish_reason == "aborted"
    assert srv.output(a).token_ids == []
    assert srv.output(b).finish_reason == "length"
    assert [e.finish_reason for e in events if e.uid == a] == ["aborted"]
    assert srv._batcher.slots == [None, None]


def _vlm_and_encdec_servers():
    """pixtral's server constructs and serves; whisper's constructs and
    its first step raises the reference's chunked-prefill ValueError."""
    srv = KVNANDServer(ServerConfig(arch="pixtral-12b", reduced=True,
                                    device="cpu"))
    assert len(srv.generate([[1, 2, 3]],
                            SamplingParams(max_new_tokens=2))[0].token_ids) == 2
    srv = KVNANDServer(ServerConfig(arch="whisper-base", reduced=True,
                                    device="cpu"))
    srv.submit([1, 2, 3], SamplingParams(max_new_tokens=2))
    srv.step()


@pytest.mark.parametrize("make,err,match", [
    (_vlm_and_encdec_servers, ValueError, "encoder-decoder archs"),
], ids=["vlm_arch"])
def test_unported_configurations_raise(make, err, match):
    """The VLM and encoder-decoder families are ported: the one serves,
    the other fails where the reference's server does."""
    with pytest.raises(err, match=match):
        make()


def test_an_engine_on_a_mesh_serves():
    """An engine on a (data 2, model 4) mesh of CPU entries (which the
    port once refused) prefills and decodes, its tokens the single
    device's; tests/test_torch_mesh_engine.py holds it to the
    reference."""
    from repro_torch.distributed.sharding import Mesh
    cfg = tget("qwen1.5-0.5b").reduced()
    params = bridge.params_from_numpy(jax.tree.map(
        np.asarray, Model(get_config("qwen1.5-0.5b").reduced()).init(
            jax.random.PRNGKey(0))), "cpu")
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        1, cfg.vocab_size, (4, 16)))
    out = []
    for mesh in (Mesh(["cpu"] * 8, ("data", "model"), shape=(2, 4)), None):
        e = KVNANDEngine(cfg, TEngineConfig(page_tokens=4,
                                            kv_dtype="float32"),
                         mesh=mesh, device="cpu")
        lg, c = e.prefill(params, {"tokens": toks}, 24)
        seq = [lg.argmax(-1)]
        for _ in range(3):
            lg, c = e.decode_step(params, c, seq[-1][:, None])
            seq.append(lg.argmax(-1))
        out.append(torch.stack(seq))
    assert torch.equal(out[0], out[1])


def test_unknown_scheduler_raises():
    with pytest.raises(ValueError, match="unknown scheduler"):
        ServerConfig(scheduler="nope", device="cpu")
