"""PyTorch port: window-ring serving (gemma3-12b reduced: 2 layers, window
64, `global_every` 2) end to end on the CPU.

16-token pages, so a ring holds 5 pages (80 tokens).  The prompts wrap
the ring in prefill (90 tokens) and in decode (70 + 16 new), with more
prompts than slots.

  * The port's server against the JAX server on the same bridged
    weights: interleaved and splice schedulers, stripe and shared pools,
    compact and discrete variants, f32 / bf16 / kv8 / kv4 pages, and
    speculative draft-and-verify.  Greedy tokens identical; logprobs
    within 1e-4 at f32 (as tests/test_torch_server.py), 1e-2 at bf16 /
    kv8 and 1e-1 at kv4 (as tests/test_torch_quant_server.py: last-bit
    differences may round a bf16 value or a code apart).  On kv4 a
    request may part from the reference's tokens at a near tie only: a
    requantizing append whose token sets the page's amax gets a scale
    that differs in the last bits between the frameworks (their float32
    projections do), and the page's old codes that sit exactly on a
    rounding tie (code 3 re-scaled by 7/6 is 3.5) then round apart; one
    kv4 code moves the logits by ~0.05-0.1.  Up to the parting step the
    tokens are identical, and there the two picks' logprobs agree within
    kv4's tolerance (measured: one request of five, at token 6, picks of
    -4.1355 and -4.1330; the writers themselves are bit-identical to the
    reference's on the same inputs, tests/test_torch_window.py).
  * The reference's own ring checks on the port (tests/test_interleave.py,
    tests/test_scheduler.py, tests/test_shared_pool.py,
    tests/test_speculative.py): interleaved == splice, bucketed ==
    exact-length prefill, shared == stripe with both allocators clean and
    every ring page reclaimed, speculative == sequential.
  * Ring pages bound admission on the shared pool; `--arch gemma3-12b`
    serves from `launch.serve` (with `--use-dse` in
    tests/test_torch_dse.py)."""
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
from repro_torch.launch.serve import serve
from repro_torch.serving.api import KVNANDServer, SamplingParams, ServerConfig

torch.set_num_threads(2)

ARCH = "gemma3-12b"
SERVE = dict(batch_slots=2, max_context=160, prefill_chunk_tokens=16)
PROMPT_LENS = (5, 90, 17, 70, 3)
MAX_NEW = 16
LOGPROB_TOL = {"f32": 1e-4, "bf16": 1e-2, "kv8": 1e-2, "kv4": 1e-1}
FORMATS = {"f32": dict(kv_dtype="float32"), "bf16": dict(),
           "kv8": dict(kv_quant="kv8"), "kv4": dict(kv_quant="kv4")}
_CACHE = {}


def _weights():
    """(reference cfg, reference params, port cfg, port params)."""
    if ARCH not in _CACHE:
        cfg = get_config(ARCH).reduced()
        params = Model(cfg).init(jax.random.PRNGKey(0))
        tparams = bridge.params_from_numpy(jax.tree.map(np.asarray, params),
                                           "cpu")
        _CACHE[ARCH] = (cfg, params, tget(ARCH).reduced(), tparams)
    return _CACHE[ARCH]


def _prompts(vocab=512):
    r = np.random.default_rng(0)
    return [r.integers(1, vocab, n).tolist() for n in PROMPT_LENS]


def _eng_kw(fmt="f32", **kw):
    return dict(page_tokens=16, uniform_lengths=False, **FORMATS[fmt], **kw)


def _port(fmt="f32", scheduler="interleaved", speculation_k=0, slots=2,
          **kw):
    _, _, tcfg, tparams = _weights()
    serve_kw = {**SERVE, "batch_slots": slots}
    return KVNANDServer(ServerConfig(
        engine=TEngineConfig(**_eng_kw(fmt, **kw)), scheduler=scheduler,
        speculation_k=speculation_k, device="cpu", **serve_kw),
        cfg=tcfg, params=tparams)


def _tokens(srv, prompts=None, max_new=MAX_NEW):
    outs = srv.generate(prompts or _prompts(),
                        SamplingParams(max_new_tokens=max_new))
    return [o.token_ids for o in outs]


CASES = [("interleaved", False, "f32", "compact"),
         ("interleaved", True, "f32", "compact"),
         ("splice", False, "f32", "compact"),
         ("interleaved", False, "f32", "discrete"),
         ("interleaved", True, "f32", "discrete"),
         ("interleaved", False, "bf16", "compact"),
         ("interleaved", False, "kv8", "compact"),
         ("interleaved", True, "kv8", "compact"),
         ("splice", False, "kv8", "compact"),
         ("interleaved", False, "kv4", "compact"),
         ("interleaved", True, "kv4", "discrete")]


@pytest.mark.parametrize(
    "scheduler,shared,fmt,variant", CASES,
    ids=[f"{s}-{'shared' if sh else 'stripe'}-{f}-{v}"
         for s, sh, f, v in CASES])
def test_server_matches_reference(scheduler, shared, fmt, variant):
    cfg, params, _, _ = _weights()
    kw = _eng_kw(fmt, shared_pool=shared, variant=variant)
    ref = JServer(JConfig(engine=EngineConfig(**kw), scheduler=scheduler,
                          **SERVE), cfg=cfg, params=params)
    prompts = _prompts(cfg.vocab_size)
    sp = dict(max_new_tokens=MAX_NEW, logprobs=True)
    want = ref.generate(prompts, JParams(**sp))
    srv = _port(fmt, scheduler, shared_pool=shared, variant=variant)
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
    for key in ("admits", "prefill_chunks", "steps"):
        assert srv.stats[key] == ref.stats[key], key
    b = srv._batcher
    if shared:
        b.alloc.check()
        b.alloc_w.check()
        assert b.alloc_w.live_count == 0
        assert b.prefix_cache is None        # rings share no prefix


@pytest.mark.parametrize("shared", [False, True], ids=["stripe", "shared"])
def test_spec_server_matches_reference_spec_server(shared):
    """speculation_k = 4 over rings: the JAX speculative server's tokens,
    logprobs and acceptance counts; a repetitive prompt gets drafts
    accepted, one of 90 tokens verifies across a recycled ring page."""
    cfg, params, tcfg, tparams = _weights()
    prompts = [[7, 8, 9, 10] * 20] + _prompts(cfg.vocab_size)[1:4]
    kw = _eng_kw("f32", shared_pool=shared)
    ref = JServer(JConfig(engine=EngineConfig(**kw), speculation_k=4,
                          **SERVE), cfg=cfg, params=params)
    sp = dict(max_new_tokens=MAX_NEW, logprobs=True)
    want = ref.generate(prompts, JParams(**sp))
    srv = _port("f32", speculation_k=4, shared_pool=shared)
    got = srv.generate(prompts, SamplingParams(**sp))
    assert srv.stats["spec_accepted"] > 0
    for w, g in zip(want, got):
        assert g.token_ids == w.token_ids
        np.testing.assert_allclose(g.logprobs, w.logprobs, atol=1e-4)
        assert (g.spec_steps, g.spec_drafted, g.spec_accepted) == (
            w.spec_steps, w.spec_drafted, w.spec_accepted)
    if shared:
        srv._batcher.alloc.check()
        assert srv._batcher.alloc_w.live_count == 0


@pytest.mark.parametrize("fmt", ["f32", "kv8"])
def test_interleaved_matches_splice_window(fmt):
    """Window-ring chunk fills and past-window partials across chunk
    boundaries give the one-shot prefill's tokens."""
    assert _tokens(_port(fmt)) == _tokens(_port(fmt, "splice"))


def test_bucketed_prefill_matches_exact_window():
    """The ring's bucketed fill keeps live pages even when the padded
    prompt spans more source pages than the ring holds (90 tokens in a
    128-token bucket, 5 ring pages)."""
    bucketed = _port("f32", "splice")
    exact = _port("f32", "splice")
    exact._batcher.bucket_prompts = False
    assert _tokens(bucketed) == _tokens(exact)


@pytest.mark.parametrize("fmt", ["f32", "kv8", "kv4"])
def test_shared_matches_stripe_window_ring(fmt):
    """Both pools shared, the rings through `page_table_w`: the stripe's
    tokens, both allocators clean, every ring page reclaimed."""
    shared = _port(fmt, shared_pool=True)
    assert _tokens(shared) == _tokens(_port(fmt))
    b = shared._batcher
    b.alloc.check()
    b.alloc_w.check()
    assert b.alloc_w.live_count == 0


@pytest.mark.parametrize("fmt,shared", [("f32", False), ("f32", True),
                                        ("kv8", False), ("kv4", True)],
                         ids=["f32-stripe", "f32-shared", "kv8-stripe",
                              "kv4-shared"])
def test_spec_matches_sequential_window_ring(fmt, shared):
    """Span appends through the ring, accepted tokens only advance the
    ring bases: speculative tokens equal sequential ones."""
    prompts = [[7, 8, 9, 10] * 20] + _prompts()
    spec = _port(fmt, speculation_k=4, shared_pool=shared)
    assert _tokens(spec, prompts) == _tokens(
        _port(fmt, shared_pool=shared), prompts)
    assert spec.stats["spec_accepted"] > 0


@pytest.mark.parametrize("fmt", ["f32", "kv8"])
def test_discrete_equals_compact_window(fmt):
    assert _tokens(_port(fmt, variant="discrete")) == _tokens(_port(fmt))


def test_ring_pages_bound_shared_admission():
    """With room for one ring (5 pages) the second request waits for the
    first to finish and free its ring, and both serve the stripe's
    tokens."""
    prompts = [_prompts()[1], _prompts()[3]]
    srv = _port("f32", shared_pool=True, total_pages_w=5)
    b = srv._batcher
    uids = [srv.submit(p, SamplingParams(max_new_tokens=4)) for p in prompts]
    srv.step()
    assert sum(r is not None for r in b.slots) == 1
    assert b.alloc_w.live_count == 5 and len(b.queue) == 1
    srv.run()
    assert [srv.output(u).token_ids for u in uids] == _tokens(
        _port("f32"), prompts, max_new=4)
    assert b.alloc_w.live_count == 0
    b.alloc_w.check()


def test_launch_serve_serves_gemma3(capsys):
    outs = serve(["--arch", "gemma3-12b", "--reduced", "--device", "cpu",
                  "--requests", "3", "--max-new", "4", "--slots", "2"])
    assert sorted(outs) == [0, 1, 2]
    assert all(len(o.token_ids) == 4 for o in outs.values())
    assert "3 requests, 12 tokens" in capsys.readouterr().out
