"""PyTorch port: speculative draft-and-verify decoding on the CPU, after
tests/test_speculative.py.

The drafter and the accept rule against the reference's; speculative
serving against sequential serving in the port (greedy tokens exactly
equal on f32 and kv8 stripe pools and the f32 shared pool, with drafts
accepted on a repetitive prompt; seeded sampling equal too, since every
span position draws from the request's own per-position stream); the
port's speculative server against the JAX speculative server on the same
weights (tokens equal, logprobs within 1e-4 at a float32 pool, as
tests/test_torch_server.py holds sequential serving; on kv8 / kv4 pools
the JAX sequential server's tokens, and the JAX speculative server's
wherever that one keeps its own sequential tokens); the per-request
opt-out, the acceptance counters, a stop token inside a span, the
shared-pool rollback and page conservation (a hypothesis property, no
deadline), abort mid-flight; speculation over gemma3-12b's window rings;
and the refusal of rwkv6-3b (recurrent state cannot roll back).  Weights
come from the reference's init through `bridge`."""
import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _hypothesis_compat import given, settings, st

from repro.configs import EngineConfig as JEngineConfig
from repro.configs import get_config
from repro.models.registry import Model
from repro.serving.api import KVNANDServer as JServer
from repro.serving.api import SamplingParams as JParams
from repro.serving.api import ServerConfig as JConfig
from repro.serving.draft import propose_draft as jpropose
from repro.serving.sampler import speculative_accept as jaccept
from repro_torch import bridge
from repro_torch.configs import EngineConfig
from repro_torch.configs import get_config as tget
from repro_torch.launch.serve import serve
from repro_torch.models.registry import Model as TModel
from repro_torch.serving.api import KVNANDServer, SamplingParams, ServerConfig
from repro_torch.serving.draft import propose_draft
from repro_torch.serving.sampler import speculative_accept
from repro_torch.serving.scheduler import ContinuousBatcher, Request

torch.set_num_threads(2)

ARCH = "qwen1.5-0.5b"
# a repetitive prompt (lookup drafting must accept there) and two random
# ones (drafting must stay harmless)
REP = [7, 8, 9, 10] * 5
PROMPTS = [REP, list(range(1, 20)), [5, 4, 3]]
_CACHE = {}


def _weights(arch=ARCH):
    """(reference cfg, reference params, port cfg, port params)."""
    if arch not in _CACHE:
        cfg = get_config(arch).reduced()
        params = Model(cfg).init(jax.random.PRNGKey(0))
        tparams = bridge.params_from_numpy(jax.tree.map(np.asarray, params),
                                           "cpu")
        _CACHE[arch] = (cfg, params, tget(arch).reduced(), tparams)
    return _CACHE[arch]


def _batcher(eng, *, spec_k, slots=2, ctx=96, chunk=16, arch=ARCH):
    _, _, tcfg, tparams = _weights(arch)
    return ContinuousBatcher(tcfg, tparams, batch_slots=slots,
                             max_context=ctx, eng=eng,
                             prefill_chunk_tokens=chunk,
                             speculation_k=spec_k, device="cpu")


def _drain(eng, prompts, *, spec_k, max_new=8, sp=None, **kw):
    b = _batcher(eng, spec_k=spec_k, **kw)
    for uid, p in enumerate(prompts):
        r = Request(uid, list(p), max_new=max_new)
        if sp is not None:
            r.params = sp
        b.submit(r)
    done = b.run_to_completion()
    return {u: r.output for u, r in done.items()}, b


def _eng(**kw):
    return EngineConfig(page_tokens=16, uniform_lengths=False, **kw)


# ---------------------------------------------------------------------------
# drafter and accept rule against the reference's
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("tokens,k", [
    ([1, 2, 3, 4, 9, 3, 4], 3), ([1, 2, 3], 2), ([5, 6, 5, 6], 4),
    ([1], 0), ([], 3), (REP + [7, 8], 4), ([3] * 9, 5)])
def test_propose_draft_matches_reference(tokens, k):
    assert propose_draft(tokens, k) == jpropose(tokens, k)


def test_speculative_accept_greedy_matches_reference():
    B, S, V = 3, 5, 13
    r = np.random.default_rng(0)
    lg = r.standard_normal((B, S, V)).astype(np.float32)
    arg = lg.argmax(-1)
    drafts = arg[:, :-1].copy()
    drafts[0, 1] = (drafts[0, 1] + 1) % V          # row 0 misses at j = 1
    drafts[2, 0] = (drafts[2, 0] + 1) % V          # row 2 misses at once
    for allowed in (np.full(B, S - 1), np.array([4, 2, 4]), np.zeros(B)):
        toks, lps, acc = speculative_accept(
            torch.from_numpy(lg), torch.from_numpy(drafts),
            np.zeros(B, np.uint32), np.zeros(B, np.int64),
            torch.from_numpy(allowed.astype(np.int64)), true_vocab=V)
        jt, jl, ja = jaccept(jnp.asarray(lg), jnp.asarray(drafts),
                             np.zeros(B, np.uint32), np.zeros(B, np.int32),
                             allowed.astype(np.int32), true_vocab=V)
        np.testing.assert_array_equal(toks.numpy(), arg)
        np.testing.assert_array_equal(toks.numpy(), np.asarray(jt))
        np.testing.assert_array_equal(acc.numpy(), np.asarray(ja))
        np.testing.assert_allclose(lps.numpy(), np.asarray(jl), atol=1e-6)
    assert acc.tolist() == [0, 0, 0]


def test_speculative_accept_samples_the_sequential_stream():
    """A sampled row draws span position j from the stream at position
    positions + j: the tokens equal one-position samples there."""
    from repro_torch.serving.sampler import (request_noise,
                                             sample_with_logprobs)
    B, S, V = 2, 4, 17
    lg = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (B, S, V)).astype(np.float32))
    seeds, pos = np.array([5, 9], np.uint32), np.array([3, 0])
    toks, lps, _ = speculative_accept(
        lg, torch.zeros(B, S - 1, dtype=torch.long), seeds, pos,
        torch.full((B,), S - 1), true_vocab=V, temperature=0.8, top_k=6)
    for j in range(S):
        noise = request_noise(seeds, pos + j, V, "cpu")
        t, lp = sample_with_logprobs(lg[:, j], noise, true_vocab=V,
                                     temperature=0.8, top_k=6)
        assert toks[:, j].tolist() == t.tolist()
        torch.testing.assert_close(lps[:, j], lp)


# ---------------------------------------------------------------------------
# token parity: speculative == sequential
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kw", [dict(kv_dtype="float32"),
                                dict(kv_quant="kv8"),
                                dict(kv_dtype="float32", shared_pool=True)],
                         ids=["f32", "kv8", "shared"])
def test_spec_matches_sequential(kw):
    o0, b0 = _drain(_eng(**kw), PROMPTS, spec_k=0)
    o4, b4 = _drain(_eng(**kw), PROMPTS, spec_k=4)
    assert o0 == o4
    assert b4.stats["spec_accepted"] > 0     # the repetitive prompt pays
    assert b4.stats["spec_steps"] < b4.stats["decode_tokens"]
    assert b4.stats["verify_steps"] > 0 and b0.stats["verify_steps"] == 0
    if kw.get("shared_pool"):
        b4.alloc.check()
        assert b4._outstanding == 0
        assert b4.alloc.live_count == b4.prefix_cache.evictable_pages()


def test_spec_discrete_variant_matches_sequential():
    """Verify steps beside the discrete variant's decode steps (the
    deployment `--use-dse` picks for llama2-7b: discrete, kv8)."""
    eng = _eng(variant="discrete", kv_quant="kv8")
    o0, _ = _drain(eng, PROMPTS, spec_k=0, arch="llama2-7b")
    o4, b4 = _drain(eng, PROMPTS, spec_k=4, arch="llama2-7b")
    assert o0 == o4
    assert b4.stats["spec_accepted"] > 0


def test_spec_seeded_stochastic_stream_parity():
    sp = SamplingParams(temperature=0.9, top_k=8, seed=123,
                        max_new_tokens=8)
    o0, _ = _drain(_eng(kv_dtype="float32"), PROMPTS, spec_k=0, sp=sp)
    o4, b4 = _drain(_eng(kv_dtype="float32"), PROMPTS, spec_k=4, sp=sp)
    assert o0 == o4
    assert b4.stats["verify_steps"] > 0


@pytest.mark.parametrize("spec_k", [2, 4])
def test_spec_server_matches_reference_spec_server(spec_k):
    """The port's speculative server gives the JAX speculative server's
    tokens, logprobs and acceptance counts on the same weights."""
    cfg, params, tcfg, tparams = _weights()
    serve = dict(batch_slots=2, max_context=96, prefill_chunk_tokens=16,
                 speculation_k=spec_k)
    prompts = PROMPTS + [list(range(40, 60)) * 2]
    ref = JServer(JConfig(engine=JEngineConfig(
        page_tokens=16, uniform_lengths=False, kv_dtype="float32"), **serve),
        cfg=cfg, params=params)
    want = ref.generate(prompts, JParams(max_new_tokens=12, logprobs=True))
    srv = KVNANDServer(ServerConfig(engine=_eng(kv_dtype="float32"),
                                    device="cpu", **serve),
                       cfg=tcfg, params=tparams)
    got = srv.generate(prompts, SamplingParams(max_new_tokens=12,
                                               logprobs=True))
    assert srv.stats["spec_accepted"] > 0
    for w, g in zip(want, got):
        assert g.token_ids == w.token_ids
        np.testing.assert_allclose(g.logprobs, w.logprobs, atol=1e-4)
        assert (g.spec_steps, g.spec_drafted, g.spec_accepted) == (
            w.spec_steps, w.spec_drafted, w.spec_accepted)


# served logprobs of a kv8 / kv4 pool against the reference's, as
# tests/test_torch_quant_server.py holds sequential serving: both servers
# quantize the same values but may round a code apart at a step boundary
QUANT_LOGPROB_TOL = {"kv8": 1e-2, "kv4": 1e-1}


@pytest.mark.parametrize("fmt,shared", [("kv8", False), ("kv8", True),
                                        ("kv4", False)],
                         ids=["kv8-stripe", "kv8-shared", "kv4-stripe"])
def test_spec_server_matches_reference_spec_server_quantized(fmt, shared):
    """Over a kv8 / kv4 pool the port's verify reads the span's pages as
    the requantizing appends leave them; the reference's reads the span's
    own K/V in full precision, which departs from its sequential decode by
    the format's noise (ROADMAP §C).  So the port's speculative server
    gives the JAX sequential server's tokens, logprobs within the format's
    noise; and the JAX speculative server's tokens and acceptance counts
    on every request where the latter keeps its own sequential tokens.  On
    kv8 it keeps them on every request here, and the port's logprobs are
    also within kv8's noise of its.  (On kv4 the reference's own
    speculative logprobs depart from its sequential ones by more than
    kv4's serving tolerance, so they are not compared.)"""
    cfg, params, tcfg, tparams = _weights()
    serve = dict(batch_slots=2, max_context=96, prefill_chunk_tokens=16)
    prompts = PROMPTS + [list(range(40, 60)) * 2]
    eng = dict(page_tokens=16, uniform_lengths=False, kv_quant=fmt,
               shared_pool=shared)
    seq, spec = (JServer(JConfig(engine=JEngineConfig(**eng),
                                 speculation_k=k, **serve),
                         cfg=cfg, params=params).generate(
        prompts, JParams(max_new_tokens=12, logprobs=True)) for k in (0, 4))
    srv = KVNANDServer(ServerConfig(engine=EngineConfig(**eng), device="cpu",
                                    speculation_k=4, **serve),
                       cfg=tcfg, params=tparams)
    got = srv.generate(prompts, SamplingParams(max_new_tokens=12,
                                               logprobs=True))
    assert srv.stats["spec_accepted"] > 0
    tol = QUANT_LOGPROB_TOL[fmt]
    agree = 0
    for g, w, s in zip(got, seq, spec):
        assert g.token_ids == w.token_ids
        np.testing.assert_allclose(g.logprobs, w.logprobs, atol=tol)
        if fmt == "kv8":
            assert s.token_ids == w.token_ids
            np.testing.assert_allclose(g.logprobs, s.logprobs, atol=tol)
        if s.token_ids == w.token_ids:
            agree += 1
            assert g.token_ids == s.token_ids
            assert (g.spec_steps, g.spec_drafted, g.spec_accepted) == (
                s.spec_steps, s.spec_drafted, s.spec_accepted)
    assert agree >= len(prompts) - 1


def test_server_speculation_k_falls_back_to_the_engine_config():
    srv = KVNANDServer(ServerConfig(
        engine=_eng(kv_dtype="float32", speculation_k=3), device="cpu",
        reduced=True, batch_slots=2, max_context=96,
        prefill_chunk_tokens=16))
    assert srv._batcher.spec_k == 3
    off = KVNANDServer(ServerConfig(
        engine=_eng(kv_dtype="float32", speculation_k=3), device="cpu",
        reduced=True, batch_slots=2, max_context=96,
        prefill_chunk_tokens=16, speculation_k=0))
    assert off._batcher.spec_k == 0
    with pytest.raises(ValueError, match="speculation_k"):
        ServerConfig(speculation_k=-1, device="cpu")


def test_spec_per_request_opt_out():
    sp = SamplingParams(max_new_tokens=8, speculation=0)
    o0, _ = _drain(_eng(kv_dtype="float32"), [REP], spec_k=0)
    o4, b4 = _drain(_eng(kv_dtype="float32"), [REP], spec_k=4, sp=sp)
    assert o0 == o4
    assert b4.stats["spec_drafted"] == b4.stats["spec_accepted"] == 0
    assert b4.stats["spec_steps"] == b4.stats["verify_steps"] == 0
    assert all(r.spec_steps == 0 for r in b4.completed.values())
    with pytest.raises(ValueError, match="speculation"):
        SamplingParams(speculation=-1)


def test_request_output_acceptance_stats():
    _, _, tcfg, tparams = _weights()
    server = KVNANDServer(
        ServerConfig(batch_slots=2, max_context=96, prefill_chunk_tokens=16,
                     speculation_k=4, engine=_eng(kv_dtype="float32"),
                     device="cpu"),
        cfg=tcfg, params=tparams)
    [out] = server.generate([REP], SamplingParams(max_new_tokens=12))
    assert out.spec_steps > 0
    assert out.accepted_tokens_per_step > 1.0
    # the prefill handoff's token, then verify steps; a step that can
    # accept nothing (the last token) decodes sequentially, uncounted
    assert len(out.token_ids) >= 1 + out.spec_accepted + out.spec_steps
    assert out.spec_drafted >= out.spec_accepted


def test_spec_stop_token_truncates_span_and_stats():
    ref, _ = _drain(_eng(kv_dtype="float32"), [REP], spec_k=4, max_new=10)
    stop = ref[0][2]
    sp = SamplingParams(max_new_tokens=10, stop_token_ids=(stop,))
    out, b = _drain(_eng(kv_dtype="float32"), [REP], spec_k=4, sp=sp)
    req = b.completed[0]
    assert req.finish_reason == "stop"
    assert out[0] == ref[0][:out[0].index(stop) + 1]
    assert len(out[0]) == 1 + req.spec_accepted + req.spec_steps


# ---------------------------------------------------------------------------
# rollback: allocator conservation
# ---------------------------------------------------------------------------

def _shared_eng(total_pages=0):
    return EngineConfig(page_tokens=4, uniform_lengths=False,
                        kv_dtype="float32", shared_pool=True,
                        total_pages=total_pages)


def test_rollback_returns_speculated_pages():
    """A span crossing into a page backed for it whose drafts are all
    rejected hands the page straight back."""
    b = _batcher(_shared_eng(), spec_k=6, slots=1, ctx=32, chunk=4)
    b.submit(Request(0, list(range(1, 6)), max_new=6))
    while b.queue or any(r is not None for r in b.slots):
        b.step()
        b.alloc.check()
        assert b._outstanding == int(b._resv.sum())
        if b.slots[0] is not None and 0 not in b._prefill_live:
            last = (int(b._lengths[0]) - 1) // 4
            assert all(lp <= last for lp in b._slot_pages[0])
    b.alloc.check()
    assert b._outstanding == 0
    assert b.stats["verify_steps"] > 0


@settings(max_examples=6, deadline=None)
@given(seed=st.integers(0, 10_000), spec_k=st.integers(1, 5),
       total_pages=st.sampled_from([16, 24]))
def test_spec_shared_pool_conservation_property(seed, spec_k, total_pages):
    """Any draft/accept trace (prompts from a small alphabet, so
    acceptance varies) drains with exact refcounts and reservations and
    sequential decode's tokens."""
    rng = random.Random(seed)
    prompts = [[rng.randrange(3, 9) for _ in range(rng.randrange(3, 14))]
               for _ in range(3)]
    eng = _shared_eng(total_pages=total_pages)
    o_seq, _ = _drain(eng, prompts, spec_k=0, ctx=48, chunk=4, max_new=6)
    b = _batcher(eng, spec_k=spec_k, ctx=48, chunk=4)
    for uid, p in enumerate(prompts):
        b.submit(Request(uid, list(p), max_new=6))
    while b.queue or any(r is not None for r in b.slots):
        b.step()
        b.alloc.check()
        assert b._outstanding == int(b._resv.sum()) >= 0
    assert {u: r.output for u, r in b.completed.items()} == o_seq
    b.alloc.check()
    assert b._outstanding == 0
    assert b.alloc.live_count == b.prefix_cache.evictable_pages()


def test_spec_abort_mid_flight_conserves_pages():
    b = _batcher(_shared_eng(), spec_k=3, ctx=48, chunk=4)
    b.submit(Request(0, [2, 3, 4, 2, 3, 4, 2, 3], max_new=16))
    b.submit(Request(1, list(range(1, 9)), max_new=16))
    for _ in range(3):
        b.step()
    assert b.stats["verify_steps"] > 0
    assert b.abort(0)
    b.alloc.check()
    assert b._outstanding == int(b._resv.sum())
    b.run_to_completion()
    b.alloc.check()
    assert b._outstanding == 0


# ---------------------------------------------------------------------------
# refusals
# ---------------------------------------------------------------------------

def test_spec_refuses_recurrent_state():
    cfg = tget("rwkv6-3b").reduced()
    params = TModel(cfg).init(torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="speculat"):
        ContinuousBatcher(cfg, params, batch_slots=2, max_context=96,
                          speculation_k=2, device="cpu")


@pytest.mark.parametrize("fmt", [dict(kv_dtype="float32"),
                                 dict(kv_quant="kv8")], ids=["f32", "kv8"])
def test_spec_over_window_rings_matches_sequential(fmt):
    """gemma3-12b: span appends through the window rings (a 90-token
    prompt past its 80-token ring), ring bases advanced for kept tokens
    only: speculative tokens equal sequential ones, drafts accepted."""
    prompts = PROMPTS + [list(range(1, 91))]
    eng = _eng(**fmt)
    kw = dict(arch="gemma3-12b", ctx=128)
    spec, b = _drain(eng, prompts, spec_k=4, max_new=12, **kw)
    seq, _ = _drain(eng, prompts, spec_k=0, max_new=12, **kw)
    assert spec == seq
    assert b.stats["spec_accepted"] > 0 and b.stats["verify_steps"] > 0


def test_launch_serve_speculation_k_serves(capsys):
    outs = serve(["--reduced", "--device", "cpu", "--speculation-k", "2",
                  "--requests", "3", "--max-new", "6", "--slots", "2"])
    assert sorted(outs) == [0, 1, 2]
    assert all(len(o.token_ids) == 6 and o.finish_reason == "length"
               for o in outs.values())
    text = capsys.readouterr().out
    assert "3 requests, 18 tokens" in text
    assert "[serve] speculation k=2:" in text


# ---------------------------------------------------------------------------
# the verify forward reads what sequential decode reads
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("fmt", [dict(kv_dtype="float32"),
                                 dict(kv_dtype="bfloat16"),
                                 dict(kv_quant="kv8"), dict(kv_quant="kv4")],
                         ids=["f32", "bf16", "kv8", "kv4"])
@pytest.mark.parametrize("shared", [False, True], ids=["stripe", "shared"])
def test_verify_logits_equal_sequential_decode(shared, fmt):
    """One verify step over a 5-token span (row 0's crosses a page
    boundary, row 1's does not) against 5 sequential decode steps on the
    same tokens: the span logits equal the decode logits to float32
    summation order (1e-5 of max|logits|), kv8/kv4 included — the span's
    pages are read as the requantizing appends leave them after each
    position; a bf16 pool within 1e-2 (the decode's plain version rounds
    p to bf16, the in-span partial does not, as in the reference).  Then
    the pools hold the same K/V (kv8/kv4 codes within one step, a bf16
    pool mostly bit-equal and within 1e-2), and both caches the same
    lengths."""
    from repro_torch.core.engine import KVNANDEngine
    _, _, tcfg, tparams = _weights()
    T, S = 8, 5
    eng = KVNANDEngine(tcfg, EngineConfig(page_tokens=T,
                                          uniform_lengths=False,
                                          shared_pool=shared, **fmt),
                       device="cpu")
    r = np.random.default_rng(5)
    prompts = [r.integers(1, tcfg.vocab_size, n) for n in (13, 6)]
    span = torch.from_numpy(r.integers(1, tcfg.vocab_size, (2, S)))
    caches = []
    for _ in range(2):
        cache = eng.init_cache(2, 32)
        for slot, p in enumerate(prompts):
            padded = np.zeros(16, np.int64)
            padded[:len(p)] = p
            eng.prefill_chunk(tparams, cache,
                              {"tokens": torch.from_numpy(padded)[None]},
                              slot, 0, len(p), first=True)
        caches.append(cache)
    seq = torch.stack([eng.decode_step(tparams, caches[0], span[:, j:j + 1])[0]
                       for j in range(S)], dim=1)
    got = {}

    def accept(logits):
        got["logits"] = logits
        return torch.full((2,), S - 1), None

    eng.verify_step(tparams, caches[1], span, accept=accept)
    tol = 1e-2 if fmt.get("kv_dtype") == "bfloat16" else 1e-5
    err = float((got["logits"] - seq).abs().max() / seq.abs().max())
    assert err < tol, err
    assert caches[0].lengths.tolist() == caches[1].lengths.tolist() == [
        13 + S, 6 + S]
    a, b = caches[0], caches[1]
    for pool in ("k_pages_g", "v_pages_g"):
        x, y = getattr(a, pool), getattr(b, pool)
        if fmt.get("kv_quant"):
            # a last-bit difference of the K/V may flip a code by one
            assert (x.int() - y.int()).abs().max() <= 1 and (
                x == y).float().mean() > 0.999
        elif fmt["kv_dtype"] == "bfloat16":
            # the span's p is not rounded to bf16 before PV, the decode's
            # is (both as in the reference): layer 0's outputs differ by
            # a bf16 rounding, which moves some layer-1 K/V to the
            # neighbouring bf16 value (measured: 98.3% bit-equal)
            assert (x == y).float().mean() >= 0.97
            torch.testing.assert_close(x.float(), y.float(), rtol=2 ** -6,
                                       atol=1e-2)
        else:
            torch.testing.assert_close(x, y, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("fmt", ["none", "kv8", "kv4"])
@pytest.mark.parametrize("shared", [False, True], ids=["stripe", "shared"])
def test_span_writers_write_only_kept_positions(shared, fmt):
    """Row b keeps positions s < n_keep[b]: its later span cells, and
    every cell of a row that keeps nothing, hold what they held, and the
    kept cells hold what one-token appends in span order leave (the
    sequential requantizing chain for kv8/kv4)."""
    from repro_torch.core import paged_kv, quant
    gen = torch.Generator().manual_seed(7)
    L, B, K, T, dh, S = 2, 3, 2, 4, 8, 4
    NP = 4
    Ts = quant.kv_page_tokens_stored(T, fmt) if fmt != "none" else T
    P = B * NP
    shape = (L, K, P, Ts, dh) if shared else (L, B, K, NP, Ts, dh)
    if fmt == "none":
        pool = torch.randn(shape, generator=gen)
        scale = None
    else:
        dense = torch.randn(shape[:-2] + (T, dh), generator=gen)
        pool, scale = quant.quantize_kv_page(dense, fmt)
    lengths = torch.tensor([2, 3, 1])
    n_keep = np.array([4, 1, 0])
    rows = [torch.as_tensor(np.flatnonzero(n_keep > s)) for s in range(4)
            if (n_keep > s).any()]
    table = (torch.arange(B * NP).reshape(B, NP) if shared
             else torch.arange(NP)[None].repeat(B, 1))
    pos = lengths[None] + torch.arange(S)[:, None]          # [S, B]
    phys = torch.gather(table.t(), 0, pos // T)
    slot = pos % T
    vals = torch.randn(B, S, K, dh, generator=gen)
    got_pool = pool.clone()
    got_scale = None if scale is None else scale.clone()
    want_pool = pool.clone()
    want_scale = None if scale is None else scale.clone()
    layer = 1
    if fmt == "none":
        write = (paged_kv.append_span_shared if shared
                 else paged_kv.append_span)
        write(got_pool, layer, phys, slot, vals, rows)
    else:
        write = (paged_kv.append_span_quant_shared if shared
                 else paged_kv.append_span_quant)
        write(got_pool, got_scale, layer, phys, slot, vals, fmt, rows)
    for b in range(B):                      # one row, one token at a time
        for s in range(int(n_keep[b])):
            r = torch.tensor([b])
            if fmt == "none" and shared:
                paged_kv.append_global_shared(want_pool, layer, phys[s],
                                              slot[s], vals[:, s], r)
            elif fmt == "none":
                want_pool[layer, b, :, phys[s, b], slot[s, b]] = vals[b, s]
            elif shared:
                paged_kv.append_token_quant_shared(
                    want_pool, want_scale, layer, phys[s], slot[s],
                    vals[:, s], fmt, r)
            else:
                paged_kv.append_token_quant(want_pool, want_scale, layer,
                                            phys[s], slot[s], vals[:, s],
                                            fmt, r)
    assert torch.equal(got_pool, want_pool)
    if scale is not None:
        assert torch.equal(got_scale, want_scale)
    assert not torch.equal(got_pool, pool)
