"""PyTorch port: window rings (gemma3's local:global attention) against
the JAX reference, on the CPU at `.reduced()` size (gemma3-12b: 2 layers,
window 64, `global_every` 2 — layer 0 local, layer 1 global).

After the reference's own ring tests (tests/test_paged_kv.py,
tests/test_interleave.py, tests/test_engine_golden.py,
tests/test_shared_pool.py, tests/test_speculative.py):

  * the layout: layer pattern, the global / window layer split, the
    cache leaves and their initial values, the ring base positions (a
    hypothesis property, no deadline);
  * the ring writers on the same numpy inputs: one-shot fills (exact and
    bucketed, stripe and shared, f32 / kv8 / kv4), chunk fills (a chunk
    wider than the ring, page starts past the ring), the ring append with
    its base refresh, and the slot splice — bit-identical to the
    reference's as it serves, under jit (the writers move and quantize
    the same floats);
  * the golden test: decode logits against the port's own full forward
    within the reference's 2e-4 relative while the ring recycles (both
    variants, both pools).

The engine against the JAX engine is in tests/test_torch_window_engine.py.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _hypothesis_compat import given, settings, st

from repro.configs import EngineConfig, get_config
from repro.core import paged_kv as jkv
from repro.core.engine import KVNANDEngine
from repro_torch.configs import EngineConfig as TEngineConfig
from repro_torch.configs import get_config as tget
from repro_torch.core import paged_kv as tkv
from repro_torch.core import quant
from repro_torch.core.engine import KVNANDEngine as TEngine
from repro_torch.models.registry import Model as TModel

torch.set_num_threads(2)

ARCH = "gemma3-12b"


# ---------------------------------------------------------------------------
# layout
# ---------------------------------------------------------------------------

def test_layer_pattern_gemma3():
    period, pattern = tkv.layer_pattern(tget(ARCH))
    assert period == 6
    assert pattern == (False, False, False, False, False, True)
    assert tkv._n_layers_split(tget(ARCH)) == (8, 40)


@pytest.mark.parametrize("arch", ["gemma3-12b", "hymba-1.5b",
                                  "qwen1.5-0.5b", "rwkv6-3b"])
@pytest.mark.parametrize("reduced", [False, True], ids=["full", "reduced"])
def test_layer_pattern_matches_reference(arch, reduced):
    """Pattern, split and each layer's pool and index equal the
    reference's per-period offsets (`_g_off` / `_w_off`)."""
    jcfg, tcfg = get_config(arch), tget(arch)
    if reduced:
        jcfg, tcfg = jcfg.reduced(), tcfg.reduced()
    assert tkv.layer_pattern(tcfg) == jkv.layer_pattern(jcfg)
    assert tkv._n_layers_split(tcfg) == jkv._n_layers_split(jcfg)
    if jcfg.family == "ssm":
        return
    je = KVNANDEngine(jcfg, EngineConfig())
    want = []
    for i in range(jcfg.n_layers):
        grp, j = divmod(i, je.period)
        if jcfg.window is not None and not je.pattern[j]:
            want.append((True, grp * je.w_per_group + je._w_off[j]))
        else:
            want.append((False, grp * je.g_per_group + je._g_off[j]))
    assert tkv.layer_pools(tcfg) == want


@pytest.mark.parametrize("fmt", ["none", "kv8", "kv4"])
@pytest.mark.parametrize("shared", [False, True], ids=["stripe", "shared"])
def test_init_cache_matches_reference(shared, fmt):
    """Every leaf of a window arch's cache: present where the reference's
    is, same shape and dtype, same tables, every ring base empty."""
    kw = dict(page_tokens=16, uniform_lengths=False, kv_dtype="float32",
              shared_pool=shared, kv_quant=fmt)
    jc = KVNANDEngine(get_config(ARCH).reduced(),
                      EngineConfig(**kw)).init_cache(3, 100)
    tc = tkv.init_cache(tget(ARCH).reduced(), TEngineConfig(**kw), 3, 100,
                        dtype=torch.float32, device="cpu")
    for f in dataclasses.fields(jc):
        want, got = getattr(jc, f.name), getattr(tc, f.name, None)
        if want is None:
            assert got is None, f.name
            continue
        assert tuple(got.shape) == want.shape, f.name
        assert str(got.dtype).split(".")[-1] == str(want.dtype), f.name
        np.testing.assert_array_equal(got.numpy(), np.asarray(want),
                                      err_msg=f.name)
    assert tc.page_pos_w.shape == (3, 64 // 16 + 1)
    assert (tc.page_pos_w == tkv.RING_EMPTY).all()


@settings(max_examples=40, deadline=None)
@given(s=st.integers(1, 300), np_=st.integers(2, 12), t=st.integers(2, 16))
def test_window_page_positions_properties(s, np_, t):
    """The reference's ring invariants on the port's bases (page-aligned,
    distinct, the newest min(NP, ceil(S/T)) pages, the newest page
    present), equal to the reference's, the tensor form to the static."""
    vals = tkv.window_page_positions(s, np_, t)
    live = vals[vals >= 0]
    n_src = -(-s // t)
    assert len(live) == min(np_, n_src)
    assert np.all(live % t == 0)
    assert len(np.unique(live)) == len(live)
    assert (n_src - 1) * t in live
    np.testing.assert_array_equal(vals, jkv.window_page_positions(s, np_, t))
    np.testing.assert_array_equal(
        tkv.window_page_positions_dyn(torch.tensor(s), np_, t).numpy(),
        np.asarray(jkv.window_page_positions_dyn(jnp.asarray(s), np_, t)))


# ---------------------------------------------------------------------------
# ring writers, bit-identical to the reference's
# ---------------------------------------------------------------------------

def _kv(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _jit(fn, *static):
    """The reference writer as it serves: jitted, `static` argument names
    held static (XLA computes a page's scale amax / 7 as amax * (1 / 7))."""
    return jax.jit(fn, static_argnames=static)


def _out(x):
    """The reference writers return pool or (pool, scale)."""
    return x if isinstance(x, tuple) else (x, None)


def _pools(shape, fmt, T, seed=0):
    """A pool (and its scales) already holding data, as numpy."""
    dense = _kv(shape[:-2] + (T, shape[-1]), seed)
    if fmt == "none":
        return dense, None
    q, s = quant.quantize_kv_page(torch.from_numpy(dense), fmt)
    return q.numpy(), s.numpy()


def _assert_equal(got, got_s, want):
    w, ws = _out(want)
    np.testing.assert_array_equal(got.numpy(), np.asarray(w))
    if ws is not None:
        np.testing.assert_array_equal(got_s.numpy(), np.asarray(ws))


def test_fill_window_at_keeps_newest():
    B, S, K, dh, T, NP, L = 1, 100, 2, 4, 8, 4, 2
    kv = torch.from_numpy(_kv((B, S, K, dh), 0))
    pool = torch.zeros((L, B, K, NP, T, dh))
    tkv.fill_layer(pool, kv, 0, ring=True)
    vals = tkv.window_page_positions(S, NP, T)
    # the newest NP pages, each in its ring slot; the older ones are gone
    for r, base in enumerate(vals):
        page = kv[0, base:base + T].transpose(0, 1)         # [K, n, dh]
        np.testing.assert_array_equal(pool[0, 0, :, r, :page.shape[1]],
                                      page)
    keep_from = (int(np.max(vals)) // T - NP + 1) * T
    assert keep_from == 72 and sorted(vals) == [72, 80, 88, 96]
    want = jkv.fill_window_at(jnp.zeros((L, B, K, NP, T, dh)),
                              jnp.asarray(kv.numpy()), jnp.asarray(0))
    np.testing.assert_array_equal(pool.numpy(), np.asarray(want))


@pytest.mark.parametrize("true_len", [None, 37, 5], ids=["exact", "bucketed",
                                                         "short"])
@pytest.mark.parametrize("fmt", ["none", "kv8", "kv4"])
@pytest.mark.parametrize("shared", [False, True], ids=["stripe", "shared"])
def test_ring_fill_matches_reference(shared, fmt, true_len):
    """`fill_layer(ring=True)` over a pool already holding data (a
    recycled slot): the exact fill's newest NP pages, or a bucketed
    fill's newest real pages only (the reference's `_fill_ring_dyn`;
    padding evicts nothing), the same bytes and scales."""
    B, S, K, dh, T, NP, L = 2, 64, 2, 8, 8, 3, 2
    Ts = quant.kv_page_tokens_stored(T, fmt) if fmt != "none" else T
    shape = (L, K, B * NP + 2, Ts, dh) if shared else (L, B, K, NP, Ts, dh)
    pool, scale = _pools(shape, fmt, T)
    kv = _kv((B, S, K, dh), 1)
    table = None
    if shared:
        table = np.random.default_rng(2).permutation(B * NP + 2)[
            :B * NP].reshape(B, NP).astype(np.int32)
    tp = torch.from_numpy(pool.copy())
    ts = None if scale is None else torch.from_numpy(scale.copy())
    tkv.fill_layer(tp, torch.from_numpy(kv), 1, ring=True, true_len=true_len,
                   table=None if table is None else torch.from_numpy(table),
                   scale=ts, kv_quant=fmt)
    want = _jit(jkv.fill_layer, "ring", "kv_quant")(
        jnp.asarray(pool), jnp.asarray(kv), jnp.asarray(1), ring=True,
        true_len=None if true_len is None else jnp.asarray(true_len),
        table=None if table is None else jnp.asarray(table),
        scale=None if scale is None else jnp.asarray(scale), kv_quant=fmt)
    _assert_equal(tp, ts, want)
    assert not np.array_equal(tp.numpy(), pool)


def test_chunk_window_fill_matches_ring():
    """Ring chunk fills reproduce the one-shot window fill for the pages
    still inside the ring (newest NP source pages), and the reference's
    chunk fills."""
    L, B, K, NP, T, dh = 2, 2, 2, 3, 8, 16
    S, slot, layer = 40, 0, 1
    kv = torch.from_numpy(_kv((B, S, K, dh), 1))
    pool_a = torch.zeros((L, B, K, NP, T, dh))
    tkv.fill_layer(pool_a, kv, layer, ring=True)
    pool_b = torch.zeros((L, B, K, NP, T, dh))
    jpool = jnp.zeros((L, B, K, NP, T, dh))
    for c0 in range(0, S, 16):
        cl = min(16, S - c0)
        tkv.fill_chunk_window_at(pool_b, kv[slot:slot + 1, c0:c0 + 16],
                                 layer, slot, c0 // T, cl)
        jpool = jkv.fill_chunk_window_at(
            jpool, jnp.asarray(kv[slot:slot + 1, c0:c0 + 16].numpy()),
            jnp.asarray(layer), jnp.asarray(slot), jnp.asarray(c0 // T),
            jnp.asarray(cl))
    np.testing.assert_array_equal(pool_a[layer, slot], pool_b[layer, slot])
    np.testing.assert_array_equal(pool_b.numpy(), np.asarray(jpool))


def test_chunk_window_fill_padded_chunk_wider_than_ring():
    """A mostly-padding chunk spanning more pages than the ring must still
    land its few real pages (a trailing padding page may not shadow the
    real page NP positions older in the ring)."""
    L, B, K, NP, T, dh = 1, 1, 1, 3, 8, 4
    C, cl = 48, 1                      # 6 chunk pages, only page 0 real
    kv = torch.from_numpy(_kv((1, C, K, dh), 2))
    pool = torch.zeros((L, B, K, NP, T, dh))
    tkv.fill_chunk_window_at(pool, kv, 0, 0, 0, cl)
    np.testing.assert_array_equal(pool[0, 0, :, 0, :1],
                                  kv[0, :1].transpose(0, 1))
    # the page's padding tokens come with it, as in the reference
    want = jkv.fill_chunk_window_at(
        jnp.zeros((L, B, K, NP, T, dh)), jnp.asarray(kv.numpy()),
        jnp.asarray(0), jnp.asarray(0), jnp.asarray(0), jnp.asarray(cl))
    np.testing.assert_array_equal(pool.numpy(), np.asarray(want))
    assert float(pool[0, 0, :, 1:].abs().max()) == 0.0


@pytest.mark.parametrize("page0,cl", [(0, 16), (5, 11), (7, 48), (2, 1)],
                         ids=["first", "wrapped", "wider", "one"])
@pytest.mark.parametrize("fmt", ["none", "kv8", "kv4"])
@pytest.mark.parametrize("shared", [False, True], ids=["stripe", "shared"])
def test_chunk_window_fill_matches_reference(shared, fmt, page0, cl):
    """One chunk into a ring that already holds data, its first page past
    the ring's end (wrapping), wider than the ring, or one real token."""
    B, K, dh, T, NP, L, C = 3, 2, 8, 8, 3, 2, 48
    Ts = quant.kv_page_tokens_stored(T, fmt) if fmt != "none" else T
    P = B * NP + 4
    shape = (L, K, P, Ts, dh) if shared else (L, B, K, NP, Ts, dh)
    pool, scale = _pools(shape, fmt, T, seed=3)
    kv = _kv((1, C, K, dh), 4)
    row = np.random.default_rng(5).permutation(P)[:NP].astype(np.int32)
    tp = torch.from_numpy(pool.copy())
    ts = None if scale is None else torch.from_numpy(scale.copy())
    if shared:
        tkv.fill_chunk_window_at_shared(tp, torch.from_numpy(kv), 1,
                                        torch.from_numpy(row), page0, cl,
                                        scale=ts, kv_quant=fmt)
        want = _jit(jkv.fill_chunk_window_at_shared, "kv_quant")(
            jnp.asarray(pool), jnp.asarray(kv), jnp.asarray(1),
            jnp.asarray(row), jnp.asarray(page0), jnp.asarray(cl),
            scale=None if scale is None else jnp.asarray(scale),
            kv_quant=fmt)
    else:
        tkv.fill_chunk_window_at(tp, torch.from_numpy(kv), 1, 2, page0, cl,
                                 scale=ts, kv_quant=fmt)
        want = _jit(jkv.fill_chunk_window_at, "kv_quant")(
            jnp.asarray(pool), jnp.asarray(kv), jnp.asarray(1),
            jnp.asarray(2), jnp.asarray(page0), jnp.asarray(cl),
            scale=None if scale is None else jnp.asarray(scale),
            kv_quant=fmt)
    _assert_equal(tp, ts, want)


@pytest.mark.parametrize("fmt", ["none", "kv8", "kv4"])
def test_ring_append_and_bases_match_reference(fmt):
    """Ten decode appends into a 3-page ring of T = 4 (every row wraps):
    the one-token append at ring slot (t // T) % NP plus the fresh-page
    base refresh equal the reference's `append_window` (f32) and its
    requantizing append at the ring slot (kv8/kv4: a recycled page's
    first token drops the previous occupant's tail and scale)."""
    B, K, dh, T, NP, L = 3, 2, 8, 4, 3, 1
    Ts = quant.kv_page_tokens_stored(T, fmt) if fmt != "none" else T
    pool, scale = _pools((L, B, K, NP, Ts, dh), fmt, T, seed=6)
    pos0 = np.asarray([0, 5, 11])
    base0 = np.stack([jkv.window_page_positions(int(n), NP, T)
                      for n in pos0])
    tp, tpos = torch.from_numpy(pool.copy()), torch.from_numpy(base0.copy())
    ts = None if scale is None else torch.from_numpy(scale.copy())
    jp, jpos = jnp.asarray(pool), jnp.asarray(base0)
    js = None if scale is None else jnp.asarray(scale)
    for step in range(10):
        lengths = pos0 + step
        val = _kv((B, K, dh), 10 + step)
        tl = torch.from_numpy(lengths)
        ring = tkv.ring_slot(tl, T, NP)
        tkv.advance_ring_bases(tpos, tl, T)
        if fmt == "none":
            tkv.append_token_inplace(tp, 0, ring, tl % T,
                                     torch.from_numpy(val))
            jp0, _, jpos = jkv.append_window(
                jp[0], jp[0], jpos, jnp.asarray(lengths), jnp.asarray(val),
                jnp.asarray(val))
            jp = jp0[None]
        else:
            tkv.append_token_quant(tp, ts, 0, ring, tl % T,
                                   torch.from_numpy(val), fmt)
            jring = jnp.asarray(lengths // T % NP)
            jp, js = _jit(jkv.append_token_quant, "fmt")(
                jp, js, 0, jring, jnp.asarray(lengths % T),
                jnp.asarray(val), fmt=fmt)
            jpos = jnp.asarray(np.stack(
                [jkv.window_page_positions(int(n) + 1, NP, T)
                 for n in lengths]))
        np.testing.assert_array_equal(tpos.numpy(), np.asarray(jpos))
    _assert_equal(tp, ts, (jp, js))


@pytest.mark.parametrize("fmt", ["none", "kv8"])
def test_splice_slot_carries_window_leaves(fmt):
    """`splice_slot` against the reference's `splice_slot_ref`: every
    leaf of slot 1, the rings and their bases included."""
    kw = dict(page_tokens=8, uniform_lengths=False, kv_quant=fmt,
              kv_dtype="float32")
    je = KVNANDEngine(get_config(ARCH).reduced(), EngineConfig(**kw))
    te = TEngine(tget(ARCH).reduced(), TEngineConfig(**kw), device="cpu")
    r = np.random.default_rng(7)
    jbatch, jone = je.init_cache(3, 48), je.init_cache(1, 48)
    tbatch, tone = te.init_cache(3, 48), te.init_cache(1, 48)
    for jc, tc in ((jbatch, tbatch), (jone, tone)):
        for f in dataclasses.fields(jc):
            leaf = getattr(jc, f.name)
            if leaf is None or f.name == "page_table_g":
                continue
            vals = r.integers(-100, 100, leaf.shape).astype(leaf.dtype)
            getattr(tc, f.name).copy_(torch.from_numpy(vals))
    want = jkv.splice_slot_ref(
        jkv.DecodeCache(**{f.name: None if getattr(tbatch, f.name) is None
                           else jnp.asarray(getattr(tbatch, f.name).numpy())
                           for f in dataclasses.fields(tbatch)}),
        jkv.DecodeCache(**{f.name: None if getattr(tone, f.name) is None
                           else jnp.asarray(getattr(tone, f.name).numpy())
                           for f in dataclasses.fields(tone)}), 1)
    got = tkv.splice_slot(tbatch, tone, 1)
    for f in dataclasses.fields(tbatch):
        if getattr(got, f.name) is not None:
            np.testing.assert_array_equal(getattr(got, f.name).numpy(),
                                          np.asarray(getattr(want, f.name)),
                                          err_msg=f.name)
    assert torch.equal(got.page_pos_w[1], tone.page_pos_w[0])


# ---------------------------------------------------------------------------
# engine
# ---------------------------------------------------------------------------

def _golden(variant, shared, S_prompt, n_decode, T):
    """Port of the reference's `run_golden`: one-shot prefill, then
    decode, each step's logits against the port's own full forward."""
    cfg = tget(ARCH).reduced()
    gen = torch.Generator().manual_seed(0)
    model = TModel(cfg)
    params = model.init(gen)
    eng = TEngine(cfg, TEngineConfig(variant=variant, page_tokens=T,
                                     kv_dtype="float32", shared_pool=shared,
                                     uniform_lengths=False), device="cpu")
    toks = torch.randint(0, cfg.vocab_size, (2, S_prompt + n_decode),
                         generator=gen)
    full = model.forward(params, {"tokens": toks})
    lg, cache = eng.prefill(params, {"tokens": toks[:, :S_prompt]},
                            max_context=S_prompt + n_decode + 2)
    errs = [float((lg - full[:, S_prompt - 1]).abs().max())]
    for t in range(n_decode):
        lg, cache = eng.decode_step(
            params, cache, toks[:, S_prompt + t:S_prompt + t + 1])
        errs.append(float((lg - full[:, S_prompt + t]).abs().max()))
    return max(errs) / float(full.abs().max()), cache


@pytest.mark.parametrize("shared", [False, True], ids=["stripe", "shared"])
@pytest.mark.parametrize("variant", ["compact", "discrete"])
def test_decode_matches_forward(variant, shared):
    """The reference's gemma3-12b golden case: a 21-token prompt and 3
    decode steps."""
    err, _ = _golden(variant, shared, 21, 3, 8)
    assert err < 2e-4


@pytest.mark.parametrize("shared", [False, True], ids=["stripe", "shared"])
@pytest.mark.parametrize("variant", ["compact", "discrete"])
def test_window_ring_recycling(variant, shared):
    """Decode past the window: ring pages recycle (9 pages of 8 tokens
    for a window of 64, a 70-token prompt and 8 decode steps), logits
    stay faithful."""
    err, cache = _golden(variant, shared, 70, 8, 8)
    assert err < 2e-4
    # the ring wrapped: slot 0 holds page 9 (tokens 72..79)
    assert cache.page_pos_w[0].tolist() == [72, 8, 16, 24, 32, 40, 48, 56,
                                            64]
