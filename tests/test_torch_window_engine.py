"""PyTorch port: the window-ring engine against the JAX engine, on the
CPU at `.reduced()` size (gemma3-12b: 2 layers, window 64, `global_every`
2 — layer 0 local, layer 1 global; 8-token pages, so a ring holds 9 pages,
72 tokens), after tests/test_engine_golden.py and
tests/test_interleave.py:

  * the one-shot and chunked prefills, then decode (a slot sitting out a
    step), and a verify step: logits within 2e-4 relative (kv8/kv4 2e-3:
    a code that flips on a last-bit difference moves later layers), ring
    bases equal, f32 pools within float32 rounding (1e-5);
  * a chunk's past partial reads the ring before that layer's fill;
  * the verify forward equals sequential decode over a recycled ring
    page on f32 / bf16 / kv8 / kv4 pools;
  * the aliasing case of a stale `page_table_w` row on the shared pool."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import EngineConfig, get_config
from repro.core.engine import KVNANDEngine
from repro.models.registry import Model
from repro_torch import bridge
from repro_torch.configs import EngineConfig as TEngineConfig
from repro_torch.configs import get_config as tget
from repro_torch.core import paged_kv as tkv
from repro_torch.core.engine import KVNANDEngine as TEngine
from repro_torch.models.registry import Model as TModel

torch.set_num_threads(2)

ARCH = "gemma3-12b"
WINDOW_LEAVES = ("k_pages_w", "v_pages_w", "k_pages_g", "v_pages_g")
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


def _rel(t, j):
    j = np.asarray(j, np.float32)
    return float(np.abs(t.float().numpy() - j).max() / np.abs(j).max())


def _pools_close(tc, jc, names, atol=1e-5):
    for name in names:
        got, want = getattr(tc, name), getattr(jc, name)
        if want is None:
            assert got is None, name
            continue
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(want, np.float32),
                                   atol=atol, rtol=atol, err_msg=name)


def _engines(**kw):
    cfg, params, tcfg, tparams = _weights()
    kw = dict(page_tokens=8, uniform_lengths=False, **kw)
    return (cfg, params, tparams, KVNANDEngine(cfg, EngineConfig(**kw)),
            TEngine(tcfg, TEngineConfig(**kw), device="cpu"))


@pytest.mark.parametrize("prompt_len", [None, 45], ids=["exact", "bucketed"])
@pytest.mark.parametrize("fmt", ["f32", "kv8"])
@pytest.mark.parametrize("shared", [False, True], ids=["stripe", "shared"])
def test_prefill_then_decode_matches_reference(shared, fmt, prompt_len):
    """One-shot prefill of a prompt longer than the ring (80 tokens, 72
    ring tokens; bucketed: 45 real), then 4 decode steps: logits within
    2e-4 relative of the JAX engine's at f32 (kv8: 2e-3, as in
    `test_chunked_prefill_matches_reference`), ring bases equal, f32
    pools within 1e-5.  kv8: the prefill's scales within 1e-6 relative
    (as tests/test_torch_prefill.py holds them), and after decode the
    codes within one step and the scales within 1e-3 relative (a code
    that flips in layer 0 moves layer 1's K/V in the fourth digit)."""
    eng_kw = ({"kv_dtype": "float32"} if fmt == "f32"
              else {"kv_quant": "kv8"})
    cfg, params, tparams, je, te = _engines(shared_pool=shared, **eng_kw)
    r = np.random.default_rng(8)
    toks = r.integers(1, cfg.vocab_size, (2, 80))
    jl, jc = je.prefill(params, {"tokens": jnp.asarray(toks, jnp.int32)},
                        96, prompt_len=None if prompt_len is None
                        else jnp.asarray(prompt_len, jnp.int32))
    tl, tc = te.prefill(tparams, {"tokens": torch.from_numpy(toks)}, 96,
                        prompt_len=prompt_len)
    errs = [_rel(tl, jl)]
    np.testing.assert_array_equal(tc.page_pos_w.numpy(),
                                  np.asarray(jc.page_pos_w))
    scales = ("k_scale_w", "v_scale_w", "k_scale_g", "v_scale_g")
    if fmt == "kv8":
        _pools_close(tc, jc, scales, atol=1e-6)
    for _ in range(4):
        step = r.integers(1, cfg.vocab_size, 2).astype(np.int32)
        jl, jc = je.decode_step(params, jc, jnp.asarray(step)[:, None])
        tl, _ = te.decode_step(tparams, tc, torch.from_numpy(step)[:, None])
        errs.append(_rel(tl, jl))
    assert max(errs) < (2e-4 if fmt == "f32" else 2e-3), errs
    np.testing.assert_array_equal(tc.page_pos_w.numpy(),
                                  np.asarray(jc.page_pos_w))
    if fmt == "f32":
        _pools_close(tc, jc, WINDOW_LEAVES)
    else:
        for name in ("k_pages_w", "v_pages_w", "k_pages_g", "v_pages_g"):
            got = getattr(tc, name).int().numpy()
            want = np.asarray(getattr(jc, name)).astype(np.int32)
            assert np.abs(got - want).max() <= 1 and (
                got == want).mean() > 0.999, name
        for name in scales:
            np.testing.assert_allclose(getattr(tc, name).numpy(),
                                       np.asarray(getattr(jc, name)),
                                       rtol=1e-3, err_msg=name)


@pytest.mark.parametrize("fmt", ["f32", "kv8", "kv4"])
@pytest.mark.parametrize("shared", [False, True], ids=["stripe", "shared"])
def test_chunked_prefill_matches_reference(shared, fmt):
    """Slot 0 takes a 100-token prompt in 16-token chunks (the 72-token
    ring wraps during prefill, and each chunk's first queries read ring
    slots that chunk's fill then overwrites), slot 1 a 7-token prompt;
    then decode with slot 1 sitting out once.  Logits within 2e-4
    relative at f32 (kv8/kv4: 2e-3, the formats' rounding steps on
    last-bit input differences), ring bases equal."""
    eng_kw = ({"kv_dtype": "float32"} if fmt == "f32"
              else {"kv_quant": fmt})
    cfg, params, tparams, je, te = _engines(shared_pool=shared, **eng_kw)
    jc, tc = je.init_cache(2, 128), te.init_cache(2, 128)
    r = np.random.default_rng(9)
    p0 = r.integers(1, cfg.vocab_size, 100)
    p1 = r.integers(1, cfg.vocab_size, 7)
    errs = []

    def chunk(toks, slot, start, n):
        nonlocal jc
        padded = np.zeros(16, np.int32)
        padded[:n] = toks
        jl, jc = je.prefill_chunk(params, jc,
                                  {"tokens": jnp.asarray(padded)[None]},
                                  slot, start, n, first=start == 0)
        tl, _ = te.prefill_chunk(tparams, tc,
                                 {"tokens": torch.from_numpy(padded)[None]},
                                 slot, start, n, first=start == 0)
        errs.append(_rel(tl, jl))

    chunk(p1, 1, 0, 7)
    for start in range(0, 100, 16):
        chunk(p0[start:start + 16], 0, start, min(16, 100 - start))
    np.testing.assert_array_equal(tc.page_pos_w.numpy(),
                                  np.asarray(jc.page_pos_w))
    for step in range(4):
        toks = r.integers(1, cfg.vocab_size, 2).astype(np.int32)
        active = np.asarray([True, step != 1])
        jl, jc = je.decode_step(params, jc, jnp.asarray(toks)[:, None],
                                active=jnp.asarray(active))
        tl, _ = te.decode_step(tparams, tc, torch.from_numpy(toks)[:, None],
                               active=torch.from_numpy(active))
        errs.append(_rel(tl, jl))
    assert max(errs) < (2e-4 if fmt == "f32" else 2e-3), errs
    assert tc.lengths.tolist() == np.asarray(jc.lengths).tolist() == [104, 10]
    np.testing.assert_array_equal(tc.page_pos_w.numpy(),
                                  np.asarray(jc.page_pos_w))
    if fmt == "f32":
        _pools_close(tc, jc, WINDOW_LEAVES)


def test_chunk_past_partial_reads_the_ring_before_the_fill():
    """Slot 0's third 32-token chunk (tokens 64..95) overwrites ring
    slots 8, 0, 1, 2 of a 9-page ring, and its first query (position 64)
    still sees tokens 1..63: the chunk's logits equal the full forward's
    (a fill before the past partial would hand those queries the chunk's
    own later keys in place of tokens 1..23)."""
    cfg = tget(ARCH).reduced()
    _, _, _, tparams = _weights()
    eng = TEngine(cfg, TEngineConfig(page_tokens=8, kv_dtype="float32",
                                     uniform_lengths=False), device="cpu")
    toks = torch.from_numpy(np.random.default_rng(10).integers(
        1, cfg.vocab_size, (1, 96)))
    full = TModel(cfg).forward(tparams, {"tokens": toks})
    cache = eng.init_cache(1, 128)
    for start in (0, 32, 64):
        lg, _ = eng.prefill_chunk(tparams, cache,
                                  {"tokens": toks[:, start:start + 32]}, 0,
                                  start, 32, first=start == 0)
        err = float((lg[0] - full[0, start + 31]).abs().max())
        assert err / float(full.abs().max()) < 2e-4
    assert cache.page_pos_w[0].tolist() == [72, 80, 88, 24, 32, 40, 48, 56,
                                            64]


@pytest.mark.parametrize("shared", [False, True], ids=["stripe", "shared"])
def test_verify_step_matches_reference(shared):
    """One verify step over a 5-token span at lengths 70 and 6 (row 0's
    span opens ring page 9, recycling slot 0) against the JAX engine's:
    logits within 2e-4 relative, the kept positions written (f32 pools
    within 1e-5), ring bases advanced for kept tokens only."""
    cfg, params, tparams, je, te = _engines(kv_dtype="float32",
                                            shared_pool=shared)
    r = np.random.default_rng(11)
    jc, tc = je.init_cache(2, 96), te.init_cache(2, 96)
    for slot, n in ((0, 70), (1, 6)):
        p = r.integers(1, cfg.vocab_size, n)
        for start in range(0, n, 16):
            cl = min(16, n - start)
            padded = np.zeros(16, np.int32)
            padded[:cl] = p[start:start + cl]
            _, jc = je.prefill_chunk(params, jc,
                                     {"tokens": jnp.asarray(padded)[None]},
                                     slot, start, cl, first=start == 0)
            te.prefill_chunk(tparams, tc,
                             {"tokens": torch.from_numpy(padded)[None]},
                             slot, start, cl, first=start == 0)
    span = r.integers(1, cfg.vocab_size, (2, 5)).astype(np.int32)
    n_acc = np.asarray([3, 0])
    got = {}

    def jaccept(logits):
        got["j"] = logits
        return jnp.asarray(n_acc), None

    def taccept(logits):
        got["t"] = logits
        return torch.from_numpy(n_acc), None

    _, jc = je.verify_step(params, jc, jnp.asarray(span), accept=jaccept)
    te.verify_step(tparams, tc, torch.from_numpy(span), accept=taccept)
    assert _rel(got["t"], got["j"]) < 2e-4
    assert tc.lengths.tolist() == np.asarray(jc.lengths).tolist() == [74, 7]
    np.testing.assert_array_equal(tc.page_pos_w.numpy(),
                                  np.asarray(jc.page_pos_w))
    assert int(tc.page_pos_w[0, 0]) == 72
    _pools_close(tc, jc, WINDOW_LEAVES)


@pytest.mark.parametrize("fmt", [dict(kv_dtype="float32"),
                                 dict(kv_dtype="bfloat16"),
                                 dict(kv_quant="kv8"), dict(kv_quant="kv4")],
                         ids=["f32", "bf16", "kv8", "kv4"])
@pytest.mark.parametrize("shared", [False, True], ids=["stripe", "shared"])
def test_verify_logits_equal_sequential_decode_over_rings(shared, fmt):
    """A verify step over a 5-token span whose rows open a recycled ring
    page (row 0 at 70 tokens: ring slot 0, row 1 at 142: slot 0 of the
    second lap) against 5 sequential decode steps: the span logits equal
    the decode logits to float32 summation order (1e-5 of max|logits|;
    bf16 1e-2, as tests/test_torch_speculative.py holds the global
    pool), the same ring bases, lengths and ring contents (kv8/kv4 codes
    within one step)."""
    _, _, tcfg, tparams = _weights()
    T, S = 8, 5
    eng = TEngine(tcfg, TEngineConfig(page_tokens=T, uniform_lengths=False,
                                      shared_pool=shared, **fmt),
                  device="cpu")
    r = np.random.default_rng(12)
    prompts = [r.integers(1, tcfg.vocab_size, n) for n in (70, 142)]
    span = torch.from_numpy(r.integers(1, tcfg.vocab_size, (2, S)))
    caches = []
    for _ in range(2):
        cache = eng.init_cache(2, 160)
        for slot, p in enumerate(prompts):
            for start in range(0, len(p), 32):
                cl = min(32, len(p) - start)
                padded = np.zeros(32, np.int64)
                padded[:cl] = p[start:start + cl]
                eng.prefill_chunk(tparams, cache,
                                  {"tokens": torch.from_numpy(padded)[None]},
                                  slot, start, cl, first=start == 0)
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
    a, b = caches
    assert a.lengths.tolist() == b.lengths.tolist() == [70 + S, 142 + S]
    assert torch.equal(a.page_pos_w, b.page_pos_w)
    assert a.page_pos_w[:, 0].tolist() == [72, 144]
    for pool in ("k_pages_w", "v_pages_w"):
        x, y = getattr(a, pool), getattr(b, pool)
        if fmt.get("kv_quant"):
            assert (x.int() - y.int()).abs().max() <= 1 and (
                x == y).float().mean() > 0.999
        elif fmt["kv_dtype"] == "bfloat16":
            assert (x == y).float().mean() >= 0.97
            torch.testing.assert_close(x.float(), y.float(), rtol=2 ** -6,
                                       atol=1e-2)
        else:
            torch.testing.assert_close(x, y, rtol=1e-5, atol=1e-5)


def test_engine_inactive_slot_aliasing_active_ring_page():
    """Shared pool, ring case: slot 1 is inactive while its `page_table_w`
    row names slot 0's ring pages at the same length, so its (page, slot)
    is slot 0's append cell in every local layer: slot 0's new K/V must
    land there, as in the reference (which drops slot 1's write through
    its sentinel)."""
    cfg, params, tparams, je, te = _engines(kv_dtype="float32",
                                            shared_pool=True)
    jc, tc = je.init_cache(2, 32), te.init_cache(2, 32)
    prompt = np.zeros(16, np.int32)
    prompt[:11] = np.random.default_rng(13).integers(1, cfg.vocab_size, 11)
    _, jc = je.prefill_chunk(params, jc, {"tokens": jnp.asarray(prompt)[None]},
                             0, 0, 11, first=True)
    te.prefill_chunk(tparams, tc, {"tokens": torch.from_numpy(prompt)[None]},
                     0, 0, 11, first=True)
    table = tc.page_table_w.numpy().copy()
    table[1] = table[0]
    tkv.write_page_table(tc.page_table_w, table)
    tc.lengths[1] = 11
    tc.page_pos_w[1] = tc.page_pos_w[0]
    jc = dataclasses.replace(jc, page_table_w=jnp.asarray(table),
                             lengths=jc.lengths.at[1].set(11),
                             page_pos_w=jc.page_pos_w.at[1].set(
                                 jc.page_pos_w[0]))
    toks = np.asarray([5, 6], np.int32)
    active = np.asarray([True, False])
    cell = (slice(None), slice(None), table[0, 1], 11 - 8)
    before = tc.k_pages_w[cell].clone()
    jl, jc = je.decode_step(params, jc, jnp.asarray(toks)[:, None],
                            active=jnp.asarray(active))
    tl, _ = te.decode_step(tparams, tc, torch.from_numpy(toks)[:, None],
                           active=torch.from_numpy(active))
    assert not torch.equal(tc.k_pages_w[cell], before)
    np.testing.assert_allclose(tc.k_pages_w[cell].numpy(),
                               np.asarray(jc.k_pages_w[cell]),
                               atol=1e-5, rtol=1e-5)
    assert _rel(tl[:1], jl[:1]) < 2e-4
    assert tc.lengths.tolist() == [12, 11]
