"""PyTorch port: the one-shot `KVNANDEngine.prefill` against the JAX
engine's on the same weights and prompts, its golden test against the
port's own full forward, and the slot splice against the reference's.

Tolerances: last-token logits within 1e-4 relative (max |d| / max |ref|);
float32 pools within 5e-6 + 2.5e-6·|ref| over every written cell, the
bucket padding past `lengths` included, since the reference writes it
too.  torch's and XLA's CPU matmuls round differently in the last bits,
and a layer's K/V inherit the earlier layers' differences: measured at
most 3.7e-6 (llama3.1-8b reduced, layer 1, values up to ~4), above the
2.5e-6 a chunked engine trace showed.  kv8/kv4 pools are held
against the reference's own kv8/kv4: scales within 1e-6 relative, at
least 99.9% of the codes equal and every dequantized value within one
code step (a value within float rounding of a rounding boundary may land
on the neighbouring code).  The golden test holds prefill + decode to the
reference's 2e-4."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import EngineConfig, get_config
from repro.core import paged_kv as jpk
from repro.core.engine import KVNANDEngine
from repro.models.registry import Model
from repro_torch import bridge
from repro_torch.configs import EngineConfig as TEngineConfig
from repro_torch.configs import get_config as tget
from repro_torch.core import paged_kv as tpk
from repro_torch.core.engine import KVNANDEngine as TEngine
from repro_torch.core.quant import dequantize_kv_page
from repro_torch.models.registry import Model as TModel

torch.set_num_threads(2)

T = 8                    # page tokens
B, S, CTX = 2, 32, 48    # rows, padded prompt length, max_context
_CACHE = {}


def _weights(arch):
    if arch not in _CACHE:
        cfg = get_config(arch).reduced()
        params = Model(cfg).init(jax.random.PRNGKey(0))
        tparams = bridge.params_from_numpy(jax.tree.map(np.asarray, params),
                                           "cpu")
        _CACHE[arch] = (cfg, params, tparams)
    return _CACHE[arch]


def _prefill_both(arch, prompt_len, **eng_kw):
    cfg, params, tparams = _weights(arch)
    kw = dict(page_tokens=T, uniform_lengths=False, **eng_kw)
    je = KVNANDEngine(cfg, EngineConfig(**kw))
    te = TEngine(tget(arch).reduced(), TEngineConfig(**kw), device="cpu")
    toks = np.random.default_rng(0).integers(1, cfg.vocab_size, (B, S))
    jl, jc = je.prefill(params, {"tokens": jnp.asarray(toks, jnp.int32)}, CTX,
                        prompt_len=None if prompt_len is None
                        else jnp.asarray(prompt_len, jnp.int32))
    tl, tc = te.prefill(tparams, {"tokens": torch.from_numpy(toks)}, CTX,
                        prompt_len=prompt_len)
    jl = np.asarray(jl)
    assert float(np.abs(tl.numpy() - jl).max() / np.abs(jl).max()) < 1e-4
    n = S if prompt_len is None else prompt_len
    assert tc.lengths.tolist() == np.asarray(jc.lengths).tolist() == [n] * B
    np.testing.assert_array_equal(tc.page_table_g.numpy(),
                                  np.asarray(jc.page_table_g))
    return jc, tc


@pytest.mark.parametrize("prompt_len", [None, 21], ids=["exact", "bucketed"])
@pytest.mark.parametrize("shared", [False, True], ids=["stripe", "shared"])
@pytest.mark.parametrize("arch", ["qwen1.5-0.5b", "llama3.1-8b"])
def test_prefill_matches_reference_f32(arch, shared, prompt_len):
    jc, tc = _prefill_both(arch, prompt_len, kv_dtype="float32",
                           shared_pool=shared)
    for name in ("k_pages_g", "v_pages_g"):
        want = np.asarray(getattr(jc, name))
        got = getattr(tc, name).numpy()
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, atol=5e-6, rtol=2.5e-6)
        # the padded tail past `lengths` is written (S = 32 tokens = 4
        # pages of every row and kv head), the pages past it stay zero
        L, K = got.shape[0], got.shape[1 if shared else 2]
        written = np.abs(got).reshape(-1, T, got.shape[-1]).sum((1, 2)) > 0
        assert written.sum() == L * B * K * (S // T)


@pytest.mark.parametrize("fmt", ["kv8", "kv4"])
@pytest.mark.parametrize("prompt_len", [None, 21], ids=["exact", "bucketed"])
@pytest.mark.parametrize("shared", [False, True], ids=["stripe", "shared"])
def test_prefill_matches_reference_quantized(shared, prompt_len, fmt):
    jc, tc = _prefill_both("qwen1.5-0.5b", prompt_len, kv_quant=fmt,
                           shared_pool=shared)
    for pages, scales in (("k_pages_g", "k_scale_g"),
                          ("v_pages_g", "v_scale_g")):
        js = np.asarray(getattr(jc, scales))
        ts = getattr(tc, scales)
        np.testing.assert_allclose(ts.numpy(), js, rtol=1e-6, atol=0)
        jq = np.asarray(getattr(jc, pages))
        tq = getattr(tc, pages)
        assert tq.dtype == {"kv8": torch.int8, "kv4": torch.uint8}[fmt]
        assert (tq.numpy() == jq).mean() >= 0.999
        got = dequantize_kv_page(tq, ts, fmt)
        want = dequantize_kv_page(torch.from_numpy(np.array(jq)),
                                  torch.from_numpy(np.array(js)),
                                  fmt)
        step = ts[..., None, None]
        assert bool(((got - want).abs() <= step * 1.0001).all())


@pytest.mark.parametrize("arch", ["qwen1.5-0.5b", "llama3.1-8b"])
def test_prefill_then_decode_matches_full_forward(arch):
    """Port of test_engine_golden: a bucketed one-shot prefill of a
    21-token prompt (padded to 32) plus 3 decode steps reproduce the
    port's own full forward (f32)."""
    cfg = tget(arch).reduced()
    gen = torch.Generator().manual_seed(0)
    model = TModel(cfg)
    params = model.init(gen)
    eng = TEngine(cfg, TEngineConfig(page_tokens=T, kv_dtype="float32",
                                     uniform_lengths=False), device="cpu")
    toks = torch.randint(0, cfg.vocab_size, (B, 24), generator=gen)
    full = model.forward(params, {"tokens": toks})
    padded = torch.zeros((B, S), dtype=torch.long)
    padded[:, :21] = toks[:, :21]
    lg, cache = eng.prefill(params, {"tokens": padded}, CTX, prompt_len=21)
    errs = [float((lg - full[:, 20]).abs().max())]
    for t in range(21, 24):
        lg, cache = eng.decode_step(params, cache, toks[:, t:t + 1])
        errs.append(float((lg - full[:, t]).abs().max()))
    assert max(errs) / float(full.abs().max()) < 2e-4


@pytest.mark.parametrize("fmt", ["none", "kv8", "kv4"])
def test_splice_slot_matches_reference(fmt):
    """The same random batch and one-row caches through the reference's
    eager `splice_slot_ref` and the port's in-place `splice_slot`: every
    leaf bit-identical."""
    cfg = get_config("qwen1.5-0.5b").reduced()
    kw = dict(page_tokens=T, uniform_lengths=False, kv_quant=fmt,
              kv_dtype="float32")
    je = KVNANDEngine(cfg, EngineConfig(**kw))
    te = TEngine(tget("qwen1.5-0.5b").reduced(), TEngineConfig(**kw),
                 device="cpu")
    r = np.random.default_rng(3)
    leaves = ("k_pages_g", "v_pages_g", "k_scale_g", "v_scale_g",
              "page_table_g", "lengths")

    def randomized(jcache, tcache):
        for name in leaves:
            cur = getattr(tcache, name)
            if cur is None:
                continue
            if cur.dtype.is_floating_point:
                val = r.standard_normal(tuple(cur.shape)).astype(np.float32)
            else:
                hi = {torch.int8: 127, torch.uint8: 255}.get(cur.dtype, CTX)
                val = r.integers(0, hi, tuple(cur.shape))
            val = torch.from_numpy(val).to(cur.dtype)
            cur.copy_(val)
            jcache = dataclasses.replace(
                jcache, **{name: jnp.asarray(val.numpy())})
        return jcache, tcache

    jbatch, tbatch = randomized(je.init_cache(3, CTX), te.init_cache(3, CTX))
    jone, tone = randomized(je.init_cache(1, CTX), te.init_cache(1, CTX))
    want = jpk.splice_slot_ref(jbatch, jone, 1)
    got = tpk.splice_slot(tbatch, tone, 1)
    for name in leaves:
        if getattr(got, name) is None:
            continue
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)))


def test_splice_refuses_a_shared_pool():
    te = TEngine(tget("qwen1.5-0.5b").reduced(),
                 TEngineConfig(page_tokens=T, uniform_lengths=False,
                               shared_pool=True), device="cpu")
    shared = te.init_cache(2, CTX)
    with pytest.raises(ValueError, match="stripe"):
        tpk.splice_slot(shared, te.init_cache(1, CTX), 0)


@pytest.mark.parametrize("prompt_len", [None, 21], ids=["exact", "bucketed"])
@pytest.mark.parametrize("shared", [False, True], ids=["stripe", "shared"])
def test_ring_fills_match_reference(shared, prompt_len):
    """gemma3-12b's one-shot prefill fills its window ring (layer 0) as the
    reference does: a 32-token prompt (21 real when bucketed) into a
    9-page ring, the ring bases equal, ring and global pools within the
    float32 tolerance above; only the real tokens' pages of the ring are
    written (the bucket padding's 11 tokens reach no ring page past the
    third)."""
    jc, tc = _prefill_both("gemma3-12b", prompt_len, kv_dtype="float32",
                           shared_pool=shared)
    np.testing.assert_array_equal(tc.page_pos_w.numpy(),
                                  np.asarray(jc.page_pos_w))
    n = S if prompt_len is None else prompt_len
    assert tc.page_pos_w[0].tolist()[:4] == [0, 8, 16, 24][:-(-n // T)] + [
        tpk.RING_EMPTY] * (4 + n // -T)
    for name in ("k_pages_w", "v_pages_w", "k_pages_g", "v_pages_g"):
        want = np.asarray(getattr(jc, name))
        got = getattr(tc, name).numpy()
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, atol=5e-6, rtol=2.5e-6)
    ring = tc.k_pages_w.numpy()
    written = np.abs(ring).reshape(-1, T, ring.shape[-1]).sum((1, 2)) > 0
    assert written.sum() == B * tc.k_pages_w.shape[1 if shared else 2] * (
        -(-n // T))
