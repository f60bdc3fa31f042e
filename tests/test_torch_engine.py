"""PyTorch port: `KVNANDEngine.prefill_chunk` / `decode_step` against the
JAX engine on the same weights and the same chunk + decode trace, and
the port's golden test (decode logits against its own full forward).

Tolerances: logits relative 1e-4 at a float32 pool (2e-4 for the golden
test, the reference's own); a bf16 pool is held to 1e-2 relative, since
float32 K/V that differ in the last bits may round to neighbouring bf16
values.  Pools after the trace: equal within float32 rounding (1e-5) at
float32; at bf16, 99% of the elements are bit-equal and the rest within
1e-2 + 2^-6 relative (values are O(1)) — a softmax weight that rounds to the neighbouring
bf16 value in layer 0 (the plain decode attention rounds p to the pool
dtype, as the reference does) shifts that token's layer-1 K/V."""
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
from repro_torch.core.engine import KVNANDEngine as TEngine
from repro_torch.models.registry import Model as TModel

torch.set_num_threads(2)

T, C = 8, 16          # page tokens, chunk bucket
_CACHE = {}


def _weights(arch):
    if arch not in _CACHE:
        cfg = get_config(arch).reduced()
        params = Model(cfg).init(jax.random.PRNGKey(0))
        tparams = bridge.params_from_numpy(jax.tree.map(np.asarray, params),
                                           "cpu")
        _CACHE[arch] = (cfg, params, tparams)
    return _CACHE[arch]


def _rel(t, j):
    j = np.asarray(j, np.float32)
    return float(np.abs(t.float().numpy() - j).max() / np.abs(j).max())


def _trace(arch, kv_dtype):
    """Run one chunk + decode trace through both engines: slot 0 takes a
    20-token prompt in two chunks (16 + 4, the second padded), slot 1 a
    7-token prompt; then decode steps with both, and with one slot
    masked.  Returns per-call relative logit errors and both caches."""
    cfg, params, tparams = _weights(arch)
    eng_kw = dict(page_tokens=T, kv_dtype=kv_dtype, uniform_lengths=False)
    je = KVNANDEngine(cfg, EngineConfig(**eng_kw))
    te = TEngine(tget(arch).reduced(), TEngineConfig(**eng_kw), device="cpu")
    jc = je.init_cache(2, 64)
    tc = te.init_cache(2, 64)
    r = np.random.default_rng(0)
    prompt0 = r.integers(1, cfg.vocab_size, 20)
    prompt1 = r.integers(1, cfg.vocab_size, 7)
    errs = []

    def chunk(toks, slot, start, n, first):
        nonlocal jc
        padded = np.zeros(C, np.int32)
        padded[:n] = toks
        jl, jc = je.prefill_chunk(params, jc,
                                  {"tokens": jnp.asarray(padded)[None]},
                                  slot, start, n, first=first)
        tl, _ = te.prefill_chunk(tparams, tc,
                                 {"tokens": torch.from_numpy(padded)[None]},
                                 slot, start, n, first=first)
        errs.append(_rel(tl, jl))

    def decode(toks, active):
        nonlocal jc
        jl, jc = je.decode_step(params, jc, jnp.asarray(toks)[:, None],
                                active=jnp.asarray(active))
        tl, _ = te.decode_step(tparams, tc, torch.from_numpy(toks)[:, None],
                               active=torch.from_numpy(np.asarray(active)))
        errs.append(_rel(tl, jl))

    chunk(prompt0[:16], 0, 0, 16, True)
    chunk(prompt1, 1, 0, 7, True)
    chunk(prompt0[16:], 0, 16, 4, False)
    for step in range(4):
        toks = r.integers(1, cfg.vocab_size, 2).astype(np.int32)
        decode(toks, [True, step != 2])          # slot 1 sits out once
    return errs, jc, tc


@pytest.mark.parametrize("arch", ["qwen1.5-0.5b", "llama3.1-8b",
                                  "gemma3-12b"])
def test_engine_trace_matches_reference_f32(arch):
    errs, jc, tc = _trace(arch, "float32")
    assert max(errs) < 1e-4, errs
    assert tc.lengths.tolist() == np.asarray(jc.lengths).tolist() == [24, 10]
    if jc.page_pos_w is not None:          # gemma3: its window ring too
        np.testing.assert_array_equal(tc.page_pos_w.numpy(),
                                      np.asarray(jc.page_pos_w))
    for name in ("k_pages_g", "v_pages_g", "k_pages_w", "v_pages_w"):
        if getattr(jc, name) is None:
            continue
        np.testing.assert_allclose(getattr(tc, name).numpy(),
                                   np.asarray(getattr(jc, name)),
                                   atol=1e-5, rtol=1e-5)


def test_engine_trace_matches_reference_bf16():
    errs, jc, tc = _trace("qwen1.5-0.5b", "bfloat16")
    assert max(errs) < 1e-2, errs
    for name in ("k_pages_g", "v_pages_g"):
        t = getattr(tc, name)
        assert t.dtype == torch.bfloat16
        a = t.float().numpy()
        b = np.asarray(getattr(jc, name), np.float32)
        assert (a == b).mean() >= 0.99
        np.testing.assert_allclose(a, b, atol=1e-2, rtol=2 ** -6)


@pytest.mark.parametrize("arch", ["qwen1.5-0.5b", "llama3.1-8b"])
def test_decode_matches_full_forward(arch):
    """Port of test_engine_golden: chunked prefill of a 21-token prompt
    plus 3 decode steps reproduce the port's own full forward (f32)."""
    cfg = tget(arch).reduced()
    gen = torch.Generator().manual_seed(0)
    model = TModel(cfg)
    params = model.init(gen)
    eng = TEngine(cfg, TEngineConfig(page_tokens=T, kv_dtype="float32",
                                     uniform_lengths=False), device="cpu")
    toks = torch.randint(0, cfg.vocab_size, (2, 24), generator=gen)
    full = model.forward(params, {"tokens": toks})
    cache = eng.init_cache(2, 32)
    errs = []
    for b in range(2):
        for start in (0, 16):
            n = min(16, 21 - start)
            chunk = torch.zeros(1, 16, dtype=torch.int64)
            chunk[0, :n] = toks[b, start:start + n]
            lg, cache = eng.prefill_chunk(params, cache, {"tokens": chunk},
                                          b, start, n, first=start == 0)
        errs.append(float((lg[0] - full[b, 20]).abs().max()))
    for t in range(21, 24):
        lg, cache = eng.decode_step(params, cache, toks[:, t:t + 1])
        errs.append(float((lg - full[:, t]).abs().max()))
    assert max(errs) / float(full.abs().max()) < 2e-4
