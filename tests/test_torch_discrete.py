"""PyTorch port: the discrete head-group-pipelined variant (KVNAND-D).

* Against the reference's discrete engine (`run_golden(arch, "discrete")`,
  tests/test_engine_golden.py): the same weights and tokens, a 21-token
  prefill then 3 decode steps, f32 pool; the port's logits within 2e-4 of
  max|logits| of the reference's (its golden tolerance), and of the port's
  own full forward, on qwen1.5-0.5b (MHA), llama3.1-8b (GQA) and
  llama2-7b (the deployment the DSE picks discrete for).
* Against the port's compact variant (after
  tests/test_kv_quant.py::test_engine_decode_quant_discrete_matches_compact):
  a chunked-prefill + masked-decode trace on stripe and shared pools x
  f32 / bf16 / kv8 / kv4.  The pools are written by the same projections
  and the q projection of one group is the compact contraction over that
  group, so the two agree to float32 summation order: logits within 1e-5
  of max|logits| (measured: bit-equal but for the shared f32 and kv8 pools
  of qwen1.5-0.5b, 2e-6 absolute).
* The plain dispatcher's head range: one group's call equals that group's
  slice of the all-heads call (pools read as views, never copied), on
  both layouts, every pool format and partitions {1, 2}.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import EngineConfig as JEngineConfig
from repro.configs import get_config
from repro.core.engine import KVNANDEngine as JEngine
from repro.models.registry import Model
from repro_torch import bridge
from repro_torch.configs import EngineConfig
from repro_torch.configs import get_config as tget
from repro_torch.core.engine import KVNANDEngine
from repro_torch.core.quant import quantize_kv_page
from repro_torch.kernels.paged_attention import paged_attention_partial
from repro_torch.models.registry import Model as TModel

torch.set_num_threads(2)
_CACHE = {}


def _weights(arch):
    if arch not in _CACHE:
        cfg = get_config(arch).reduced()
        params = Model(cfg).init(jax.random.PRNGKey(0))
        tparams = bridge.params_from_numpy(jax.tree.map(np.asarray, params),
                                           "cpu")
        _CACHE[arch] = (cfg, params, tget(arch).reduced(), tparams)
    return _CACHE[arch]


@pytest.mark.parametrize("arch", ["qwen1.5-0.5b", "llama3.1-8b",
                                  "llama2-7b"])
def test_discrete_decode_matches_reference_discrete_engine(arch):
    cfg, params, tcfg, tparams = _weights(arch)
    S, n_decode = 21, 3
    kw = dict(variant="discrete", page_tokens=8, kv_dtype="float32")
    je = JEngine(cfg, JEngineConfig(**kw))
    te = KVNANDEngine(tcfg, EngineConfig(**kw), device="cpu")
    assert te._discrete
    toks = np.array(jax.random.randint(jax.random.PRNGKey(42),
                                       (2, S + n_decode), 0,
                                       cfg.vocab_size, jnp.int32))
    full = TModel(tcfg).forward(tparams, {"tokens": torch.from_numpy(toks)})
    jl, jc = je.prefill(params, {"tokens": jnp.asarray(toks[:, :S])},
                        max_context=S + n_decode + 2)
    tl, tc = te.prefill(tparams, {"tokens": torch.from_numpy(toks[:, :S])},
                        max_context=S + n_decode + 2)
    ref_err, golden_err = [], []
    scale = float(np.abs(np.asarray(jl)).max())
    for t in range(n_decode + 1):
        if t:
            step = toks[:, S + t - 1:S + t]
            jl, jc = je.decode_step(params, jc, jnp.asarray(step))
            tl, tc = te.decode_step(tparams, tc, torch.from_numpy(step))
        ref_err.append(float(np.abs(tl.numpy() - np.asarray(jl)).max()))
        golden_err.append(float((tl - full[:, S - 1 + t]).abs().max()))
    assert max(ref_err) / scale < 2e-4, ref_err
    assert max(golden_err) / float(full.abs().max()) < 2e-4, golden_err


def _trace(arch, variant, **kw):
    """Chunked prefill of two slots (one prompt spans two chunks) then 4
    decode steps, one with slot 1 masked; returns the stacked logits."""
    _, _, tcfg, tparams = _weights(arch)
    eng = KVNANDEngine(tcfg, EngineConfig(
        variant=variant, page_tokens=8, uniform_lengths=False, **kw),
        device="cpu")
    cache = eng.init_cache(2, 64)
    r = np.random.default_rng(0)
    p0 = r.integers(1, tcfg.vocab_size, 20)
    p1 = r.integers(1, tcfg.vocab_size, 7)
    out = []

    def chunk(toks, slot, start, n, first):
        padded = np.zeros(16, np.int64)
        padded[:n] = toks
        lg, _ = eng.prefill_chunk(tparams, cache,
                                  {"tokens": torch.from_numpy(padded)[None]},
                                  slot, start, n, first=first)
        out.append(lg)

    chunk(p0[:16], 0, 0, 16, True)
    chunk(p1, 1, 0, 7, True)
    chunk(p0[16:], 0, 16, 4, False)
    for step in range(4):
        toks = torch.from_numpy(r.integers(1, tcfg.vocab_size, 2))[:, None]
        lg, _ = eng.decode_step(tparams, cache, toks,
                                active=torch.tensor([True, step != 2]))
        out.append(lg)
    return torch.cat(out)


@pytest.mark.parametrize("fmt", [dict(kv_dtype="float32"),
                                 dict(kv_dtype="bfloat16"),
                                 dict(kv_quant="kv8"), dict(kv_quant="kv4")],
                         ids=["f32", "bf16", "kv8", "kv4"])
@pytest.mark.parametrize("shared", [False, True], ids=["stripe", "shared"])
@pytest.mark.parametrize("arch", ["qwen1.5-0.5b", "llama3.1-8b"])
def test_discrete_equals_compact(arch, shared, fmt):
    kw = dict(fmt, shared_pool=shared)
    c = _trace(arch, "compact", **kw)
    d = _trace(arch, "discrete", **kw)
    assert float((c - d).abs().max()) <= 1e-5 * float(c.abs().max())


def test_hg_pipeline_selects_the_discrete_variant():
    _, _, tcfg, _ = _weights("qwen1.5-0.5b")
    assert KVNANDEngine(tcfg, EngineConfig(hg_pipeline=True),
                        device="cpu")._discrete
    assert not KVNANDEngine(tcfg, EngineConfig(), device="cpu")._discrete


@pytest.mark.parametrize("partitions", [1, 2])
@pytest.mark.parametrize("fmt", ["f32", "bf16", "kv8", "kv4"])
@pytest.mark.parametrize("shared", [False, True], ids=["stripe", "shared"])
def test_head_range_equals_the_all_heads_slice(shared, fmt, partitions):
    gen = torch.Generator().manual_seed(3)
    B, K, G, NP, T, dh = 3, 4, 2, 4, 8, 32
    P = B * NP + 3
    shape = (K, P, T, dh) if shared else (B, K, NP, T, dh)
    kd, vd = torch.randn(shape, generator=gen), torch.randn(shape,
                                                            generator=gen)
    ks = vs = None
    kvq = fmt if fmt in ("kv8", "kv4") else "none"
    if kvq != "none":
        kp, ks = quantize_kv_page(kd, kvq)
        vp, vs = quantize_kv_page(vd, kvq)
    else:
        dt = torch.float32 if fmt == "f32" else torch.bfloat16
        kp, vp = kd.to(dt), vd.to(dt)
    table = (torch.randperm(P, generator=gen)[:B * NP].reshape(B, NP)
             .to(torch.int32) if shared else None)
    base = (torch.arange(NP, dtype=torch.int32) * T)[None].repeat(B, 1)
    length = torch.tensor([NP * T, 13, 1], dtype=torch.int32)
    q = torch.randn(B, K * G, dh, generator=gen)
    kw = dict(kv_quant=kvq, k_scale=ks, v_scale=vs, page_table=table,
              partitions=partitions)
    want = paged_attention_partial(q, kp, vp, base, length, **kw)
    for i in range(K):
        got = paged_attention_partial(q[:, i * G:(i + 1) * G], kp, vp, base,
                                      length, kv_heads=(i, 1), **kw)
        for g, w in zip(got, want):
            torch.testing.assert_close(g, w[:, i * G:(i + 1) * G],
                                       rtol=0, atol=0)
    got = paged_attention_partial(q[:, G:3 * G], kp, vp, base, length,
                                  kv_heads=(1, 2), **kw)
    torch.testing.assert_close(got[0], want[0][:, G:3 * G], rtol=0, atol=0)
