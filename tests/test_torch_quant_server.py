"""PyTorch port: `KVNANDServer` serving quantized weights and kv8/kv4 pools,
end to end on the CPU, against the JAX `KVNANDServer` on the same bridged
params (the reference's `quantize_params` tree carried over by `bridge`).

The prompts share a 2-page system prefix and one is an exact repeat, so on
the shared pool the prefix cache hits and kv8/kv4 pages (and their scales)
are copied on write.  Greedy tokens must be identical, and the scheduler's
counters equal to the reference's.

Logprob tolerances.  The two frameworks' float32 matmuls (the K/V and Q
projections, the LM head) differ in the last bits, and with float weights
and an f32 pool that keeps served logprobs within 1e-4.  Every quantizer
on the path is a rounding step with thresholds, though: a last-bit
difference in its input can move a W4A16 product to the neighbouring bf16
value, a W8A8 activation or a kv8/kv4 page element to the neighbouring
code, and that step carries through the later layers.  Most served
logprobs still agree to ~5e-7 (the median); the largest differences
measured here over both archs (qwen1.5-0.5b and llama3.1-8b reduced, 60
logprobs each) were 3.6e-3 (w4a16), 3.3e-2 (w8a8), 3.6e-3 (kv8) and
5.0e-2 (kv4).  The tolerances below sit 2-3x above those.  Exactness is
held elsewhere: the quantizers, the plain GEMV and the pool writers are
bit-identical to the reference's on the same inputs
(`test_torch_quant.py`, `test_torch_quant_gemv.py`), and
`test_quantized_forward_differs_only_where_a_quantized_input_does` shows
the mechanism on the two full forwards: a quantized matmul's output
differs only where its quantized input does, the first such input comes
from float rounding one step away from a rounding threshold, and without
such a step the logits agree within 1e-5.

Also: inactive rows never requantize a page (an engine-level aliasing
check on both layouts)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.kernels.quant_gemv as jqg
from repro.configs import EngineConfig, get_config
from repro.core.quant import quantize_activations_int8, quantize_params
from repro.models.registry import Model
from repro.serving.api import KVNANDServer as JServer
from repro.serving.api import SamplingParams as JParams
from repro.serving.api import ServerConfig as JConfig
from repro_torch import bridge
from repro_torch.configs import EngineConfig as TEngineConfig
from repro_torch.configs import get_config as tget
from repro_torch.core import paged_kv as tkv
from repro_torch.core import quant as tq
from repro_torch.core.engine import KVNANDEngine
from repro_torch.kernels import quant_gemv as tqg
from repro_torch.models import layers as tlayers
from repro_torch.models.registry import Model as TModel
from repro_torch.serving.api import KVNANDServer, SamplingParams, ServerConfig

torch.set_num_threads(2)

SERVE = dict(batch_slots=2, max_context=96, prefill_chunk_tokens=16)
COUNTERS = ("prefix_hit_pages", "cow_copies", "prefill_chunks", "admits",
            "prompt_pages")
LOGPROB_TOL = {"w4a16": 1e-2, "w8a8": 7e-2, "kv8": 1e-2, "kv4": 1e-1}
ARCHS = ["qwen1.5-0.5b", "llama3.1-8b"]
# (weights, kv_quant, shared pool)
CASES = [("w4a16", "none", False), ("w8a8", "none", True),
         ("none", "kv8", False), ("none", "kv8", True),
         ("none", "kv4", False), ("none", "kv4", True)]


def _prompts(vocab):
    r = np.random.default_rng(0)
    system = r.integers(1, vocab, 32).tolist()          # 2 full pages
    prompts = [system + r.integers(1, vocab, n).tolist() for n in (9, 21, 4)]
    prompts.insert(2, r.integers(1, vocab, 17).tolist())  # no shared prefix
    prompts.append(list(prompts[0]))                     # exact repeat
    return prompts


@pytest.mark.parametrize("weights,kv_quant,shared", CASES,
                         ids=[f"{w}-{k}-{'shared' if s else 'stripe'}"
                              for w, k, s in CASES])
@pytest.mark.parametrize("arch", ARCHS)
def test_quantized_server_matches_reference(arch, weights, kv_quant, shared):
    cfg = get_config(arch).reduced()
    params = quantize_params(Model(cfg).init(jax.random.PRNGKey(0)), weights)
    kw = dict(page_tokens=16, uniform_lengths=False, kv_dtype="float32",
              shared_pool=shared, kv_quant=kv_quant)
    ref = JServer(JConfig(engine=EngineConfig(**kw), **SERVE), cfg=cfg,
                  params=params)
    tparams = bridge.params_from_numpy(jax.tree.map(np.asarray, params),
                                       "cpu")
    port = KVNANDServer(ServerConfig(engine=TEngineConfig(**kw), device="cpu",
                                     **SERVE),
                        cfg=tget(arch).reduced(), params=tparams)
    prompts = _prompts(cfg.vocab_size)
    want = ref.generate(prompts, JParams(max_new_tokens=12, logprobs=True))
    tqg.launches.reset()
    got = port.generate(prompts, SamplingParams(max_new_tokens=12,
                                                logprobs=True))
    assert tqg.launches.value == 0          # CPU tensors: the plain version
    tol = LOGPROB_TOL[weights if weights != "none" else kv_quant]
    for w, g in zip(want, got):
        assert g.token_ids == w.token_ids
        assert g.finish_reason == w.finish_reason == "length"
        np.testing.assert_allclose(g.logprobs, w.logprobs, atol=tol)
    for key in COUNTERS:
        assert port.stats[key] == ref.stats[key], key
    cache = port._batcher.cache
    if kv_quant != "none":
        assert cache.k_pages_g.dtype == (torch.int8 if kv_quant == "kv8"
                                         else torch.uint8)
        assert cache.k_scale_g.shape == cache.k_pages_g.shape[:-2]
    if weights != "none":
        wo = port._batcher.params["layers"]["attn"]["wo_w"]
        assert isinstance(wo, tq.QuantizedWeight) and wo.scheme == weights
    if shared:
        assert port.stats["prefix_hit_pages"] > 0
        assert port.stats["cow_copies"] > 0
        port._batcher.alloc.check()


def _quantized_input(x, scheme):
    """What a quantized matmul consumes of x: bf16(x) (W4A16), or the int8
    codes and the per-token scale (W8A8)."""
    if scheme == "w4a16":
        return (np.asarray(jnp.asarray(x).astype(jnp.bfloat16)
                           .astype(jnp.float32)),)
    codes, scale = quantize_activations_int8(jnp.asarray(x))
    return np.asarray(codes), np.asarray(scale)


@pytest.mark.parametrize("scheme", ["w4a16", "w8a8"])
@pytest.mark.parametrize("arch", ARCHS)
def test_quantized_forward_differs_only_where_a_quantized_input_does(
        arch, scheme, monkeypatch):
    """The port's and the reference's full forward (eager) on the same
    bridged quantized params and 96 tokens, every quantized matmul's input
    and output recorded on both sides, in call order (wo, gate, up, down
    per layer).

    * Fed the reference's input, the port's matmul returns the reference's
      output bit for bit, at every call.
    * The first call whose output differs between the two forwards got
      inputs within float rounding of each other (1e-6 x max|x|) that
      round to neighbouring values: bf16 values one ulp apart (W4A16),
      codes one step apart or a per-token scale that differs in its last
      bits (W8A8).
    * Without a code or bf16 value that rounds differently, the logits
      agree within 1e-5.  With one (measured here: W4A16 on both archs,
      1-4 bf16 values of layer 0's wo input), they differ by up to ~1e-2:
      the step carries through the later quantizers."""
    cfg = get_config(arch).reduced()
    params = quantize_params(Model(cfg).init(jax.random.PRNGKey(0)), scheme)
    tparams = bridge.params_from_numpy(jax.tree.map(np.asarray, params),
                                       "cpu")
    tokens = np.random.default_rng(0).integers(1, cfg.vocab_size, (1, 96))
    jax_calls, port_calls = [], []
    jax_gemv, port_gemv = jqg.quant_gemv, tlayers.quant_gemv

    def jax_rec(x, w, **kw):
        y = jax_gemv(x, w, **kw)
        tw = tq.QuantizedWeight(torch.from_numpy(np.array(w.q)),
                                torch.from_numpy(np.array(w.scale)),
                                w.scheme, w.orig_shape)
        jax_calls.append((np.array(x), np.asarray(y), tw))
        return y

    def port_rec(x, w, **kw):
        y = port_gemv(x, w, **kw)
        port_calls.append((x.numpy().copy(), y.numpy().copy()))
        return y

    monkeypatch.setattr(jqg, "quant_gemv", jax_rec)
    monkeypatch.setattr(tlayers, "quant_gemv", port_rec)
    with jax.disable_jit():
        want = np.asarray(Model(cfg).forward(
            params, {"tokens": jnp.asarray(tokens)})[0])
    with torch.no_grad():
        got = TModel(tget(arch).reduced()).forward(
            tparams, {"tokens": torch.from_numpy(tokens)}).numpy()
    assert len(jax_calls) == len(port_calls) == 4 * cfg.n_layers

    first, stepped = None, False
    for i, ((xj, yj, tw), (xt, yt)) in enumerate(zip(jax_calls,
                                                      port_calls)):
        same = port_gemv(torch.from_numpy(xj), tw).numpy()
        assert np.array_equal(same, yj), f"matmul {i} on the same input"
        qj, qt = _quantized_input(xj, scheme), _quantized_input(xt, scheme)
        stepped |= not np.array_equal(qj[0], qt[0])
        if first is None and not np.array_equal(yj, yt):
            first = i
            assert (np.abs(xj - xt).max()
                    <= 1e-6 * np.abs(xj).max()), f"matmul {i}"
            if scheme == "w4a16":
                # one bf16 ulp: 2^-7 of the value's binade at most
                diff = qj[0] != qt[0]
                assert diff.any()
                assert (np.abs(qj[0] - qt[0])[diff]
                        <= np.abs(qj[0][diff]) * 2.0 ** -7).all()
            else:
                assert (np.abs(qj[0].astype(np.int32) - qt[0]) <= 1).all()
                np.testing.assert_allclose(qj[1], qt[1], rtol=1e-6)
    if not stepped:
        np.testing.assert_allclose(got, want, atol=1e-5)


def test_quant_settings_are_served_not_refused():
    """`EngineConfig.quant` is not read (the format travels with the
    params, as in the reference), and kv8 builds its pool."""
    for eng in (TEngineConfig(page_tokens=16, uniform_lengths=False,
                              quant="w8a8"),
                TEngineConfig(page_tokens=16, uniform_lengths=False,
                              kv_quant="kv8", shared_pool=True)):
        srv = KVNANDServer(ServerConfig(engine=eng, reduced=True,
                                        device="cpu", max_context=64))
        out = srv.generate([[1, 2, 3]], SamplingParams(max_new_tokens=3))
        assert len(out[0].token_ids) == 3


@pytest.mark.parametrize("shared", [False, True], ids=["stripe", "shared"])
def test_inactive_rows_never_requantize_a_page(shared):
    """Slot 0 holds an 11-token prompt in a kv4 pool (pages of 8) and
    decodes; slot 1 sits out.  On the stripe slot 1 holds 5 tokens of its
    own; on the shared pool its table row is stale and names slot 0's
    pages at length 3.  Either way slot 1 must write nothing: a requantize
    of its (page, slot 5) would re-round its own tokens, and one of (slot
    0's page 0, slot 3) would zero slot 0's tokens 4..7."""
    cfg = tget("qwen1.5-0.5b").reduced()
    eng = TEngineConfig(page_tokens=8, uniform_lengths=False,
                        kv_quant="kv4", shared_pool=shared)
    te = KVNANDEngine(cfg, eng, device="cpu")
    params = TModel(cfg).init(torch.Generator().manual_seed(0))
    cache = te.init_cache(2, 32)
    r = np.random.default_rng(1)
    for slot, n in ((0, 11), (1, 5)):
        toks = np.zeros(16, np.int64)
        toks[:n] = r.integers(1, cfg.vocab_size, n)
        te.prefill_chunk(params, cache,
                         {"tokens": torch.from_numpy(toks)[None]}, slot, 0,
                         n, first=True)
    if shared:
        table = cache.page_table_g.numpy().copy()
        table[1] = table[0]
        tkv.write_page_table(cache.page_table_g, table)
        cache.lengths[1] = 3
        page = (slice(None), slice(None), int(table[0, 0]))   # [L, K, page]
    else:
        page = (slice(None), 1, slice(None), 0)               # slot 1 page 0
    before = [a[page].clone() for a in (cache.k_pages_g, cache.v_pages_g,
                                        cache.k_scale_g, cache.v_scale_g)]
    te.decode_step(params, cache, torch.tensor([[5], [6]]),
                   active=torch.tensor([True, False]))
    after = [a[page] for a in (cache.k_pages_g, cache.v_pages_g,
                               cache.k_scale_g, cache.v_scale_g)]
    for b, a in zip(before, after):
        assert torch.equal(a, b)
    assert cache.lengths.tolist() == [12, 3 if shared else 5]
