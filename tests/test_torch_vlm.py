"""PyTorch port: the VLM family (reduced pixtral-12b: 2 layers, d_model
128, 4 query heads over 2 kv heads x 32, an untied LM head), against the
JAX reference on the same bridged weights, on the CPU.

  * The plain forward with 8 patch embeddings before the tokens, and
    without, against `forward_train` within 2e-4 of max |logits|.
  * The port's engine (one-shot prefill, then 3 decode steps) against
    the reference's engine, with and without patches, compact and
    discrete (KVNAND-D), f32 pool: every step's logits within 2e-5 of
    max |logits| (ROADMAP §C's f32 pools), `lengths` counting the patch
    prefix; and within 2e-4 of the port's own forward (the reference's
    golden bound).  A bucketed prefill (`prompt_len`) counts the prefix
    too, as the reference's does.
  * The reduced pixtral server serves the reference server's greedy
    tokens on the interleaved and the splice scheduler (the schedulers
    feed no patches, in either package), and the port's shared, tiered,
    KVNAND-D and speculative servers serve its stripe server's tokens.
  * Checkpoints of pixtral's tree (its untied `lm_head`), float32 and
    W4A16, cross between the packages both ways.
  * `launch.serve --arch pixtral-12b --reduced` serves.
The `--use-dse` pick is served in tests/test_torch_dse.py."""
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import checkpoint as jck
from repro.configs import EngineConfig, get_config
from repro.core.engine import KVNANDEngine
from repro.core.quant import QuantizedWeight as JQuantizedWeight
from repro.core.quant import quantize_params
from repro.models.registry import Model
from repro.models.transformer import Runtime as JRuntime
from repro.models.transformer import forward_train
from repro.serving.api import KVNANDServer as JServer
from repro.serving.api import SamplingParams as JParams
from repro.serving.api import ServerConfig as JConfig
from repro_torch import bridge
from repro_torch.checkpoint import checkpoint as ck
from repro_torch.configs import EngineConfig as TEngineConfig
from repro_torch.configs import get_config as tget
from repro_torch.core import quant as tquant
from repro_torch.core.engine import KVNANDEngine as TEngine
from repro_torch.launch.serve import serve
from repro_torch.models import transformer as ttr
from repro_torch.serving.api import KVNANDServer, SamplingParams, ServerConfig

torch.set_num_threads(2)

ARCH = "pixtral-12b"
GOLDEN_TOL = 2e-4         # the reference's tests/test_engine_golden.py
ENGINE_TOL = 2e-5         # port engine vs reference engine, f32 pools
N_PATCH, S_PROMPT, N_DECODE = 8, 21, 3
SERVE = dict(batch_slots=2, max_context=96, prefill_chunk_tokens=16)


@pytest.fixture(scope="module")
def weights():
    """(reference cfg, reference params, port cfg, port params), built
    once for the module."""
    cfg = get_config(ARCH).reduced()
    params = Model(cfg).init(jax.random.PRNGKey(0))
    return cfg, params, tget(ARCH).reduced(), bridge.params_from_numpy(
        jax.tree.map(np.asarray, params), "cpu")


def _inputs(cfg, patches: bool):
    """Tokens [2, S_PROMPT + N_DECODE] and, when asked, patches [2, 8, D]
    from a seed, as (jax batch, port batch) of the whole sequence."""
    r = np.random.default_rng(3)
    toks = r.integers(0, cfg.vocab_size, (2, S_PROMPT + N_DECODE))
    jb, tb = {"tokens": jnp.asarray(toks)}, {"tokens": torch.from_numpy(toks)}
    if patches:
        p = r.standard_normal((2, N_PATCH, cfg.d_model)).astype(np.float32)
        jb["patches"], tb["patches"] = jnp.asarray(p), torch.from_numpy(p)
    return jb, tb


def _head(batch, n):
    return {k: v[:, :n] if k == "tokens" else v for k, v in batch.items()}


def test_config_is_pixtrals_backbone():
    full = tget(ARCH)
    assert (full.family, full.n_layers, full.d_model, full.n_heads,
            full.n_kv_heads, full.d_head, full.d_ff, full.vocab_size,
            full.tie_embeddings) == ("vlm", 40, 5120, 32, 8, 160, 14336,
                                     131072, False)


@pytest.mark.parametrize("patches", [True, False], ids=["patches", "text"])
def test_forward_matches_reference(weights, patches):
    cfg, params, tcfg, tparams = weights
    jb, tb = _inputs(cfg, patches)
    want = np.asarray(forward_train(params, cfg, jb, JRuntime())[0])
    got = ttr.forward(tparams, tcfg, tb, ttr.Runtime()).numpy()
    assert got.shape == want.shape == (2, S_PROMPT + N_DECODE,
                                       cfg.padded_vocab)
    assert np.abs(got - want).max() <= GOLDEN_TOL * np.abs(want).max()


def test_patches_lead_the_sequence_after_meta_tokens(weights):
    """`embed_inputs` puts the patches before the tokens, positions
    running over both."""
    _, _, tcfg, tparams = weights
    _, tb = _inputs(get_config(ARCH).reduced(), True)
    x, pos = ttr.embed_inputs(tparams, tcfg, tb, ttr.Runtime())
    assert x.shape[1] == N_PATCH + S_PROMPT + N_DECODE
    assert torch.equal(x[:, :N_PATCH], tb["patches"])
    assert torch.equal(pos[0], torch.arange(x.shape[1]))


@pytest.mark.parametrize("patches", [True, False], ids=["patches", "text"])
@pytest.mark.parametrize("variant", ["compact", "discrete"])
def test_engine_matches_reference_engine(weights, variant, patches):
    cfg, params, tcfg, tparams = weights
    jb, tb = _inputs(cfg, patches)
    prefix = N_PATCH if patches else 0
    ctx = S_PROMPT + N_DECODE + prefix + 2
    jeng = KVNANDEngine(cfg, EngineConfig(variant=variant, page_tokens=8,
                                          kv_dtype="float32"))
    teng = TEngine(tcfg, TEngineConfig(variant=variant, page_tokens=8,
                                       kv_dtype="float32"), device="cpu")
    full = ttr.forward(tparams, tcfg, tb, ttr.Runtime())
    scale = float(full.abs().max())
    jlg, jc = jeng.prefill(params, _head(jb, S_PROMPT), ctx)
    tlg, tc = teng.prefill(tparams, _head(tb, S_PROMPT), ctx)
    assert tc.lengths.tolist() == np.asarray(jc.lengths).tolist() == [
        S_PROMPT + prefix] * 2
    steps = [(jlg, tlg, S_PROMPT - 1)]
    for t in range(N_DECODE):
        jt = jb["tokens"][:, S_PROMPT + t:S_PROMPT + t + 1]
        jlg, jc = jeng.decode_step(params, jc, jt)
        tlg, tc = teng.decode_step(tparams, tc, tb["tokens"][
            :, S_PROMPT + t:S_PROMPT + t + 1])
        steps.append((jlg, tlg, S_PROMPT + t))
    for jlg, tlg, pos in steps:
        assert np.abs(tlg.numpy() - np.asarray(jlg)).max() <= (
            ENGINE_TOL * scale)
        assert float((tlg - full[:, pos]).abs().max()) <= GOLDEN_TOL * scale


def test_bucketed_prefill_counts_the_patch_prefix(weights):
    """With `prompt_len` (the splice scheduler's bucket padding) the
    patches count in `lengths` and the logits come from the last real
    token, in both packages."""
    cfg, params, tcfg, tparams = weights
    jb, tb = _inputs(cfg, True)
    jeng = KVNANDEngine(cfg, EngineConfig(page_tokens=8, kv_dtype="float32",
                                          uniform_lengths=False))
    teng = TEngine(tcfg, TEngineConfig(page_tokens=8, kv_dtype="float32",
                                       uniform_lengths=False), device="cpu")
    jlg, jc = jeng.prefill(params, _head(jb, 16), 48, prompt_len=13)
    tlg, tc = teng.prefill(tparams, _head(tb, 16), 48, prompt_len=13)
    assert tc.lengths.tolist() == np.asarray(jc.lengths).tolist() == [
        13 + N_PATCH] * 2
    want = ttr.forward(tparams, tcfg, _head(tb, 13), ttr.Runtime())[:, -1]
    scale = float(want.abs().max())
    assert float((tlg - want).abs().max()) <= GOLDEN_TOL * scale
    assert np.abs(tlg.numpy() - np.asarray(jlg)).max() <= ENGINE_TOL * scale


def _prompts(vocab):
    r = np.random.default_rng(0)
    return [[1, 2, 3, 4, 5], [7, 8, 9]] + [
        r.integers(1, vocab, n).tolist() for n in (40, 17)]


def _port_server(tcfg, tparams, eng=None, **kw):
    eng = eng or TEngineConfig(page_tokens=16, uniform_lengths=False,
                               kv_dtype="float32")
    return KVNANDServer(ServerConfig(engine=eng, device="cpu",
                                     **{**SERVE, **kw}),
                        cfg=tcfg, params=tparams)


@pytest.mark.parametrize("scheduler", ["interleaved", "splice"])
def test_server_serves_the_reference_tokens(weights, scheduler):
    """Both schedulers serve pixtral as text, in both packages: greedy
    tokens equal, logprobs within 1e-4."""
    cfg, params, tcfg, tparams = weights
    prompts = _prompts(cfg.vocab_size)
    eng = EngineConfig(page_tokens=16, uniform_lengths=False,
                       kv_dtype="float32")
    want = JServer(JConfig(engine=eng, scheduler=scheduler, **SERVE),
                   cfg=cfg, params=params).generate(
        prompts, JParams(max_new_tokens=6, logprobs=True))
    got = _port_server(tcfg, tparams, scheduler=scheduler).generate(
        prompts, SamplingParams(max_new_tokens=6, logprobs=True))
    for w, g in zip(want, got):
        assert g.token_ids == w.token_ids
        np.testing.assert_allclose(g.logprobs, w.logprobs, atol=1e-4)


@pytest.mark.parametrize("over,kw", [
    (dict(shared_pool=True), {}),
    (dict(shared_pool=True, total_pages=24, hot_pages=12), {}),
    (dict(variant="discrete"), {}),
    ({}, dict(speculation_k=2)),
], ids=["shared", "tiered", "discrete", "speculative"])
def test_every_pool_and_variant_serves_the_stripe_tokens(weights, over, kw):
    """pixtral serves like any dense arch: the shared pool (its prefix
    cache on), the tiered pool, KVNAND-D and speculation serve the stripe
    server's greedy tokens."""
    _, _, tcfg, tparams = weights
    prompts = _prompts(tcfg.vocab_size) + [[1, 2, 3, 4, 5, 6, 7, 8] * 3]
    sp = SamplingParams(max_new_tokens=6)
    want = _port_server(tcfg, tparams).generate(prompts, sp)
    srv = _port_server(tcfg, tparams, TEngineConfig(
        page_tokens=16, uniform_lengths=False, kv_dtype="float32", **over),
        **kw)
    got = srv.generate(prompts, sp)
    assert [g.token_ids for g in got] == [w.token_ids for w in want]
    if over.get("shared_pool") and not over.get("hot_pages"):
        assert srv._batcher.prefix_cache is not None
    if kw:
        assert srv.stats["spec_steps"] > 0


class QRecord(NamedTuple):
    """A quantized weight as a record: the reference's checkpoint walks a
    NamedTuple field by field, to ``<path>/q`` and ``<path>/scale``."""
    q: np.ndarray
    scale: np.ndarray


def _as_records(tree):
    return jax.tree.map(lambda w: QRecord(w.q, w.scale)
                        if isinstance(w, JQuantizedWeight) else w, tree,
                        is_leaf=lambda w: isinstance(w, JQuantizedWeight))


@pytest.mark.parametrize("quant", ["none", "w4a16"])
@pytest.mark.parametrize("direction", ["reference_to_port",
                                       "port_to_reference"])
def test_checkpoints_cross_between_the_packages(weights, direction, quant,
                                                tmp_path):
    """pixtral's tree (its untied `lm_head`; W4A16 codes and scales as q
    / scale records) saved by one package restores bit for bit in the
    other."""
    cfg, params, tcfg, _ = weights
    params = quantize_params(params, quant)
    tparams = bridge.params_from_numpy(jax.tree.map(np.asarray, params),
                                       "cpu")
    if direction == "reference_to_port":
        jck.save_checkpoint(str(tmp_path), 2, _as_records(params))
        restored, _ = ck.restore_checkpoint(str(tmp_path), 2, tparams)
    else:
        ck.save_checkpoint(str(tmp_path), 2, tparams)
        like = jax.tree.map(jnp.zeros_like, _as_records(params))
        jres, _ = jck.restore_checkpoint(str(tmp_path), 2, like)
        jres = jax.tree.map(
            lambda r, w: JQuantizedWeight(r.q, r.scale, w.scheme,
                                          w.orig_shape)
            if isinstance(w, JQuantizedWeight) else r,
            jres, params, is_leaf=lambda r: isinstance(r, QRecord))
        restored = bridge.params_from_numpy(jax.tree.map(np.asarray, jres),
                                            "cpu")
    want = bridge.flatten_with_paths(tparams)
    got = bridge.flatten_with_paths(restored)
    assert sorted(got) == sorted(want) and "lm_head" in got
    for k in want:
        if isinstance(want[k], tquant.QuantizedWeight):
            assert torch.equal(got[k].q, want[k].q), k
            assert torch.equal(got[k].scale, want[k].scale), k
            assert got[k].orig_shape == want[k].orig_shape, k
        else:
            assert torch.equal(got[k], want[k]), k


def test_launch_serve_serves_pixtral(capsys):
    outs = serve(["--arch", ARCH, "--reduced", "--device", "cpu",
                  "--requests", "3", "--max-new", "4", "--slots", "2"])
    assert sorted(outs) == [0, 1, 2]
    assert all(len(o.token_ids) == 4 for o in outs.values())
    assert "3 requests, 12 tokens" in capsys.readouterr().out
