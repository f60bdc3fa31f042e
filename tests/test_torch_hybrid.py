"""PyTorch port: hymba, the hybrid family (reduced: 2 layers, d_model 128,
4 query heads over 2 kv heads, window 64 on layer 0 and global layer 1,
ssm_state 8, 8 meta tokens), against the JAX reference on the same
bridged weights, on the CPU.

  * The plain full forward (meta tokens prepended, stripped before the
    LM head; the SSM mixer beside attention, averaged) against
    `forward_train` within 2e-4 relative.
  * Engine traces: whole-prompt chunks (`prefill_chunk` with `first`, the
    chunk's extent prefix + prompt) into two slots — one prompt long
    enough to wrap the 5-page ring — then decode steps with one row
    inactive, compact and discrete, stripe and shared: logits within
    2e-4 relative at every call, and after the trace the lengths and ring
    bases equal and every pool, ring, SSM-state and conv-tail leaf within
    1e-5.  A variant with 5 query heads over 1 kv head runs a head group
    of G = 5, hymba's own (the reduced config has G = 2).
  * The one-shot prefill (kernel B4's path on the card) against the
    reference's, then decode, and the slot splice.
  * Refusals shared with the reference: bucketed one-shot prefill and
    speculative verification.
  * Checkpoints of hymba's parameters (`meta_tokens`, `ssm/*`) restore in
    either package, and the `launch.serve` CLI serves the arch with and
    without `--use-dse`.
The servers are held in tests/test_torch_hybrid_server.py."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import checkpoint as jck
from repro.configs import EngineConfig, get_config
from repro.core.engine import KVNANDEngine
from repro.models.registry import Model
from repro.models.transformer import Runtime as JRuntime
from repro.models.transformer import forward_train
from repro_torch import bridge
from repro_torch.checkpoint import checkpoint as ck
from repro_torch.configs import EngineConfig as TEngineConfig
from repro_torch.configs import get_config as tget
from repro_torch.core.engine import KVNANDEngine as TEngine
from repro_torch.launch.serve import serve
from repro_torch.models.registry import Model as TModel

torch.set_num_threads(2)

ARCH = "hymba-1.5b"
T = 16
LOGIT_TOL = 2e-4
LEAF_TOL = dict(atol=1e-5, rtol=1e-5)
LEAVES = ("k_pages_g", "v_pages_g", "k_pages_w", "v_pages_w", "ssm_state",
          "conv_tail", "k_scale_g", "v_scale_g", "k_scale_w", "v_scale_w")
_CACHE = {}


def _weights(heads="reduced"):
    """(reference cfg, reference params, port cfg, port params); "g5"
    takes 5 query heads over 1 kv head (hymba's head group of 5)."""
    if heads not in _CACHE:
        cfg, tcfg = get_config(ARCH).reduced(), tget(ARCH).reduced()
        if heads == "g5":
            cfg = dataclasses.replace(cfg, n_heads=5, n_kv_heads=1)
            tcfg = dataclasses.replace(tcfg, n_heads=5, n_kv_heads=1)
        params = Model(cfg).init(jax.random.PRNGKey(0))
        tparams = bridge.params_from_numpy(jax.tree.map(np.asarray, params),
                                           "cpu")
        _CACHE[heads] = (cfg, params, tcfg, tparams)
    return _CACHE[heads]


def _rel(t, j):
    j = np.asarray(j, np.float32)
    return float(np.abs(t.float().numpy() - j).max() / np.abs(j).max())


def _leaves_close(tc, jc):
    np.testing.assert_array_equal(tc.lengths.numpy(), np.asarray(jc.lengths))
    if jc.page_pos_w is not None:
        np.testing.assert_array_equal(tc.page_pos_w.numpy(),
                                      np.asarray(jc.page_pos_w))
    for name in LEAVES:
        j = getattr(jc, name)
        if j is None:
            assert getattr(tc, name) is None, name
            continue
        t = getattr(tc, name)
        assert tuple(t.shape) == j.shape, name
        np.testing.assert_allclose(t.float().numpy(),
                                   np.asarray(j, np.float32), **LEAF_TOL,
                                   err_msg=name)


def test_init_matches_the_reference_tree():
    cfg, params, tcfg, tparams = _weights()
    fresh = TModel(tcfg).init(torch.Generator().manual_seed(0))
    jflat = bridge.flatten_with_paths(jax.tree.map(np.asarray, params))
    tflat = bridge.flatten_with_paths(fresh)
    assert sorted(jflat) == sorted(tflat)
    for k in jflat:
        assert tuple(tflat[k].shape) == jflat[k].shape, k
    assert tflat["meta_tokens"].shape == (cfg.n_meta_tokens, cfg.d_model)
    assert 0.01 < float(tflat["meta_tokens"].std()) < 0.03
    assert (tflat["layers/ssm/a_log"] == 0).all()


@pytest.mark.parametrize("heads", ["reduced", "g5"])
def test_forward_matches_reference(heads):
    cfg, params, tcfg, tparams = _weights(heads)
    toks = np.random.default_rng(0).integers(1, cfg.vocab_size, (2, 90))
    jl, _ = forward_train(params, cfg, {"tokens": jnp.asarray(toks)},
                          JRuntime())
    tl = TModel(tcfg).forward(tparams, {"tokens": torch.from_numpy(toks)})
    assert tl.shape == (2, 90, cfg.padded_vocab)
    assert _rel(tl, jl) < LOGIT_TOL


def _trace(heads, eng_kw):
    """Whole-prompt chunks into both slots (slot 0: 90 tokens + 8 meta,
    wrapping the 80-token ring; slot 1: 7 tokens), then 6 decode steps,
    slot 1 sitting out step 2.  Returns per-call logit errors and both
    caches."""
    cfg, params, tcfg, tparams = _weights(heads)
    kw = dict(page_tokens=T, kv_dtype="float32", uniform_lengths=False,
              **eng_kw)
    je = KVNANDEngine(cfg, EngineConfig(**kw))
    te = TEngine(tcfg, TEngineConfig(**kw), device="cpu")
    jc, tc = je.init_cache(2, 160), te.init_cache(2, 160)
    r = np.random.default_rng(3)
    errs = []
    for slot, n in ((0, 90), (1, 7)):
        toks = r.integers(1, cfg.vocab_size, n).astype(np.int32)
        jl, jc = je.prefill_chunk(params, jc, {"tokens": jnp.asarray(toks)[None]},
                                  slot, 0, n, first=True)
        tl, _ = te.prefill_chunk(tparams, tc,
                                 {"tokens": torch.from_numpy(toks)[None]},
                                 slot, 0, n, first=True)
        errs.append(_rel(tl, jl))
    for step in range(6):
        toks = r.integers(1, cfg.vocab_size, 2).astype(np.int32)
        active = np.array([True, step != 2])
        jl, jc = je.decode_step(params, jc, jnp.asarray(toks)[:, None],
                                active=jnp.asarray(active))
        tl, _ = te.decode_step(tparams, tc, torch.from_numpy(toks)[:, None],
                               active=torch.from_numpy(active))
        errs.append(_rel(tl, jl))
    return errs, jc, tc


TRACES = [("reduced", "compact", False), ("reduced", "compact", True),
          ("reduced", "discrete", False), ("reduced", "discrete", True),
          ("g5", "compact", False), ("g5", "discrete", True)]


@pytest.mark.parametrize("heads,variant,shared", TRACES,
                         ids=[f"{h}-{v}-{'shared' if s else 'stripe'}"
                              for h, v, s in TRACES])
def test_engine_trace_matches_reference(heads, variant, shared):
    errs, jc, tc = _trace(heads, dict(variant=variant, shared_pool=shared))
    assert max(errs) < LOGIT_TOL, errs
    assert tc.lengths.tolist() == [8 + 90 + 6, 8 + 7 + 5]
    _leaves_close(tc, jc)


@pytest.mark.parametrize("kv_quant", ["kv8", "kv4"])
def test_engine_trace_quantized_pool(kv_quant):
    """kv8/kv4 pages: the writers requantize what the reference's do;
    logits within the format's gap (ROADMAP §C)."""
    errs, jc, tc = _trace("reduced", dict(kv_quant=kv_quant))
    assert max(errs) < {"kv8": 1e-2, "kv4": 1e-1}[kv_quant], errs
    np.testing.assert_array_equal(tc.lengths.numpy(), np.asarray(jc.lengths))
    np.testing.assert_allclose(tc.ssm_state.numpy(), np.asarray(jc.ssm_state),
                               atol=1e-3, rtol=1e-3)


def test_inactive_row_keeps_its_state():
    """A decode step leaves an inactive slot's SSM state, conv tail,
    pages and length untouched."""
    cfg, _, tcfg, tparams = _weights()
    te = TEngine(tcfg, TEngineConfig(page_tokens=T, kv_dtype="float32",
                                     uniform_lengths=False), device="cpu")
    tc = te.init_cache(2, 160)
    for slot in (0, 1):
        toks = torch.arange(1, 12 + slot)[None]
        te.prefill_chunk(tparams, tc, {"tokens": toks}, slot, 0,
                         toks.shape[1], first=True)
    before = {n: getattr(tc, n)[:, 1].clone()
              for n in ("ssm_state", "conv_tail", "k_pages_w", "k_pages_g")}
    te.decode_step(tparams, tc, torch.tensor([[5], [6]]),
                   active=torch.tensor([True, False]))
    for n, v in before.items():
        assert torch.equal(getattr(tc, n)[:, 1], v), n
        assert not torch.equal(getattr(tc, n)[:, 0], torch.zeros_like(v))
    assert tc.lengths.tolist() == [8 + 11 + 1, 8 + 12]


@pytest.mark.parametrize("shared", [False, True], ids=["stripe", "shared"])
def test_oneshot_prefill_matches_reference(shared):
    """`engine.prefill` (B4's path on the card, zero-state mixer, ring
    filled with the newest real pages) against the reference's, then
    three decode steps."""
    cfg, params, tcfg, tparams = _weights()
    kw = dict(page_tokens=T, kv_dtype="float32", uniform_lengths=False,
              shared_pool=shared)
    je = KVNANDEngine(cfg, EngineConfig(**kw))
    te = TEngine(tcfg, TEngineConfig(**kw), device="cpu")
    toks = np.random.default_rng(5).integers(1, cfg.vocab_size, (2, 75))
    jl, jc = je.prefill(params, {"tokens": jnp.asarray(toks, jnp.int32)}, 128)
    tl, tc = te.prefill(tparams, {"tokens": torch.from_numpy(toks)}, 128)
    assert _rel(tl, jl) < LOGIT_TOL
    assert tc.lengths.tolist() == [83, 83]
    _leaves_close(tc, jc)
    nxt = np.argmax(np.asarray(jl), -1).astype(np.int32)[:, None]
    for _ in range(3):
        jl, jc = je.decode_step(params, jc, jnp.asarray(nxt))
        tl, _ = te.decode_step(tparams, tc, torch.from_numpy(nxt))
        assert _rel(tl, jl) < LOGIT_TOL
        nxt = np.argmax(np.asarray(jl), -1).astype(np.int32)[:, None]
    _leaves_close(tc, jc)


def test_splice_carries_the_ssm_rows():
    """`splice_slot` copies a one-row prefill cache's SSM state and conv
    tail beside its pages: decode from the splice equals decode from a
    whole-prompt chunk into the same slot."""
    from repro_torch.core import paged_kv
    _, _, tcfg, tparams = _weights()
    te = TEngine(tcfg, TEngineConfig(page_tokens=T, kv_dtype="float32",
                                     uniform_lengths=False), device="cpu")
    toks = torch.arange(3, 40)[None]
    a = te.init_cache(2, 128)
    te.prefill_chunk(tparams, a, {"tokens": toks}, 1, 0, toks.shape[1],
                     first=True)
    _, one = te.prefill(tparams, {"tokens": toks}, 128)
    b = paged_kv.splice_slot(te.init_cache(2, 128), one, 1)
    for c in (a, b):
        assert c.lengths.tolist() == [0, 8 + 37]
    la, _ = te.decode_step(tparams, a, torch.tensor([[0], [9]]),
                           active=torch.tensor([False, True]))
    lb, _ = te.decode_step(tparams, b, torch.tensor([[0], [9]]),
                           active=torch.tensor([False, True]))
    assert _rel(lb[1:], la[1:].numpy()) < LOGIT_TOL
    torch.testing.assert_close(b.ssm_state, a.ssm_state, atol=1e-5,
                               rtol=1e-5)


def test_refusals_match_the_reference():
    """Bucketed one-shot prefill would fold padding into the SSM state,
    and a verify step cannot roll it back: both refused, as in the
    reference."""
    _, _, tcfg, tparams = _weights()
    te = TEngine(tcfg, TEngineConfig(page_tokens=T, uniform_lengths=False),
                 device="cpu")
    toks = torch.ones((1, 16), dtype=torch.int64)
    with pytest.raises(ValueError, match="bucketed prefill"):
        te.prefill(tparams, {"tokens": toks}, 64, prompt_len=10)
    with pytest.raises(ValueError, match="roll back"):
        te.verify_step(tparams, te.init_cache(1, 64), toks[:, :3],
                       accept=lambda lg: (None, None))


def test_bf16_pool_rounds_the_conv_tail():
    """With a bf16 pool the conv tail is stored in bf16 (rounded between
    steps, as the reference stores it) and the SSM state in float32."""
    _, _, tcfg, tparams = _weights()
    te = TEngine(tcfg, TEngineConfig(page_tokens=T, uniform_lengths=False),
                 device="cpu")
    c = te.init_cache(2, 64)
    assert c.conv_tail.dtype == torch.bfloat16
    assert c.ssm_state.dtype == torch.float32
    assert tuple(c.ssm_state.shape) == (2, 2, 128, 8)
    assert tuple(c.conv_tail.shape) == (2, 2, 3, 128)
    c8 = TEngine(tcfg, TEngineConfig(page_tokens=T, uniform_lengths=False,
                                     kv_quant="kv8", kv_dtype="float32"),
                 device="cpu").init_cache(2, 64)
    assert c8.conv_tail.dtype == torch.float32


@pytest.mark.parametrize("direction", ["reference_to_port",
                                       "port_to_reference"])
def test_checkpoints_cross_between_the_packages(direction, tmp_path):
    """hymba's parameter tree (meta tokens, the SSM scope) saved by one
    package restores bit for bit in the other, and the restored weights
    serve the same forward."""
    cfg, params, tcfg, tparams = _weights()
    if direction == "reference_to_port":
        jck.save_checkpoint(str(tmp_path), 3, params)
        like = {k: torch.zeros_like(v) if isinstance(v, torch.Tensor) else v
                for k, v in bridge.flatten_with_paths(tparams).items()}
        restored, _ = ck.restore_checkpoint(str(tmp_path), 3,
                                            bridge.unflatten(like))
    else:
        ck.save_checkpoint(str(tmp_path), 3, tparams)
        jres, _ = jck.restore_checkpoint(
            str(tmp_path), 3, jax.tree.map(jnp.zeros_like, params))
        restored = bridge.params_from_numpy(jax.tree.map(np.asarray, jres),
                                            "cpu")
    want = bridge.flatten_with_paths(tparams)
    got = bridge.flatten_with_paths(restored)
    assert sorted(got) == sorted(want)
    assert "meta_tokens" in got and "layers/ssm/a_log" in got
    for k in want:
        assert torch.equal(got[k], want[k]), k
    toks = torch.arange(1, 20)[None]
    m = TModel(tcfg)
    torch.testing.assert_close(m.forward(restored, {"tokens": toks}),
                               m.forward(tparams, {"tokens": toks}),
                               rtol=0, atol=0)


@pytest.mark.parametrize("extra,picked", [
    ([], None), (["--use-dse"], "kv_quant=none"),
    (["--use-dse", "--max-context", "2048", "--shared-pool"],
     "kv_quant=kv8")])
def test_launch_serve_serves_hymba(extra, picked, capsys):
    outs = serve(["--arch", ARCH, "--reduced", "--device", "cpu",
                  "--requests", "3", "--max-new", "4", "--slots", "2"]
                 + extra)
    assert sorted(outs) == [0, 1, 2]
    assert all(len(o.token_ids) == 4 and o.finish_reason == "length"
               for o in outs.values())
    text = capsys.readouterr().out
    assert "3 requests, 12 tokens" in text
    if picked:
        assert f"[serve] DSE picked variant=compact {picked}" in text
