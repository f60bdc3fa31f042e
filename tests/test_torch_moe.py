"""PyTorch port: the MoE family (reduced mixtral-8x7b: 2 layers, d_model
128, 4 query heads over 2 kv heads, 4 experts, top-2, d_ff 256 per
expert), against the JAX reference on the same bridged weights, on the
CPU.

  * `layers.moe` against `repro.models.layers.moe` on the same numpy
    inputs: batch 1 and 3, lengths 1, 5, 21 and 64, capacity factors 0.5
    and 1.25 (both drop tokens) and E / top_k (none can drop), float32
    experts and W4A16 / W8A8 ones through the bridge, with rows of zeros
    whose gates all tie: within 1e-5 of max |reference|.  A token the
    port keeps and the reference drops (or the other way) moves its row
    by its whole expert output, far above that.
  * `moe_route` against a plain Python walk of the dispatch (top-k by
    gate with ties to the lower id, each expert's slots handed out in
    token order until C), so the kept / dropped sets are checked
    directly, and the capacity against the reference's formula.
  * `init_moe`'s tree, shapes and scales against the reference's; the
    quantized tree (3-D codes and scales) bit-equal to the reference's
    `quantize_params`, through `layer_slice` and `dequantize`.
  * The plain full forward of mixtral, dbrx-132b and kimi-k2-1t-a32b
    (reduced) against `forward_train` within 2e-4 relative.
  * `verify_step` over a 5-token span (k = 4) against the JAX engine's:
    the span is one `moe` call per layer of [B, 5].
  * Checkpoints of the MoE tree, float32 and W4A16, cross between the
    packages both ways (a quantized leaf as its q / scale record).
  * The `launch.serve` CLI serves reduced mixtral with and without
    `--use-dse`.
The engine traces are in tests/test_torch_engine.py, the servers in
tests/test_torch_moe_server.py."""
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
from repro.models import layers as jlayers
from repro.models.registry import Model
from repro.models.transformer import Runtime as JRuntime
from repro.models.transformer import forward_train
from repro_torch import bridge
from repro_torch.checkpoint import checkpoint as ck
from repro_torch.configs import EngineConfig as TEngineConfig
from repro_torch.configs import get_config as tget
from repro_torch.core import quant as tquant
from repro_torch.core.engine import KVNANDEngine as TEngine
from repro_torch.kernels.quant_gemv import quant_gemv
from repro_torch.launch.serve import serve
from repro_torch.models import layers as tlayers
from repro_torch.models.registry import Model as TModel

torch.set_num_threads(2)

ARCH = "mixtral-8x7b"
MOE_TOL = 1e-5
LOGIT_TOL = 2e-4
_CACHE = {}


def _weights(arch=ARCH, quant="none"):
    """(reference cfg, reference params, port cfg, port params)."""
    key = (arch, quant)
    if key not in _CACHE:
        cfg = get_config(arch).reduced()
        params = quantize_params(Model(cfg).init(jax.random.PRNGKey(0)),
                                 quant)
        tparams = bridge.params_from_numpy(jax.tree.map(np.asarray, params),
                                           "cpu")
        _CACHE[key] = (cfg, params, tget(arch).reduced(), tparams)
    return _CACHE[key]


def _layer0(tree):
    return jax.tree.map(lambda a: a[0], tree)


def _moe_inputs(B, S, D, seed):
    """Normal rows, the first two positions of row 0 zero (every gate
    ties there)."""
    x = np.random.default_rng(seed).standard_normal((B, S, D))
    x = x.astype(np.float32)
    x[0, :2] = 0.0
    return x


def _rel(t, j):
    j = np.asarray(j, np.float32)
    return float(np.abs(t.float().numpy() - j).max() / np.abs(j).max())


CAPACITIES = [0.5, 1.25, 2.0]         # 2.0 = E / top_k: nothing drops


@pytest.mark.parametrize("quant", ["none", "w4a16", "w8a8"])
@pytest.mark.parametrize("capacity", CAPACITIES)
@pytest.mark.parametrize("S", [1, 5, 21, 64])
@pytest.mark.parametrize("B", [1, 3])
def test_moe_matches_reference(B, S, capacity, quant):
    cfg, params, _, tparams = _weights(quant=quant)
    jp, tp = _layer0(params["layers"])["moe"], tlayers.layer_slice(
        tparams["layers"], 0)["moe"]
    x = _moe_inputs(B, S, cfg.d_model, seed=S * 10 + B)
    want = np.asarray(jlayers.moe(jp, jnp.asarray(x), top_k=cfg.top_k,
                                  capacity_factor=capacity))
    got = tlayers.moe(tp, torch.from_numpy(x), top_k=cfg.top_k,
                      capacity_factor=capacity)
    assert got.shape == (B, S, cfg.d_model) and got.dtype == torch.float32
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got.numpy() - want).max()) / scale
    assert err <= MOE_TOL, err
    # the zero positions: every gate ties, both pick experts 0 and 1
    r = tlayers.moe_route(tp, torch.from_numpy(x), top_k=cfg.top_k,
                          capacity_factor=capacity)
    assert r.top_idx[0, :min(S, 2)].tolist() == [[0, 1]] * min(S, 2)


def _plain_route(gates, top_k, C):
    """The dispatch walked pair by pair: per row, top-k experts by gate
    (ties to the lower id), slots of each expert handed out in (token,
    choice) order; returns keep [B, S·k] as nested lists."""
    keep = []
    for row in gates:
        used = {}
        kr = []
        for g in row:
            for e in sorted(range(len(g)), key=lambda i: (-g[i], i))[:top_k]:
                used[e] = used.get(e, 0) + 1
                kr.append(used[e] <= C)
        keep.append(kr)
    return keep


@pytest.mark.parametrize("capacity", CAPACITIES)
@pytest.mark.parametrize("S", [1, 21, 64])
def test_moe_route_keeps_what_the_plain_walk_keeps(S, capacity):
    cfg, _, _, tparams = _weights()
    tp = tlayers.layer_slice(tparams["layers"], 1)["moe"]
    x = torch.from_numpy(_moe_inputs(3, S, cfg.d_model, seed=7 + S))
    r = tlayers.moe_route(tp, x, top_k=cfg.top_k, capacity_factor=capacity)
    E = cfg.n_experts
    C = tlayers.moe_capacity(S, E, cfg.top_k, capacity)
    assert r.capacity == C == max(1, int(np.ceil(capacity * 2 * S / E)))
    gates = torch.softmax(x @ tp["router_w"], -1).tolist()
    assert r.keep.tolist() == _plain_route(gates, cfg.top_k, C)
    # kept pairs own distinct slots of their expert; dropped ones E·C
    slot, keep = r.slot, r.keep
    assert ((slot == E * C) == ~keep).all()
    for b in range(3):
        kept = slot[b][keep[b]].tolist()
        assert len(set(kept)) == len(kept)
        fe = r.top_idx[b].reshape(-1)[keep[b]]
        assert (torch.as_tensor(kept) // C == fe).all()
    if capacity == 2.0:
        assert keep.all()
    torch.testing.assert_close(r.top_vals.sum(-1),
                               torch.ones(3, S), rtol=1e-6, atol=1e-6)


def test_init_matches_the_reference_tree():
    cfg, params, tcfg, _ = _weights()
    fresh = TModel(tcfg).init(torch.Generator().manual_seed(0))
    jflat = bridge.flatten_with_paths(jax.tree.map(np.asarray, params))
    tflat = bridge.flatten_with_paths(fresh)
    assert sorted(jflat) == sorted(tflat)
    assert not any(k.startswith("layers/mlp") for k in tflat)
    for k in jflat:
        assert tuple(tflat[k].shape) == jflat[k].shape, k
    L, E, D, F = cfg.n_layers, cfg.n_experts, cfg.d_model, cfg.d_ff
    assert tflat["layers/moe/router_w"].shape == (L, D, E)
    assert tflat["layers/moe/w_gate"].shape == (L, E, D, F)
    assert tflat["layers/moe/w_down"].shape == (L, E, F, D)
    # fan-in scales: D for the router, gate and up, F for down
    for k, fan in (("router_w", D), ("w_gate", D), ("w_up", D),
                   ("w_down", F)):
        for flat in (jflat, tflat):
            std = float(np.std(np.asarray(flat[f"layers/moe/{k}"])))
            assert abs(std * np.sqrt(fan) - 1) < 0.1, (k, std)


@pytest.mark.parametrize("scheme", ["w4a16", "w8a8"])
def test_quantized_expert_tree_matches_reference(scheme):
    """3-D expert stacks [L, E, D(/2), F] quantize bit-equal to the
    reference, the router stays float, and a layer's slice dequantizes to
    the reference's dequantized weight exactly."""
    _, params, _, _ = _weights()
    _, qparams, _, tq = _weights(quant=scheme)
    fresh = tquant.quantize_params(
        bridge.params_from_numpy(jax.tree.map(np.asarray, params), "cpu"),
        scheme)
    from repro.core.quant import dequantize as jdequant
    for k in ("w_gate", "w_up", "w_down"):
        jw, bw, fw = (qparams["layers"]["moe"][k], tq["layers"]["moe"][k],
                      fresh["layers"]["moe"][k])
        assert isinstance(fw, tquant.QuantizedWeight) and fw.q.ndim == 4
        for w in (bw, fw):
            np.testing.assert_array_equal(w.q.numpy(), np.asarray(jw.q))
            np.testing.assert_array_equal(w.scale.numpy(),
                                          np.asarray(jw.scale))
        one = tlayers.layer_slice(fresh["layers"], 1)["moe"][k]
        assert one.orig_shape == jw.orig_shape[1:]
        np.testing.assert_array_equal(
            tquant.dequantize(one, torch.float32).numpy(),
            np.asarray(jdequant(JQuantizedWeight(jw.q[1], jw.scale[1],
                                                 scheme, jw.orig_shape[1:]),
                                jnp.float32)))
    assert isinstance(fresh["layers"]["moe"]["router_w"], torch.Tensor)


def test_quant_gemv_refuses_a_stacked_weight():
    _, _, _, tq = _weights(quant="w4a16")
    w = tlayers.layer_slice(tq["layers"], 0)["moe"]["w_gate"]
    with pytest.raises(NotImplementedError, match="ROADMAP B"):
        quant_gemv(torch.zeros(1, w.orig_shape[-2]), w)


@pytest.mark.parametrize("arch", [ARCH, "dbrx-132b", "kimi-k2-1t-a32b"])
def test_forward_matches_reference(arch):
    cfg, params, tcfg, tparams = _weights(arch)
    toks = np.random.default_rng(0).integers(1, cfg.vocab_size, (2, 40))
    jl, _ = forward_train(params, cfg, {"tokens": jnp.asarray(toks)},
                          JRuntime())
    tl = TModel(tcfg).forward(tparams, {"tokens": torch.from_numpy(toks)})
    assert tl.shape == (2, 40, cfg.padded_vocab)
    assert _rel(tl, jl) < LOGIT_TOL


@pytest.mark.parametrize("shared", [False, True], ids=["stripe", "shared"])
def test_verify_step_matches_reference(shared):
    """Chunked prefill of two slots (40 and 9 tokens), then one verify
    step over a 5-token span (the last token and 4 drafts, k = 4): the
    span's logits within 2e-4 relative of the JAX engine's, and the kept
    positions (3 of row 0, 1 of row 1) written alike."""
    cfg, params, tcfg, tparams = _weights()
    kw = dict(page_tokens=8, kv_dtype="float32", uniform_lengths=False,
              shared_pool=shared)
    je = KVNANDEngine(cfg, EngineConfig(**kw))
    te = TEngine(tcfg, TEngineConfig(**kw), device="cpu")
    jc, tc = je.init_cache(2, 64), te.init_cache(2, 64)
    r = np.random.default_rng(5)
    for slot, n in ((0, 40), (1, 9)):
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
    n_acc = np.asarray([2, 0])
    got = {}

    def jaccept(logits):
        got["j"] = logits
        return jnp.asarray(n_acc), None

    def taccept(logits):
        got["t"] = logits
        return torch.from_numpy(n_acc), None

    _, jc = je.verify_step(params, jc, jnp.asarray(span), accept=jaccept)
    te.verify_step(tparams, tc, torch.from_numpy(span), accept=taccept)
    assert got["t"].shape == (2, 5, cfg.padded_vocab)
    assert _rel(got["t"], got["j"]) < LOGIT_TOL
    assert tc.lengths.tolist() == np.asarray(jc.lengths).tolist() == [43, 10]
    for name in ("k_pages_g", "v_pages_g"):
        np.testing.assert_allclose(getattr(tc, name).numpy(),
                                   np.asarray(getattr(jc, name)),
                                   atol=1e-5, rtol=1e-5)


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
def test_checkpoints_cross_between_the_packages(direction, quant, tmp_path):
    """The MoE tree (router, 3-D expert stacks; W4A16 codes and scales)
    saved by one package restores bit for bit in the other, and the
    restored weights serve the same forward."""
    cfg, params, tcfg, tparams = _weights(quant=quant)
    if direction == "reference_to_port":
        jck.save_checkpoint(str(tmp_path), 3, _as_records(params))
        restored, _ = ck.restore_checkpoint(str(tmp_path), 3, tparams)
    else:
        ck.save_checkpoint(str(tmp_path), 3, tparams)
        like = jax.tree.map(jnp.zeros_like, _as_records(params))
        jres, _ = jck.restore_checkpoint(str(tmp_path), 3, like)
        jres = jax.tree.map(
            lambda r, w: JQuantizedWeight(r.q, r.scale, w.scheme,
                                          w.orig_shape)
            if isinstance(w, JQuantizedWeight) else r,
            jres, params, is_leaf=lambda r: isinstance(r, QRecord))
        restored = bridge.params_from_numpy(jax.tree.map(np.asarray, jres),
                                            "cpu")
    want = bridge.flatten_with_paths(tparams)
    got = bridge.flatten_with_paths(restored)
    assert sorted(got) == sorted(want)
    assert "layers/moe/w_gate" in got and "layers/moe/router_w" in got
    for k in want:
        if isinstance(want[k], tquant.QuantizedWeight):
            assert isinstance(got[k], tquant.QuantizedWeight), k
            assert (got[k].scheme, got[k].orig_shape) == (
                want[k].scheme, want[k].orig_shape)
            assert torch.equal(got[k].q, want[k].q), k
            assert torch.equal(got[k].scale, want[k].scale), k
        else:
            assert torch.equal(got[k], want[k]), k
    toks = torch.arange(1, 20)[None]
    m = TModel(tcfg)
    torch.testing.assert_close(m.forward(restored, {"tokens": toks}),
                               m.forward(tparams, {"tokens": toks}),
                               rtol=0, atol=0)


def test_reference_checkpoint_cannot_restore_its_own_quantized_leaf(
        tmp_path):
    """The reference stores its `QuantizedWeight` leaf as a pickled object
    array, which its own restore refuses (ROADMAP §C): the record form
    above is the one both packages read."""
    _, params, _, _ = _weights(quant="w4a16")
    jck.save_checkpoint(str(tmp_path), 1, params)
    with pytest.raises(ValueError, match="allow_pickle"):
        jck.restore_checkpoint(str(tmp_path), 1,
                               jax.tree.map(jnp.zeros_like, params))


@pytest.mark.parametrize("extra,picked", [
    ([], None), (["--use-dse"], "variant=compact kv_quant=none"),
    (["--use-dse", "--max-context", "8192", "--shared-pool"],
     "variant=compact kv_quant=kv8")])
def test_launch_serve_serves_mixtral(extra, picked, capsys):
    outs = serve(["--arch", ARCH, "--reduced", "--device", "cpu",
                  "--requests", "3", "--max-new", "4", "--slots", "2"]
                 + extra)
    assert sorted(outs) == [0, 1, 2]
    assert all(len(o.token_ids) == 4 and o.finish_reason == "length"
               for o in outs.values())
    text = capsys.readouterr().out
    assert "3 requests, 12 tokens" in text
    if picked:
        assert f"[serve] DSE picked {picked}" in text
