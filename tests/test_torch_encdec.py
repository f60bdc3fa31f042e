"""PyTorch port: the encoder-decoder family (reduced whisper-base: 2
encoder + 2 decoder layers, d_model 128, 2 heads x 32, GELU MLP, tied
embeddings), against the JAX reference on the same bridged weights, on
the CPU.

  * The encoder (non-causal self-attention with RoPE over the frame
    positions, `encoder_norm`) against the reference's
    `run_layers(stack="encoder")` within 2e-5 of max |enc_out|; the full
    forward (every decoder block's cross-attention over it) against
    `forward_train` within 2e-4 of max |logits|.
  * The engine, compact and discrete, float32 and bfloat16 cross K/V:
    the one-shot prefill runs the encoder once and writes each decoder
    layer's cross K/V, which equal the reference's cache leaves (f32
    within 2e-5, bf16 within one bf16 rounding); the prefill and 3
    decode steps (cross-attention through the paged partial over the
    encoder's pages) match the reference engine's logits (f32 2e-5 of
    max |logits|, bf16 1e-2, ROADMAP §C) and, at f32, the port's own
    forward within 2e-4 (the reference's golden bound).  One case walks
    the encoder's pages in 2 partitions.
  * The refusals, in both packages at the same point with the same
    exception type: the interleaved server's first step (chunked
    prefill, ValueError), the splice server's first step (no frames,
    KeyError), `verify_step` and `prefill_chunk` (ValueError),
    speculation at construction (ValueError), and an encoder length that
    is no page multiple (the reference fails at its first decode step,
    the port at the prefill).
  * Checkpoints of whisper's tree (`encoder/*`, `encoder_norm`,
    `layers/ln_cross`, `layers/cross/*`), float32 and W4A16, cross
    between the packages both ways.
  * `launch.serve --arch whisper-base` ends as the reference's does."""
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
from repro.models.layers import rms_norm as j_rms_norm
from repro.models.registry import Model
from repro.models.transformer import Runtime as JRuntime
from repro.models.transformer import forward_train, run_layers
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

ARCH = "whisper-base"
GOLDEN_TOL = 2e-4         # the reference's tests/test_engine_golden.py
F32_TOL = 2e-5            # port vs reference, f32 (ROADMAP §C)
BF16_TOL = 1e-2           # logits over bf16 pools (ROADMAP §C)
S_PROMPT, N_DECODE, S_ENC, T = 13, 3, 32, 8


@pytest.fixture(scope="module")
def weights():
    """(reference cfg, reference params, port cfg, port params), built
    once for the module."""
    cfg = get_config(ARCH).reduced()
    params = Model(cfg).init(jax.random.PRNGKey(0))
    return cfg, params, tget(ARCH).reduced(), bridge.params_from_numpy(
        jax.tree.map(np.asarray, params), "cpu")


def _inputs(cfg, n_enc=S_ENC):
    """Tokens [2, S_PROMPT + N_DECODE] and frames [2, n_enc, D] from a
    seed, as (jax batch, port batch)."""
    r = np.random.default_rng(4)
    toks = r.integers(0, cfg.vocab_size, (2, S_PROMPT + N_DECODE))
    fr = r.standard_normal((2, n_enc, cfg.d_model)).astype(np.float32)
    return ({"tokens": jnp.asarray(toks), "frames": jnp.asarray(fr)},
            {"tokens": torch.from_numpy(toks), "frames": torch.from_numpy(fr)})


def _head(batch, n):
    return {k: v[:, :n] if k == "tokens" else v for k, v in batch.items()}


def _rel(got: torch.Tensor, want) -> float:
    want = np.asarray(want, np.float32)
    return float(np.abs(got.float().numpy() - want).max()
                 / np.abs(want).max())


def test_config_is_whispers():
    full = tget(ARCH)
    assert (full.family, full.is_encoder_decoder, full.encoder_layers,
            full.n_layers, full.d_model, full.n_heads, full.n_kv_heads,
            full.d_head, full.d_ff, full.vocab_size, full.gated_mlp,
            full.tie_embeddings) == ("audio", True, 6, 6, 512, 8, 8, 64,
                                     2048, 51865, False, True)


def test_encoder_matches_reference(weights):
    cfg, params, tcfg, tparams = weights
    jb, tb = _inputs(cfg)
    rt = JRuntime()
    pos = jnp.broadcast_to(jnp.arange(S_ENC)[None], (2, S_ENC))
    want, _ = run_layers(params, cfg, jb["frames"], rt, pos, stack="encoder")
    want = j_rms_norm(want, params["encoder_norm"], cfg.norm_eps)
    got = ttr.run_encoder(tparams, tcfg, tb["frames"], ttr.Runtime())
    assert got.shape == (2, S_ENC, cfg.d_model)
    assert _rel(got, want) <= F32_TOL


def test_forward_matches_reference(weights):
    cfg, params, tcfg, tparams = weights
    jb, tb = _inputs(cfg)
    want = forward_train(params, cfg, jb, JRuntime())[0]
    got = ttr.forward(tparams, tcfg, tb, ttr.Runtime())
    assert got.shape == want.shape
    assert _rel(got, want) <= GOLDEN_TOL


@pytest.mark.parametrize("variant,kv_dtype,parts", [
    ("compact", "float32", 0), ("discrete", "float32", 0),
    ("compact", "bfloat16", 0), ("discrete", "bfloat16", 0),
    ("compact", "float32", 2)],
    ids=["compact-f32", "discrete-f32", "compact-bf16", "discrete-bf16",
         "compact-f32-2parts"])
def test_engine_matches_reference_engine(weights, variant, kv_dtype, parts):
    cfg, params, tcfg, tparams = weights
    jb, tb = _inputs(cfg)
    ctx = 32                       # 4 pages, as the encoder's 32 frames
    kw = dict(variant=variant, page_tokens=T, kv_dtype=kv_dtype,
              attn_partitions=parts)
    jeng = KVNANDEngine(cfg, EngineConfig(**kw))
    teng = TEngine(tcfg, TEngineConfig(**kw), device="cpu")
    jlg, jc = jeng.prefill(params, _head(jb, S_PROMPT), ctx)
    tlg, tc = teng.prefill(tparams, _head(tb, S_PROMPT), ctx)
    # the cross K/V leaves: [L, B, Senc, K, dh] in the pool dtype
    dt = getattr(torch, kv_dtype)
    for name in ("cross_k", "cross_v"):
        got, want = getattr(tc, name), getattr(jc, name)
        assert got.dtype == dt and tuple(got.shape) == tuple(want.shape) == (
            cfg.n_layers, 2, S_ENC, cfg.n_kv_heads, cfg.d_head)
        tol = F32_TOL if kv_dtype == "float32" else 2 ** -8
        assert _rel(got, want.astype(jnp.float32)) <= tol, name
    full = ttr.forward(tparams, tcfg, tb, ttr.Runtime())
    steps = [(jlg, tlg, S_PROMPT - 1)]
    for t in range(N_DECODE):
        sl = slice(S_PROMPT + t, S_PROMPT + t + 1)
        jlg, jc = jeng.decode_step(params, jc, jb["tokens"][:, sl])
        tlg, tc = teng.decode_step(tparams, tc, tb["tokens"][:, sl])
        steps.append((jlg, tlg, S_PROMPT + t))
    assert tc.lengths.tolist() == [S_PROMPT + N_DECODE] * 2
    scale = float(full.abs().max())
    for jlg, tlg, pos in steps:
        if kv_dtype == "float32":
            assert np.abs(tlg.numpy() - np.asarray(jlg)).max() <= (
                F32_TOL * scale)
            assert float((tlg - full[:, pos]).abs().max()) <= (
                GOLDEN_TOL * scale)
        else:
            assert np.abs(tlg.numpy() - np.asarray(jlg)).max() <= BF16_TOL


def test_cross_pages_are_the_stored_leaves(weights):
    """The decode step reads each layer's cross K/V as contiguous pages
    [B, K, Senc / T, T, dh] of the leaf itself (no copy): page j holds
    encoder positions j·T .. j·T + T - 1."""
    from repro_torch.core import paged_kv
    _, _, tcfg, tparams = weights
    _, tb = _inputs(get_config(ARCH).reduced())
    teng = TEngine(tcfg, TEngineConfig(page_tokens=T, kv_dtype="float32"),
                   device="cpu")
    _, tc = teng.prefill(tparams, _head(tb, S_PROMPT), 32)
    pages = paged_kv.cross_pages(tc.cross_k[1], T)
    assert pages.is_contiguous() and pages.data_ptr() == (
        tc.cross_k[1].data_ptr())
    assert torch.equal(pages[:, :, 2, 3], tc.cross_k[1][:, 2 * T + 3])


@pytest.mark.parametrize("scheduler,err", [
    ("interleaved", ValueError), ("splice", KeyError)])
def test_servers_fail_as_the_reference_servers_do(weights, scheduler, err):
    """Both packages' servers construct for whisper and fail at their
    first step: chunked prefill refuses encoder-decoder archs; the splice
    scheduler's one-shot prefill finds no frames (its batches carry
    tokens only)."""
    cfg, params, tcfg, tparams = weights
    eng = dict(page_tokens=16, uniform_lengths=False, kv_dtype="float32")
    ref = JServer(JConfig(engine=EngineConfig(**eng), scheduler=scheduler),
                  cfg=cfg, params=params)
    ref.submit([1, 2, 3, 4, 5], JParams(max_new_tokens=3))
    with pytest.raises(err) as want:
        ref.step()
    srv = KVNANDServer(ServerConfig(engine=TEngineConfig(**eng),
                                    scheduler=scheduler, device="cpu"),
                       cfg=tcfg, params=tparams)
    srv.submit([1, 2, 3, 4, 5], SamplingParams(max_new_tokens=3))
    with pytest.raises(err) as got:
        srv.step()
    assert str(got.value) == str(want.value)


def test_speculation_is_refused_at_construction(weights):
    cfg, params, tcfg, tparams = weights
    eng = dict(page_tokens=16, uniform_lengths=False)
    with pytest.raises(ValueError, match="encoder-decoder") as want:
        JServer(JConfig(engine=EngineConfig(**eng, speculation_k=2)),
                cfg=cfg, params=params)
    with pytest.raises(ValueError, match="encoder-decoder") as got:
        KVNANDServer(ServerConfig(engine=TEngineConfig(**eng),
                                  speculation_k=2, device="cpu"),
                     cfg=tcfg, params=tparams)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("call", ["verify_step", "prefill_chunk"])
def test_engine_refuses_chunks_and_spans(weights, call):
    cfg, params, tcfg, tparams = weights
    jeng = KVNANDEngine(cfg, EngineConfig(page_tokens=T,
                                          uniform_lengths=False))
    teng = TEngine(tcfg, TEngineConfig(page_tokens=T, uniform_lengths=False),
                   device="cpu")
    jc, tc = jeng.init_cache(1, 32), teng.init_cache(1, 32)
    toks = [[1, 2, 3]]
    if call == "verify_step":
        calls = (lambda: jeng.verify_step(params, jc, jnp.asarray(toks),
                                          accept=None),
                 lambda: teng.verify_step(tparams, tc, torch.tensor(toks),
                                          accept=None))
    else:
        calls = (lambda: jeng.prefill_chunk(
            params, jc, {"tokens": jnp.asarray(toks)}, 0, 0, 3, first=True),
                 lambda: teng.prefill_chunk(
            tparams, tc, {"tokens": torch.tensor(toks)}, 0, 0, 3,
            first=True))
    msgs = []
    for f in calls:
        with pytest.raises(ValueError, match="encoder-decoder") as e:
            f()
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


def test_encoder_length_must_be_a_page_multiple(weights):
    """20 frames over 8-token pages: the reference prefills, then its
    first decode step cannot reshape the cross K/V into pages; the port
    refuses at the prefill."""
    cfg, params, tcfg, tparams = weights
    jb, tb = _inputs(cfg, n_enc=20)
    jeng = KVNANDEngine(cfg, EngineConfig(page_tokens=T,
                                          kv_dtype="float32"))
    _, jc = jeng.prefill(params, _head(jb, S_PROMPT), 32)
    with pytest.raises(TypeError, match="reshape"):
        jeng.decode_step(params, jc, jb["tokens"][:, S_PROMPT:S_PROMPT + 1])
    teng = TEngine(tcfg, TEngineConfig(page_tokens=T, kv_dtype="float32"),
                   device="cpu")
    with pytest.raises(ValueError, match="multiple of page_tokens=8"):
        teng.prefill(tparams, _head(tb, S_PROMPT), 32)


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
    """whisper's tree saved by one package restores bit for bit in the
    other, the encoder and cross-attention leaves included (W4A16: their
    matmul weights as q / scale records), and serves the same forward."""
    cfg, params, tcfg, _ = weights
    params = quantize_params(params, quant)
    tparams = bridge.params_from_numpy(jax.tree.map(np.asarray, params),
                                       "cpu")
    if direction == "reference_to_port":
        jck.save_checkpoint(str(tmp_path), 4, _as_records(params))
        restored, _ = ck.restore_checkpoint(str(tmp_path), 4, tparams)
    else:
        ck.save_checkpoint(str(tmp_path), 4, tparams)
        like = jax.tree.map(jnp.zeros_like, _as_records(params))
        jres, _ = jck.restore_checkpoint(str(tmp_path), 4, like)
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
    assert {"encoder/attn/wq_w", "encoder/mlp/up_w", "encoder_norm",
            "layers/ln_cross", "layers/cross/wk_w"} <= set(got)
    for k in want:
        if isinstance(want[k], tquant.QuantizedWeight):
            assert torch.equal(got[k].q, want[k].q), k
            assert torch.equal(got[k].scale, want[k].scale), k
            assert got[k].orig_shape == want[k].orig_shape, k
        else:
            assert torch.equal(got[k], want[k]), k
    _, tb = _inputs(cfg)
    torch.testing.assert_close(
        ttr.forward(restored, tcfg, tb, ttr.Runtime()),
        ttr.forward(tparams, tcfg, tb, ttr.Runtime()), rtol=0, atol=0)


def test_launch_serve_ends_as_the_reference_does():
    """The reference's `launch.serve --arch whisper-base` raises its
    chunked prefill's ValueError at the first step; so does the port's
    (its server constructs, as the reference's does)."""
    with pytest.raises(ValueError, match="encoder-decoder archs"):
        serve(["--arch", ARCH, "--reduced", "--device", "cpu",
               "--requests", "2", "--max-new", "3", "--slots", "2"])
