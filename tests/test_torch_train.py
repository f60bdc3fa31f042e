"""PyTorch port: the training path against the JAX reference, on the CPU
(reduced configs, the reference's weights through the bridge, the same
numpy-made batches).

  * Loss and gradients of every family (dense MHA, GQA, window layers,
    MoE with its load-balancing loss, hybrid with meta tokens and the SSM
    mixer, VLM with patches, encoder-decoder with frames, RWKV6 through
    the plain chunked wkv): `grads_and_metrics` against the reference's,
    the loss within 1e-5 and every leaf within atol 1e-4, rtol 1e-3 (the
    reference's own tolerance, tests/test_train_integration.py).
  * The sequence-chunked CE (`Runtime.loss_chunk`), remat "block" and
    "full", and 2 microbatches, each against the plain loss and
    gradients; remat="block"'s policy saves the weight products only.
  * `FlashAttentionFn`'s backward with the plain forward in B4's place,
    against autograd of the plain version (causal, window, GQA, Sq != Sk
    non-causal, a q offset, a block walk of 3 keys, bf16), and
    `torch.autograd.gradcheck` in float64; a CUDA call under grad takes
    the Function, and the backward runs no plain forward.
  * Five `make_train_step` steps against the reference's.
  * `wkv6` on a CUDA call under grad refuses, naming ROADMAP A18b."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import EngineConfig as JEngineConfig
from repro.configs import get_config
from repro.models.registry import Model as JModel
from repro.models.transformer import Runtime as JRuntime
from repro.training.optimizer import AdamWConfig as JAdamWConfig
from repro.training.train_step import grads_and_metrics as j_grads
from repro.training.train_step import init_train_state as j_init_state
from repro.training.train_step import make_train_step as j_make_step
from repro_torch import bridge
from repro_torch.bridge import tree_leaves
from repro_torch.configs import EngineConfig, get_config as tget
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.flash_attention import ref as fa_ref
from repro_torch.kernels.wkv6 import wkv6
from repro_torch.models import transformer as ttr
from repro_torch.models.registry import Model
from repro_torch.training.optimizer import AdamWConfig
from repro_torch.training.train_step import (grads_and_metrics,
                                             init_train_state,
                                             make_train_step)

torch.set_num_threads(2)

LOSS_TOL = 1e-5
GRAD_ATOL, GRAD_RTOL = 1e-4, 1e-3     # tests/test_train_integration.py
FLASH_F32_TOL = 2e-5                  # of max |grad|
ARCHS = ("qwen1.5-0.5b", "llama3.1-8b", "gemma3-12b", "mixtral-8x7b",
         "hymba-1.5b", "pixtral-12b", "whisper-base", "rwkv6-3b")
B, S, PATCHES, FRAMES = 2, 24, 8, 16


def _batch(cfg, seed=1, masked=False):
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (B, S)),
             "labels": rng.integers(0, cfg.vocab_size, (B, S))}
    batch = {k: v.astype(np.int32) for k, v in batch.items()}
    if masked:
        batch["labels"][0, :5] = -1
    if cfg.family == "vlm":
        batch["patches"] = rng.standard_normal(
            (B, PATCHES, cfg.d_model)).astype(np.float32)
    if cfg.is_encoder_decoder:
        batch["frames"] = rng.standard_normal(
            (B, FRAMES, cfg.d_model)).astype(np.float32)
    return batch


def _torch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


_WEIGHTS = {}


def _weights(arch):
    """(reference cfg, reference params, port cfg, port params), built
    once an arch."""
    if arch not in _WEIGHTS:
        cfg = get_config(arch).reduced()
        params = JModel(cfg).init(jax.random.PRNGKey(0))
        _WEIGHTS[arch] = (cfg, params, tget(arch).reduced(),
                          bridge.params_from_numpy(
                              jax.tree.map(np.asarray, params), "cpu"))
    return _WEIGHTS[arch]


def _assert_grads_close(want_leaves, got_leaves):
    assert len(want_leaves) == len(got_leaves)
    for want, got in zip(want_leaves, got_leaves):
        np.testing.assert_allclose(
            got.detach().float().numpy(), np.asarray(want, np.float32),
            atol=GRAD_ATOL, rtol=GRAD_RTOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_reference(arch):
    cfg, params, tcfg, tparams = _weights(arch)
    batch = _batch(cfg, masked=True)
    jg, jm = jax.jit(lambda p, b: j_grads(p, b, cfg, JRuntime(), "none", 1))(
        params, {k: jnp.asarray(v) for k, v in batch.items()})
    tg, tm = grads_and_metrics(tparams, _torch(batch), tcfg, ttr.Runtime(),
                               "none", 1)
    for k in ("loss", "ce", "aux"):
        assert abs(float(tm[k]) - float(jm[k])) <= LOSS_TOL, k
    if cfg.is_moe:
        assert float(tm["aux"]) > 0
    _assert_grads_close(jax.tree.leaves(jg), tree_leaves(tg))
    # the facade's loss is the same function
    loss, metrics = Model(tcfg).loss(tparams, _torch(batch))
    assert float(loss) == float(tm["loss"])


def _port_grads(arch, remat="none", microbatches=1, loss_chunk=0,
                masked=True):
    _, _, tcfg, tparams = _weights(arch)
    return grads_and_metrics(tparams, _torch(_batch(tcfg, masked=masked)),
                             tcfg, ttr.Runtime(loss_chunk=loss_chunk),
                             remat, microbatches)


def _assert_same_step(got, want, tol=1e-6):
    (gg, gm), (wg, wm) = got, want
    assert abs(float(gm["loss"]) - float(wm["loss"])) <= tol
    for a, b in zip(tree_leaves(gg), tree_leaves(wg)):
        torch.testing.assert_close(a.float(), b.float(), atol=GRAD_ATOL,
                                   rtol=GRAD_RTOL)


@pytest.mark.parametrize("chunk", [5, 7, 24])
def test_chunked_ce_equals_the_unchunked_loss(chunk):
    _assert_same_step(_port_grads("qwen1.5-0.5b", loss_chunk=chunk),
                      _port_grads("qwen1.5-0.5b"))


@pytest.mark.parametrize("arch", ["qwen1.5-0.5b", "hymba-1.5b",
                                  "whisper-base", "mixtral-8x7b"])
@pytest.mark.parametrize("remat", ["block", "full"])
def test_remat_equals_none(arch, remat):
    got, want = _port_grads(arch, remat=remat), _port_grads(arch)
    _assert_same_step(got, want)
    # a recompute runs the same ops on the same inputs: the same bits
    for a, b in zip(tree_leaves(got[0]), tree_leaves(want[0])):
        assert torch.equal(a, b)


def test_block_policy_saves_the_weight_products():
    aten = torch.ops.aten
    x2, w2 = torch.zeros(4, 3), torch.zeros(3, 2)
    pol = ttr._saves_weight_product
    save = torch.utils.checkpoint.CheckpointPolicy.MUST_SAVE
    assert pol(None, aten.mm.default, x2, w2) == save
    assert pol(None, aten.addmm.default, x2, x2, w2) == save
    assert pol(None, aten.bmm.default, x2[None], w2[None]) == save
    assert pol(None, aten.bmm.default, x2.expand(5, 4, 3),
               w2.expand(5, 3, 2)) != save
    assert pol(None, aten.mul.Tensor, x2, x2) != save
    with pytest.raises(ValueError, match="remat"):
        _port_grads("qwen1.5-0.5b", remat="blocks")


@pytest.mark.parametrize("arch", ["qwen1.5-0.5b", "hymba-1.5b"])
def test_microbatches_equal_the_full_batch(arch):
    (g2, m2), (g1, m1) = (_port_grads(arch, microbatches=2, masked=False),
                          _port_grads(arch, masked=False))
    assert abs(float(m2["loss"]) - float(m1["loss"])) < 1e-5
    for a, b in zip(tree_leaves(g2), tree_leaves(g1)):
        assert a.dtype == torch.float32
        torch.testing.assert_close(a, b, atol=GRAD_ATOL, rtol=GRAD_RTOL)
    with pytest.raises(ValueError, match="microbatches"):
        _port_grads(arch, microbatches=3)


def test_moe_microbatches_match_the_reference():
    """The load-balancing loss is not additive over a batch (a product of
    two batch means), so 2 microbatches differ from one for an MoE arch,
    in both packages alike: the mean of the microbatches' metrics and
    the accumulated gradients equal the reference's."""
    cfg, params, tcfg, tparams = _weights("mixtral-8x7b")
    batch = _batch(cfg)
    jg, jm = jax.jit(lambda p, b: j_grads(p, b, cfg, JRuntime(), "none", 2))(
        params, {k: jnp.asarray(v) for k, v in batch.items()})
    tg, tm = grads_and_metrics(tparams, _torch(batch), tcfg, ttr.Runtime(),
                               "none", 2)
    for k in ("loss", "ce", "aux"):
        assert abs(float(tm[k]) - float(jm[k])) <= LOSS_TOL, k
    _assert_grads_close(jax.tree.leaves(jg), tree_leaves(tg))


# ---------------------------------------------------------------------------
# FlashAttentionFn: the backward's formulas, with the plain forward in B4's
# place
# ---------------------------------------------------------------------------

FLASH_CASES = [
    # B, Sq, Sk, H, K, dh, causal, window, q_offset, dtype
    (2, 70, 70, 4, 4, 32, True, None, 0, torch.float32),      # causal MHA
    (1, 96, 96, 4, 4, 32, True, 16, 0, torch.float32),        # window
    (2, 70, 70, 8, 2, 32, True, None, 0, torch.float32),      # GQA
    (2, 24, 96, 4, 2, 32, False, None, 0, torch.float32),     # cross
    (1, 40, 100, 4, 1, 64, True, 30, 60, torch.float32),      # q offset
    (1, 600, 600, 4, 2, 32, True, None, 0, torch.float32),    # 2 key blocks
    (2, 70, 70, 8, 2, 32, True, 20, 0, torch.bfloat16),
]


def _flash_inputs(B_, Sq, Sk, H, K, dh, dtype, seed=0):
    g = torch.Generator().manual_seed(seed)
    q, k, v = (torch.randn(shape, generator=g).to(dtype).requires_grad_()
               for shape in ((B_, Sq, H, dh), (B_, Sk, K, dh),
                             (B_, Sk, K, dh)))
    return q, k, v, torch.randn((B_, Sq, H, dh), generator=g).to(dtype)


@pytest.mark.parametrize("case", FLASH_CASES)
def test_flash_backward_matches_autograd_of_the_plain_version(case):
    B_, Sq, Sk, H, K, dh, causal, window, q_offset, dtype = case
    q, k, v, dout = _flash_inputs(B_, Sq, Sk, H, K, dh, dtype)
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    out = tfa.FlashAttentionFn.apply(q, k, v, causal, window, q_offset,
                                     tfa.flash_attention_ref)
    got = torch.autograd.grad(out, (q, k, v), dout)
    want = torch.autograd.grad(tfa.flash_attention_ref(q, k, v, **kw),
                               (q, k, v), dout)
    tol = FLASH_F32_TOL if dtype == torch.float32 else 2e-2
    for name, a, b in zip("qkv", got, want):
        assert a.dtype == b.dtype == dtype
        err = float((a.float() - b.float()).abs().max())
        assert err <= tol * float(b.float().abs().max()), (name, err)


def test_flash_backward_walks_the_keys_in_blocks():
    q, k, v, dout = _flash_inputs(2, 50, 50, 4, 2, 32, torch.float32)
    out = tfa.flash_attention_ref(q, k, v, causal=True, window=20)
    whole = tfa.flash_attention_backward(q, k, v, out, dout, causal=True,
                                         window=20)
    blocks = tfa.flash_attention_backward(q, k, v, out, dout, causal=True,
                                          window=20, block_k=3)
    for a, b in zip(blocks, whole):
        torch.testing.assert_close(a, b, atol=1e-6, rtol=1e-5)


def _dense64(q, k, v, *, causal, window, q_offset):
    """Exact float64 softmax attention with the plain version's masks (the
    forward gradcheck differentiates numerically)."""
    H, K = q.shape[2], k.shape[2]
    k, v = (x.repeat_interleave(H // K, dim=2) for x in (k, v))
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) * q.shape[-1] ** -0.5
    mask = fa_ref._mask(q_offset + torch.arange(q.shape[1]),
                        torch.arange(k.shape[1]), k.shape[1], causal=causal,
                        window=window, is_global=None)
    s = torch.where(mask, s, torch.full_like(s, fa_ref.NEG_INF))
    return torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s, -1), v)


@pytest.mark.parametrize("causal,window,q_offset,Sk", [
    (True, None, 0, 6), (True, 3, 0, 6), (False, None, 0, 9),
    (True, None, 3, 9)])
def test_flash_backward_gradcheck_float64(causal, window, q_offset, Sk):
    g = torch.Generator().manual_seed(3)
    q = torch.randn((1, 6, 4, 8), generator=g, dtype=torch.float64)
    k = torch.randn((1, Sk, 2, 8), generator=g, dtype=torch.float64)
    v = torch.randn((1, Sk, 2, 8), generator=g, dtype=torch.float64)
    for t in (q, k, v):
        t.requires_grad_()
    assert torch.autograd.gradcheck(
        lambda q, k, v: tfa.FlashAttentionFn.apply(
            q, k, v, causal, window, q_offset, _dense64), (q, k, v))


def test_a_cuda_call_under_grad_takes_the_function(monkeypatch):
    """`ops.flash_attention(impl="cuda")` launches through the Function
    when grad is on and an input requires grad, and directly otherwise;
    the kernel is replaced by a recording stand-in (no card here), and
    the plain versions are made to raise, so neither the forward nor the
    backward can reach them."""
    plain = tfa.flash_attention_ref
    calls = []

    def kernel(q, k, v, *, causal, window, q_offset):
        calls.append(q.requires_grad)
        return plain(q.detach(), k.detach(), v.detach(), causal=causal,
                     window=window, q_offset=q_offset)

    def refuse(*a, **kw):
        raise AssertionError("a plain forward ran")

    monkeypatch.setattr(fa_ops, "flash_attention_cuda", kernel)
    monkeypatch.setattr(fa_ops, "flash_attention_ref", refuse)
    monkeypatch.setattr(fa_ref, "flash_attention_ref", refuse)
    monkeypatch.setattr(fa_ref, "dense_attention_ref", refuse)
    q, k, v, dout = _flash_inputs(1, 20, 20, 4, 2, 32, torch.float32)
    out = fa_ops.flash_attention(q, k, v, window=8, impl="cuda")
    assert type(out.grad_fn).__name__ == "FlashAttentionFnBackward"
    got = torch.autograd.grad(out, (q, k, v), dout)
    want = torch.autograd.grad(plain(q, k, v, window=8), (q, k, v), dout)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, atol=1e-6, rtol=1e-5)
    with torch.no_grad():
        assert fa_ops.flash_attention(q, k, v, impl="cuda").grad_fn is None
    assert len(calls) == 2
    with pytest.raises(NotImplementedError, match="is_global"):
        fa_ops.flash_attention(q, k, v, window=8, is_global=True,
                               impl="cuda")


def test_wkv6_refuses_a_cuda_call_under_grad():
    """B5 has no backward: the wrapper raises, naming ROADMAP A18b, before
    any kernel or plain version runs."""
    r, k, v = (torch.randn(1, 4, 2, 8, requires_grad=True) for _ in range(3))
    logw = -torch.rand(1, 4, 2, 8) - 0.1
    state = torch.zeros(1, 2, 8, 8)
    with pytest.raises(NotImplementedError, match="A18b"):
        wkv6(r, k, v, logw, torch.zeros(2, 8), state, impl="cuda")


# ---------------------------------------------------------------------------
# five train steps
# ---------------------------------------------------------------------------

def test_five_train_steps_match_reference():
    """Five `make_train_step` steps of reduced qwen1.5-0.5b (lr 3e-3,
    warmup 2, clipping at 1) on the same weights and batches as the
    reference's jitted step: the losses within 1e-4.

    The params within 2 · Σ_t lr_t of the reference's.  AdamW's update of
    an element is lr_t · m̂ / (√v̂ + eps), whose size is about lr_t
    whatever the gradient's size: where a gradient is near zero its
    sign can differ between the two frameworks' float32 sums, and the
    element then moves by up to 2 · lr_t apart in that step (plus a
    weight-decay term lr_t · 0.1 · Δp, orders smaller).  The k bias is
    all such elements: it shifts every score of a row by the same q · b,
    which the softmax cancels, so its gradient is float32 noise and its
    updates are noise of size lr_t; it is held to that bound only.  In
    every other leaf the two agree to float32 noise, which the second
    check bounds: at least 99% of the elements within 1e-6 of the
    reference's (readings: the 99th percentile <= 7e-8)."""
    arch = "qwen1.5-0.5b"
    cfg, params, tcfg, _ = _weights(arch)
    kw = dict(lr=3e-3, warmup_steps=2, total_steps=5)
    jstep = jax.jit(j_make_step(cfg, JRuntime(), JAdamWConfig(**kw),
                                JEngineConfig(remat="none")))
    tstep = make_train_step(tcfg, ttr.Runtime(), AdamWConfig(**kw),
                            EngineConfig(remat="none"))
    jstate = j_init_state(params, JAdamWConfig(**kw))
    tstate = init_train_state(bridge.params_from_numpy(
        jax.tree.map(np.asarray, params), "cpu"), AdamWConfig(**kw))
    lr_sum = 0.0
    for i in range(5):
        batch = _batch(cfg, seed=10 + i)
        jstate, jm = jstep(jstate, {k: jnp.asarray(v)
                                    for k, v in batch.items()})
        tstate, tm = tstep(tstate, _torch(batch))
        assert abs(float(tm["loss"]) - float(jm["loss"])) <= 1e-4, i
        assert float(tm["lr"]) == pytest.approx(float(jm["lr"]), rel=1e-6)
        assert float(tm["grad_norm"]) == pytest.approx(
            float(jm["grad_norm"]), rel=1e-4)
        lr_sum += float(jm["lr"])
    back = bridge.train_state_to_numpy(tstate)
    assert int(back.opt.step) == int(jstate.opt.step) == 5
    flat = jax.tree_util.tree_flatten_with_path(jstate.params)[0]
    for (path, want), got in zip(flat, jax.tree.leaves(back.params)):
        diff = np.abs(got - np.asarray(want))
        assert diff.max() <= 2 * lr_sum
        if "wk_b" not in jax.tree_util.keystr(path):
            assert np.mean(diff <= 1e-6) >= 0.99, path
