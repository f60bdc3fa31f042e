"""PyTorch port: flash attention's plain versions against the JAX
reference — the Pallas kernel in interpret mode and its blocked jnp
oracle — over the reference's own sweep, the unaligned 70-token case and
a query offset; the dispatch rules of `flash_attention` on the CPU; the
refusals of the single-device `sharded_flash_attention` /
`attention_train`.

Tolerances are the reference's (tests/test_kernels_flash_attention.py):
2e-5 (atol and rtol) for float32, 2e-2 for bfloat16 (the output is
rounded to bf16 on both sides).  Kernel B4 itself runs only on a card
(tests/test_torch_cuda.py)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _hypothesis_compat import given, settings, st

from repro.kernels.flash_attention import dense_attention_ref as j_dense
from repro.kernels.flash_attention import flash_attention as j_flash
from repro.kernels.flash_attention import flash_attention_ref as j_ref
from repro_torch.configs import get_config as tget
from repro_torch.kernels import flash_attention as tfa
from repro_torch.models import attention as tattn

torch.set_num_threads(2)

SWEEP = [
    # B, Sq, Sk, H, K, dh, causal, window, dtype (the reference's sweep)
    (2, 128, 128, 4, 2, 64, True, None, "float32"),
    (1, 96, 96, 8, 8, 32, True, 32, "float32"),
    (2, 64, 64, 6, 3, 48, False, None, "float32"),
    (1, 64, 64, 2, 1, 128, True, None, "bfloat16"),
    (3, 32, 32, 5, 5, 16, True, 16, "float32"),
    (1, 256, 256, 2, 2, 64, True, None, "float32"),
    # the head dims kernel B4 pads inside shared memory: every reduced
    # config's 32 and gemma3-12b's 256
    (2, 70, 70, 4, 2, 32, True, None, "bfloat16"),
    (1, 64, 64, 4, 2, 256, True, 16, "float32"),
]


def _mk(B, Sq, Sk, H, K, dh, dtype, seed=0):
    """The same numpy inputs as (jax, torch) triples, rounded to dtype."""
    r = np.random.default_rng(seed)
    arrs = [r.standard_normal(s).astype(np.float32)
            for s in ((B, Sq, H, dh), (B, Sk, K, dh), (B, Sk, K, dh))]
    j = tuple(jnp.asarray(a).astype(dtype) for a in arrs)
    t = tuple(torch.from_numpy(a).to(getattr(torch, dtype)) for a in arrs)
    return j, t


def _close(got: torch.Tensor, want, tol: float):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               atol=tol, rtol=tol)


def _tol(dtype: str) -> float:
    return 2e-2 if dtype == "bfloat16" else 2e-5


@pytest.mark.parametrize("case", SWEEP)
def test_plain_version_matches_pallas_interpret(case):
    B, Sq, Sk, H, K, dh, causal, window, dtype = case
    (jq, jk, jv), (q, k, v) = _mk(B, Sq, Sk, H, K, dh, dtype)
    want = j_flash(jq, jk, jv, causal=causal, window=window,
                   impl="interpret", block_q=32, block_k=32)
    got = tfa.flash_attention_ref(q, k, v, causal=causal, window=window)
    assert got.dtype == q.dtype and got.shape == q.shape
    _close(got, want, _tol(dtype))


@pytest.mark.parametrize("case", SWEEP)
def test_plain_version_matches_blocked_reference(case):
    """Same chunking (32 keys) on both sides, so the same online-softmax
    steps."""
    B, Sq, Sk, H, K, dh, causal, window, dtype = case
    (jq, jk, jv), (q, k, v) = _mk(B, Sq, Sk, H, K, dh, dtype)
    want = j_ref(jq, jk, jv, causal=causal, window=window, chunk_k=32)
    got = tfa.flash_attention_ref(q, k, v, causal=causal, window=window,
                                  chunk_k=32)
    _close(got, want, _tol(dtype))


@pytest.mark.parametrize("case", SWEEP)
def test_dense_oracle_matches_reference(case):
    B, Sq, Sk, H, K, dh, causal, window, dtype = case
    (jq, jk, jv), (q, k, v) = _mk(B, Sq, Sk, H, K, dh, dtype)
    want = j_dense(jq, jk, jv, causal=causal, window=window)
    got = tfa.dense_attention_ref(q, k, v, causal=causal, window=window)
    _close(got, want, _tol(dtype))


def test_unaligned_seq_padding():
    """70 tokens are no multiple of the 32-key blocks: the tail is masked."""
    (jq, jk, jv), (q, k, v) = _mk(1, 70, 70, 2, 2, 32, "float32")
    want = j_flash(jq, jk, jv, causal=True, impl="interpret", block_q=32,
                   block_k=32)
    _close(tfa.flash_attention_ref(q, k, v, causal=True, chunk_k=32), want,
           2e-5)
    _close(tfa.flash_attention(q, k, v, causal=True), want, 2e-5)


def test_query_offset_decode_semantics():
    """q_offset places queries mid-context (decode-style)."""
    (jq, jk, jv), (q, k, v) = _mk(1, 4, 64, 2, 2, 32, "float32")
    want = j_ref(jq, jk, jv, causal=True, q_offset=60)
    _close(tfa.flash_attention_ref(q, k, v, causal=True, q_offset=60), want,
           2e-5)
    _close(tfa.flash_attention_ref(q, k, v, causal=True,
                                   q_offset=torch.tensor(60)), want, 2e-5)


@pytest.mark.parametrize("is_global", [True, False])
def test_is_global_switch_matches_reference(is_global):
    """The per-layer window switch takes the plain path on the CPU."""
    (jq, jk, jv), (q, k, v) = _mk(1, 48, 48, 4, 2, 32, "float32", seed=1)
    want = j_ref(jq, jk, jv, causal=True, window=8,
                 is_global=jnp.asarray(is_global))
    got = tfa.flash_attention(q, k, v, causal=True, window=8,
                              is_global=torch.tensor(is_global))
    _close(got, want, 2e-5)


@settings(max_examples=20, deadline=None, database=None)
@given(B=st.integers(1, 2), Sq=st.integers(1, 80), extra=st.integers(0, 40),
       K=st.integers(1, 3), G=st.integers(1, 3),
       dh=st.sampled_from([16, 32, 64]), causal=st.booleans(),
       window=st.sampled_from([None, 1, 7, 33]),
       chunk=st.sampled_from([16, 64, 512]))
def test_blocked_equals_dense_for_any_shape(B, Sq, extra, K, G, dh, causal,
                                            window, chunk):
    """The blocked plain version agrees with the dense oracle for ragged
    lengths, GQA groups and windows — every row sees at least its own key
    (q_offset = Sk - Sq)."""
    Sk = Sq + extra
    _, (q, k, v) = _mk(B, Sq, Sk, K * G, K, dh, "float32", seed=Sq)
    kw = dict(causal=causal, window=window, q_offset=extra)
    got = tfa.flash_attention_ref(q, k, v, chunk_k=chunk, **kw)
    want = tfa.dense_attention_ref(q, k, v, **kw)
    torch.testing.assert_close(got, want, atol=2e-5, rtol=2e-5)


def test_cpu_dispatch_takes_the_plain_version():
    _, (q, k, v) = _mk(2, 33, 33, 4, 2, 64, "float32")
    before = tfa.launches.value
    got = tfa.flash_attention(q, k, v, causal=True, window=16)
    assert tfa.launches.value == before
    assert torch.equal(got, tfa.flash_attention_ref(q, k, v, causal=True,
                                                    window=16))
    assert torch.equal(tfa.flash_attention(q, k, v, impl="ref"),
                       tfa.flash_attention_ref(q, k, v))


@pytest.mark.parametrize("call,err", [
    (lambda q, k, v: tfa.flash_attention(q, k, v, impl="cuda"), ValueError),
    (lambda q, k, v: tfa.flash_attention_cuda(q, k, v), ValueError),
    (lambda q, k, v: tfa.flash_attention(q, k, v, impl="pallas"),
     ValueError),
], ids=["impl_cuda_on_cpu", "wrapper_on_cpu", "unknown_impl"])
def test_refusals_on_the_cpu(call, err):
    _, (q, k, v) = _mk(1, 8, 8, 2, 2, 64, "float32")
    with pytest.raises(err):
        call(q, k, v)


def test_single_device_attention_refuses_mesh_and_cross_attention():
    cfg = tget("qwen1.5-0.5b").reduced()
    _, (q, k, v) = _mk(1, 8, 8, cfg.n_heads, cfg.n_kv_heads, cfg.d_head,
                       "float32")
    with pytest.raises(NotImplementedError, match="A17"):
        tattn.sharded_flash_attention(q, k, v, mesh=object())
    x = torch.zeros(1, 8, cfg.d_model)
    with pytest.raises(NotImplementedError, match="A15"):
        tattn.attention_train({}, cfg, x, kv_x=x)


def test_attention_train_matches_reference():
    """One layer's full-sequence attention (projections, RoPE, flash
    attention, output projection) on the reference's weights."""
    from repro.configs import get_config
    from repro.models import attention as jattn
    from repro.models.registry import Model
    from repro_torch import bridge
    cfg = get_config("llama3.1-8b").reduced()
    params = Model(cfg).init(jax.random.PRNGKey(0))
    layer0 = jax.tree.map(lambda a: a[0], params["layers"]["attn"])
    tp = bridge.params_from_numpy(jax.tree.map(np.asarray, layer0), "cpu")
    x = np.random.default_rng(0).standard_normal(
        (2, 24, cfg.d_model)).astype(np.float32)
    want = jattn.attention_train(layer0, cfg, jnp.asarray(x))
    got = tattn.attention_train(tp, tget("llama3.1-8b").reduced(),
                                torch.from_numpy(x))
    _close(got, want, 2e-5)


# ---------------------------------------------------------------------------
# B4's host-side launch plan (`choose_flash_plan`): the cluster size S that
# splits each 64-row q tile's key range
# ---------------------------------------------------------------------------

from repro_torch.kernels.flash_attention import kernel as tfk  # noqa: E402


def _walk_tiles(Sq, Sk, causal, window, q_offset, block_k):
    """The longest q tile's walk, counted from the mask itself: the key
    tiles from the first to the last that hold a key some row of the q
    tile can see."""
    most = 0
    for q0 in range(0, Sq, tfk.BLOCK_Q):
        pos = q_offset + np.arange(q0, min(q0 + tfk.BLOCK_Q, Sq))[:, None]
        key = np.arange(Sk)[None, :]
        ok = np.ones((pos.shape[0], Sk), bool)
        if causal:
            ok &= key <= pos
        if window:
            ok &= key > pos - window
        seen = np.nonzero(ok.any(axis=0))[0]
        if seen.size:
            most = max(most, seen[-1] // block_k - seen[0] // block_k + 1)
    return most


PLAN_SHAPES = [
    # B, Sq, Sk, H, causal, window, q_offset, dh, dtype
    (1, 16, 16, 16, True, None, 0, 64, "float32"),
    (1, 64, 64, 16, True, None, 0, 64, "float32"),
    (1, 256, 256, 16, True, None, 0, 64, "float32"),
    (1, 511, 511, 16, True, None, 0, 64, "float32"),
    (1, 256, 256, 16, False, None, 0, 64, "bfloat16"),
    (1, 511, 511, 16, True, 64, 0, 64, "float32"),
    (1, 511, 511, 16, True, 16, 0, 64, "bfloat16"),
    (1, 70, 255, 4, True, None, 185, 32, "float32"),
    (1, 70, 255, 4, False, 16, 185, 112, "float32"),
    (1, 200, 900, 8, True, 100, 700, 160, "bfloat16"),
    (3, 70, 70, 4, True, None, 0, 256, "float32"),
    (1, 8192, 8192, 32, True, None, 0, 128, "float32"),
    (2, 1, 1, 4, True, None, 0, 64, "float32"),
]


@pytest.mark.parametrize("case", PLAN_SHAPES)
def test_flash_plan_key_tiles_follow_the_mask(case):
    """The walk the plan measures is the one the causal and window masks
    leave (a brute-force count over every (row, key) pair)."""
    B, Sq, Sk, H, causal, window, off, dh, dtype = case
    block_k = tfk.instance(dh, getattr(torch, dtype))[0]
    assert tfk.key_tiles(Sq, Sk, causal, window, off, block_k) == \
        _walk_tiles(Sq, Sk, causal, window, off, block_k)


@pytest.mark.parametrize("sms", [132, 114, 16])
@pytest.mark.parametrize("case", PLAN_SHAPES)
def test_flash_plan_never_splits_past_the_walk(case, sms):
    """S is in SPLITS, never more than the longest walk's key tiles (each
    rank keeps MIN_SPLIT_TILES), and the split grid fits the card."""
    B, Sq, Sk, H, causal, window, off, dh, dtype = case
    dt = getattr(torch, dtype)
    plan = tfk.choose_flash_plan(B, Sq, Sk, H, causal, window, sms,
                                 q_offset=off, dh=dh, dtype=dt)
    tiles = _walk_tiles(Sq, Sk, causal, window, off, plan.block_k)
    assert plan.split in tfk.SPLITS
    assert plan[1:4] == tfk.instance(dh, dt)
    assert plan.grid == (-(-Sq // 64) * plan.split, H, B)
    if plan.split > 1:
        assert tiles >= plan.split * tfk.MIN_SPLIT_TILES
        assert B * H * -(-Sq // 64) * plan.split <= sms * plan.ctas


@pytest.mark.parametrize("B,Sq,H,dh,dtype", [
    (1, 8192, 32, 128, "float32"), (1, 8192, 32, 128, "bfloat16"),
    (4, 512, 16, 64, "float32"), (8, 256, 16, 64, "bfloat16"),
    (2, 1024, 16, 64, "float32"), (1, 2048, 32, 256, "float32")])
def test_flash_plan_does_not_split_a_full_grid(B, Sq, H, dh, dtype):
    """Where B·H·q tiles already give every SM its CTAs, S = 1."""
    plan = tfk.choose_flash_plan(B, Sq, Sq, H, True, None, 132, dh=dh,
                                 dtype=getattr(torch, dtype))
    assert plan.split == 1


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("S", [256, 511])
def test_flash_plan_splits_short_buckets_at_b1(S, dtype):
    """A B=1 admit of qwen1.5-0.5b (16 heads x 64) at a short bucket has
    64 CTAs or fewer: the plan splits its key range."""
    plan = tfk.choose_flash_plan(1, S, S, 16, True, None, 132, dh=64,
                                 dtype=getattr(torch, dtype))
    assert plan.split > 1


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_plan_window_bounds_the_split(dtype):
    """A 16-token window leaves every q tile a walk of two key tiles, so
    a short prompt with room on the card splits at most in two; without
    the window the same prompt walks eight and splits further."""
    dt = getattr(torch, dtype)
    win = tfk.choose_flash_plan(1, 511, 511, 4, True, 16, 132, dh=64,
                                dtype=dt)
    full = tfk.choose_flash_plan(1, 511, 511, 4, True, None, 132, dh=64,
                                 dtype=dt)
    assert _walk_tiles(511, 511, True, 16, 0, win.block_k) == 2
    assert _walk_tiles(511, 511, True, None, 0, full.block_k) == 8
    assert win.split <= max(1, 2 // tfk.MIN_SPLIT_TILES) < full.split


@pytest.mark.parametrize("split", [1, 2, 4, 8])
def test_flash_plan_forced_split(split):
    plan = tfk.choose_flash_plan(1, 70, 70, 4, True, None, 132, dh=112,
                                 split=split)
    assert plan.split == split and plan.block_k == 32
    assert plan.grid == (2 * split, 4, 1)


@pytest.mark.parametrize("bad", [dict(split=3), dict(split=16),
                                 dict(dh=48), dict(dtype=torch.float16)])
def test_flash_plan_refusals(bad):
    kw = dict(dh=64, dtype=torch.float32) | bad
    with pytest.raises(ValueError):
        tfk.choose_flash_plan(1, 64, 64, 4, True, None, 132, **kw)


def test_flash_plan_instances_cover_every_head_dim():
    """Every head dim runs in the narrowest compiled width that holds it."""
    for dtype in (torch.float32, torch.bfloat16):
        for dh in tfk.HEAD_DIMS:
            width = 64 if dh <= 64 else 128 if dh <= 128 else 256
            assert tfk.instance(dh, dtype) == tfk.INSTANCES[(dtype, width)]
