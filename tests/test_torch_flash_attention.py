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
