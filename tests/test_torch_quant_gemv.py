"""PyTorch port: the plain quantized GEMV (kernel B3's CPU stand-in) and the
`quant_gemv` entry point against the JAX reference.

  * the plain version is bit-identical to `quant_gemv_ref` (the JAX
    package's CPU path) on the same numpy inputs, at M in {1, 4, 64}, for
    shapes of the reduced configs and a ragged one (D=130, F=77);
  * it agrees with the Pallas kernel `quant_gemv_pallas` in interpret mode
    (block 128 x 128): W8A8 within 1e-6 x max|y| (only the order of the
    float32 scale multiplies differs; measured 7.6e-8 at [4, 1024] @
    [1024, 2816]), W4A16 within 4e-3 x max|y| (the plain version rounds the
    product to bf16 as `quant_gemv_ref` does, the kernel accumulates in
    float32; measured 2.3e-3 to 2.7e-3 at M = 1 to 64 of that shape);
  * `quant_gemv` on CPU tensors takes the plain version and launches no
    kernel; an expert-batched (3-D) weight raises; `dense` and the QKV
    projections take quantized leaves as the reference's do."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config
from repro.core import quant as jq
from repro.kernels.quant_gemv.kernel import quant_gemv_pallas
from repro.kernels.quant_gemv.ref import quant_gemv_ref as jref
from repro.models import attention as jattn
from repro.models import layers as jlayers
from repro.models.registry import Model
from repro_torch import bridge
from repro_torch.configs import get_config as tget
from repro_torch.core import quant as tq
from repro_torch.kernels import quant_gemv as tqg
from repro_torch.models import attention as tattn
from repro_torch.models import layers as tlayers

torch.set_num_threads(2)

SCHEMES = ("w4a16", "w8a8")
TOL_PALLAS = {"w4a16": 4e-3, "w8a8": 1e-6}


def _weights(D, F, scheme, seed=0):
    r = np.random.default_rng(seed)
    w = (r.standard_normal((D, F)) / np.sqrt(D)).astype(np.float32)
    jw = jq.quantize_weight(jnp.asarray(w), scheme)
    return jw, tq.quantize_weight(torch.from_numpy(w), scheme)


def _x(M, D, seed=1):
    return np.random.default_rng(seed).standard_normal((M, D)).astype(
        np.float32)


@pytest.mark.parametrize("scheme", SCHEMES)
@pytest.mark.parametrize("M", [1, 4, 64])
@pytest.mark.parametrize("D,F", [(128, 256), (256, 128), (130, 77)])
def test_plain_version_bit_identical_to_reference(scheme, M, D, F):
    jw, tw = _weights(D, F, scheme)
    x = _x(M, D)
    want = np.asarray(jref(jnp.asarray(x), jw.q, jw.scale, scheme))
    got = tqg.quant_gemv_ref(torch.from_numpy(x), tw.q, tw.scale, scheme)
    assert got.dtype == torch.float32
    assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("scheme", SCHEMES)
@pytest.mark.parametrize("M", [1, 4, 64])
def test_plain_version_agrees_with_pallas_kernel(scheme, M):
    D, F = 256, 384
    jw, tw = _weights(D, F, scheme, seed=2)
    x = _x(M, D, seed=3)
    if scheme == "w8a8":
        xq, xs = jq.quantize_activations_int8(jnp.asarray(x))
        want = quant_gemv_pallas(xq, jw.q, jw.scale, scheme, block_d=128,
                                 block_f=128, interpret=True) * xs
    else:
        want = quant_gemv_pallas(jnp.asarray(x).astype(jnp.bfloat16), jw.q,
                                 jw.scale, scheme, block_d=128, block_f=128,
                                 interpret=True)
    want = np.asarray(want)
    got = tqg.quant_gemv_ref(torch.from_numpy(x), tw.q, tw.scale,
                             scheme).numpy()
    rel = np.abs(got - want).max() / np.abs(want).max()
    assert rel <= TOL_PALLAS[scheme], rel


@pytest.mark.parametrize("scheme", SCHEMES)
def test_entry_point_on_cpu_takes_the_plain_version(scheme):
    D, F = 128, 96
    _, tw = _weights(D, F, scheme)
    x = torch.from_numpy(_x(6, D)).reshape(2, 3, D)
    tqg.launches.reset()
    got = tqg.quant_gemv(x, tw)
    assert tqg.launches.value == 0
    want = tqg.quant_gemv_ref(x.reshape(6, D), tw.q, tw.scale, scheme)
    assert got.shape == (2, 3, F)
    assert torch.equal(got.reshape(6, F), want)
    assert torch.equal(tqg.quant_gemv(x, tw, impl="ref"), got)
    with pytest.raises(ValueError, match="CUDA"):
        tqg.quant_gemv(x, tw, impl="cuda")


def test_expert_batched_weight_raises():
    w = torch.randn(2, 64, 32, generator=torch.Generator().manual_seed(0))
    qw = tq.quantize_weight(w, "w8a8")
    with pytest.raises(NotImplementedError, match="A15"):
        tqg.quant_gemv(torch.randn(4, 64), qw)


@pytest.mark.parametrize("scheme", SCHEMES)
def test_dense_and_qkv_projections_take_quantized_leaves(scheme):
    """Layer 0 of a quantized reduced qwen1.5-0.5b: `dense` (wo, the MLP)
    bit-identical to the reference's on the same input; the QKV
    projections (dequantize, then einsum) within float32 rounding."""
    cfg = get_config("qwen1.5-0.5b").reduced()
    params = jq.quantize_params(Model(cfg).init(jax.random.PRNGKey(0)),
                                scheme)
    tparams = bridge.params_from_numpy(jax.tree.map(np.asarray, params),
                                       "cpu")
    tcfg = tget("qwen1.5-0.5b").reduced()
    jl = jax.tree.map(lambda a: a[0], params["layers"])
    tl = tlayers.layer_slice(tparams["layers"], 0)
    r = np.random.default_rng(4)
    h = r.standard_normal((2, 5, cfg.d_model)).astype(np.float32)
    for name in ("gate", "up"):
        want = np.asarray(jlayers.dense(jl["mlp"], name, jnp.asarray(h)))
        got = tlayers.dense(tl["mlp"], name, torch.from_numpy(h))
        assert np.array_equal(got.numpy(), want), name
    a = r.standard_normal((2, 5, cfg.n_heads, cfg.d_head)).astype(np.float32)
    want = np.asarray(jattn.project_out(jl["attn"], cfg, jnp.asarray(a)))
    got = tattn.project_out(tl["attn"], tcfg,
                            torch.from_numpy(a))
    assert np.array_equal(got.numpy(), want)
    pos = np.arange(5)[None].repeat(2, 0)
    want = jattn.project_qkv(jl["attn"], cfg, jnp.asarray(h),
                             jnp.asarray(pos))
    got = tattn.project_qkv(tl["attn"], tcfg,
                            torch.from_numpy(h), torch.from_numpy(pos))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5,
                                   rtol=1e-5)
