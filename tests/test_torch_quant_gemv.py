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
    with pytest.raises(NotImplementedError, match="ROADMAP B"):
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


# ---------------------------------------------------------------------------
# B3's launch plan (`choose_gemv_plan`): decided on the host, so held here
# ---------------------------------------------------------------------------

PLAN_SHAPES = [(1, 1024, 2816), (4, 14336, 4096), (8, 130, 77),
               (15, 2560, 8960), (16, 8960, 2560), (17, 1024, 1024),
               (64, 1024, 2816), (64, 14336, 4096), (70, 130, 77),
               (200, 4096, 14336), (3, 2, 1), (64, 64, 1)]


@pytest.mark.parametrize("scheme", SCHEMES)
@pytest.mark.parametrize("M,D,F", PLAN_SHAPES)
def test_plan_grid_covers_every_row_and_column(scheme, M, D, F):
    plan = tqg.kernel.choose_gemv_plan(M, D, F, scheme, sms=132)
    gx, gy, gz = plan.grid
    cols = 32 * plan.warps
    assert (gx - 1) * cols < F <= gx * cols
    assert (gy - 1) * plan.rows < M <= gy * plan.rows
    assert gz == plan.splits


@pytest.mark.parametrize("scheme", SCHEMES)
@pytest.mark.parametrize("M,D,F", PLAN_SHAPES)
@pytest.mark.parametrize("sms", [1, 132])
def test_plan_splits_lie_between_one_and_the_chunks(scheme, M, D, F, sms):
    """Every split walks at least one ring stage of D, and the splits
    together walk all of them: the kernel's split c takes stages
    [c·per, min((c+1)·per, chunks)) with per = ceil(chunks / splits)."""
    plan = tqg.kernel.choose_gemv_plan(M, D, F, scheme, sms=sms)
    chunks = -(-D // plan.kc)
    per = -(-chunks // plan.splits)
    assert 1 <= plan.splits <= chunks
    assert (plan.splits - 1) * per < chunks <= plan.splits * per
    # the tile path's splits are one thread-block cluster
    assert plan.cluster == (plan.path == "tile")
    assert not plan.cluster or plan.splits <= tqg.kernel.MAX_CLUSTER


@pytest.mark.parametrize("scheme", SCHEMES)
def test_plan_path_follows_the_recorded_crossover(scheme):
    k = tqg.kernel
    for M in range(1, 3 * k.TILE_ROWS):
        plan = k.choose_gemv_plan(M, 4096, 4096, scheme)
        if M <= k.STREAM_MAX_M:
            assert plan.path == "stream"
            assert plan.rows == (8 if M <= 8 else 16)
            assert (plan.warps, plan.kc, plan.stages,
                    plan.ctas) == k.STREAM[scheme]
        else:
            assert plan.path == "tile" and plan.rows == k.TILE_ROWS
            assert (plan.warps, plan.kc, plan.stages,
                    plan.ctas) == k.TILE[scheme]
    for path in ("stream", "tile"):
        assert k.choose_gemv_plan(4, 4096, 4096, scheme,
                                  path=path).path == path
    with pytest.raises(ValueError, match="path"):
        k.choose_gemv_plan(4, 4096, 4096, scheme, path="wide")


def test_plan_instances_are_compiled():
    """Every instance a plan can name is one `csrc/quant_gemv.cu`
    compiles (the C entry point refuses any other)."""
    import pathlib
    import re
    k = tqg.kernel
    src = (pathlib.Path(k.__file__).resolve().parents[2] / "csrc"
           / "quant_gemv.cu").read_text()
    compiled = {tuple(int(v) for v in m) for m in re.findall(
        r"B3_INSTANCE\((\d), (\d+), (\d+), (\d+), (\d+), (\d+)\)", src)}
    assert len(compiled) == 6
    for code, scheme in enumerate(SCHEMES):
        for M, path in ((1, None), (9, None), (64, None), (4, "tile"),
                        (64, "stream")):
            p = k.choose_gemv_plan(M, 4096, 4096, scheme, path=path)
            assert (code, p.warps, p.rows, p.kc, p.stages, p.ctas) in compiled
