"""PyTorch port: the dry-run's model side on the CPU — the roofline
(`launch/roofline.py`) and the abstract trees the cells are built from —
held equal to the reference's, every arch.

  * `model_flops_estimate` for every arch in ASSIGNED_ARCHS × SHAPES.
  * The H100 constants, and `Roofline.finalize` / `analyze` /
    `memory_summary` on a known count (the even split of a mesh larger
    than one device, the null collective term, the 80 GB fit).
  * `param_specs` against the logical-axis tree of the reference's
    `init_model` (through `jax.eval_shape`, so nothing allocates), and
    the shapes and dtypes of `abstract_params` (meta tensors).
  * `abstract_cache` on both pool layouts at f32 / bf16 / kv8 / kv4
    (`.reduced()` configs), whisper's cross K/V included.
  * `input_specs` and `batch_sharding_axes` for every (arch, shape).
  * `quantize_params_and_specs`: the spec tree (QuantizedWeight(spec_q,
    spec_scale)) and the codes' and scales' shapes and dtypes on meta.
"""
import dataclasses

import jax
import jax.numpy as jnp
import pytest
import torch

from repro.configs import ASSIGNED_ARCHS, SHAPES
from repro.configs import get_config as jget
from repro.configs.base import EngineConfig as JEng
from repro.core.engine import KVNANDEngine as JEngine
from repro.core.quant import QuantizedWeight as JQW
from repro.launch import roofline as jrl
from repro.launch import steps as jsteps
from repro.models import registry as jreg
from repro.models import transformer as jtf
from repro_torch.configs import SHAPES as TSHAPES
from repro_torch.configs import get_config as tget
from repro_torch.configs.base import EngineConfig as TEng
from repro_torch.core.engine import KVNANDEngine as TEngine
from repro_torch.core.quant import QuantizedWeight as TQW
from repro_torch.core.quant import quantize_params_and_specs
from repro_torch.launch import op_cost
from repro_torch.launch import roofline as rl
from repro_torch.models import registry as treg
from repro_torch.models import transformer as ttf
from repro_torch.models.transformer import Runtime as TRuntime

DT = {jnp.dtype(jnp.float32): torch.float32,
      jnp.dtype(jnp.bfloat16): torch.bfloat16,
      jnp.dtype(jnp.int32): torch.int32, jnp.dtype(jnp.int8): torch.int8,
      jnp.dtype(jnp.uint8): torch.uint8}

_REF_PARAMS = {}


def _ref_params(arch):
    """The reference's (abstract params, specs) in bf16, once per arch."""
    if arch not in _REF_PARAMS:
        _REF_PARAMS[arch] = jtf.abstract_params(jget(arch), jnp.bfloat16)
    return _REF_PARAMS[arch]


def _same_leaf(got: torch.Tensor, want) -> bool:
    return (got.device.type == "meta" and tuple(got.shape) == want.shape
            and got.dtype == DT[jnp.dtype(want.dtype)])


def _assert_trees(got, want, path=""):
    """Port tree of meta tensors vs reference tree of ShapeDtypeStructs
    (dicts, None, QuantizedWeight)."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and sorted(got) == sorted(want), path
        for k in want:
            _assert_trees(got[k], want[k], f"{path}/{k}")
    elif want is None:
        assert got is None, path
    elif isinstance(want, JQW):
        assert isinstance(got, TQW), path
        assert got.scheme == want.scheme, path
        assert tuple(got.orig_shape) == tuple(want.orig_shape), path
        _assert_trees(got.q, want.q, path + ".q")
        _assert_trees(got.scale, want.scale, path + ".scale")
    else:
        assert _same_leaf(got, want), (path, tuple(got.shape), got.dtype,
                                       want)


def _assert_specs(got, want, path=""):
    if isinstance(want, dict):
        assert sorted(got) == sorted(want), path
        for k in want:
            _assert_specs(got[k], want[k], f"{path}/{k}")
    elif isinstance(want, JQW):
        assert isinstance(got, TQW), path
        assert (tuple(got.q), tuple(got.scale), got.scheme,
                tuple(got.orig_shape)) == (tuple(want.q), tuple(want.scale),
                                           want.scheme,
                                           tuple(want.orig_shape)), path
    else:
        assert tuple(got) == tuple(want), path


def test_h100_constants():
    assert (rl.PEAK_FLOPS, rl.HBM_BW, rl.LINK_BW, rl.HBM_BYTES) == (
        989e12, 3.35e12, 450e9, 80e9)
    assert [f.name for f in dataclasses.fields(rl.Roofline)] == [
        f.name for f in dataclasses.fields(jrl.Roofline)]


@pytest.mark.parametrize("arch", ASSIGNED_ARCHS)
def test_model_flops_estimate_matches_the_reference(arch):
    for name in SHAPES:
        assert (rl.model_flops_estimate(tget(arch), TSHAPES[name])
                == jrl.model_flops_estimate(jget(arch), SHAPES[name]))


def test_finalize_analyze_and_the_fit():
    cost = op_cost.CostSummary(flops=2 * 989e12, bytes_accessed=3.35e12,
                               fusible_bytes=3.35e12, peak_bytes=40e9,
                               output_bytes=1e9)
    one = rl.analyze(cost, 1, model_flops=989e12)
    assert (one.compute_s, one.memory_s, one.memory_raw_s,
            one.collective_s) == (2.0, 1.0, 2.0, 0.0)
    assert one.bottleneck == "compute" and one.eager_bound_s == 2.0
    assert one.useful_ratio == 0.5
    four = rl.analyze(cost, 4, model_flops=989e12, split=4)
    assert (four.compute_s, four.memory_s, four.collective_s) == (
        0.5, 0.25, None)
    assert four.eager_bound_s == 0.5 and four.useful_ratio == 0.5
    b = rl.function_bound(989e12, 2 * 3.35e12)
    assert (b.compute_s, b.memory_s, b.bound_s, b.bound_by) == (
        1.0, 2.0, 2.0, "bytes")
    b = rl.function_bound(4 * 989e12, 3.35e12, split=2)
    assert (b.flops, b.bound_s, b.bound_by) == (2 * 989e12, 2.0,
                                                "operations")
    mem = rl.memory_summary(cost, argument_bytes=30e9)
    assert mem["total_bytes"] == 70e9 and mem["fits"]
    mem = rl.memory_summary(cost, argument_bytes=30e9, temp_split=2)
    assert mem["temp_bytes"] == 20e9 and mem["total_bytes"] == 50e9
    assert not rl.memory_summary(cost, argument_bytes=41e9)["fits"]


@pytest.mark.parametrize("arch", ASSIGNED_ARCHS)
def test_param_specs_and_abstract_params_match_the_reference(arch):
    aparams, specs = _ref_params(arch)
    _assert_specs(ttf.param_specs(tget(arch)), specs)
    got, got_specs = treg.Model(tget(arch)).abstract_params(torch.bfloat16)
    _assert_specs(got_specs, specs)
    _assert_trees(got, aparams)


@pytest.mark.parametrize("scheme", ["w4a16", "w8a8"])
@pytest.mark.parametrize("arch", ASSIGNED_ARCHS)
def test_quantized_spec_tree_matches_the_reference(arch, scheme):
    want, want_specs = jsteps._abstract_quant(jget(arch), scheme)
    params, specs = ttf.abstract_params(tget(arch), torch.bfloat16)
    got, got_specs = quantize_params_and_specs(params, specs, scheme)
    _assert_specs(got_specs, want_specs)
    _assert_trees(got, want)


@pytest.mark.parametrize("arch", ASSIGNED_ARCHS)
def test_abstract_cache_matches_the_reference(arch):
    jcfg, tcfg = jget(arch).reduced(), tget(arch).reduced()
    enc = 64 if jcfg.is_encoder_decoder else 0
    for shared in (False, True):
        for kv in (dict(kv_dtype="float32"), dict(kv_dtype="bfloat16"),
                   dict(kv_quant="kv8"), dict(kv_quant="kv4")):
            kw = dict(page_tokens=16, shared_pool=shared, **kv)
            want = JEngine(jcfg, JEng(**kw), jsteps.runtime_for(jcfg),
                           None).abstract_cache(3, 100, enc_len=enc)
            got = TEngine(tcfg, TEng(**kw), TRuntime(),
                          device="meta").abstract_cache(3, 100, enc_len=enc)
            for f in dataclasses.fields(want):
                w, g = getattr(want, f.name), getattr(got, f.name)
                assert (w is None) == (g is None), (f.name, kw)
                if w is not None:
                    assert _same_leaf(g, w), (f.name, kw, g.shape, w)


@pytest.mark.parametrize("arch", ASSIGNED_ARCHS)
def test_input_specs_and_batch_axes_match_the_reference(arch):
    for name in SHAPES:
        want = jreg.input_specs(jget(arch), SHAPES[name],
                                jsteps.runtime_for(jget(arch)))
        got = treg.input_specs(tget(arch), TSHAPES[name])
        assert list(got) == list(want), name
        for k in want:
            assert _same_leaf(got[k], want[k]), (name, k)
        assert (treg.batch_sharding_axes(tget(arch), TSHAPES[name])
                == jreg.batch_sharding_axes(jget(arch), SHAPES[name]))


def test_concrete_batch_follows_the_specs():
    cfg = tget("qwen1.5-0.5b").reduced()
    specs = treg.input_specs(cfg, TSHAPES["train_4k"])
    specs = {k: torch.empty((2, 16), dtype=v.dtype, device="meta")
             for k, v in specs.items()}
    batch = treg.make_concrete_batch(cfg, specs)
    assert {k: (v.shape, v.dtype, v.device.type) for k, v in batch.items()} \
        == {k: (v.shape, v.dtype, "cpu") for k, v in specs.items()}
    assert 0 <= int(batch["tokens"].min()) <= int(batch["tokens"].max()) \
        < cfg.vocab_size
    # the CPU draws of one seed are the same draws again
    again = treg.make_concrete_batch(cfg, specs)
    assert all(torch.equal(batch[k], again[k]) for k in batch)
    assert jax.devices()[0].platform == "cpu"
