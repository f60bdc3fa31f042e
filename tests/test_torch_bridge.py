"""PyTorch port: the weight bridge carries every reference leaf over bit
for bit — quantized `QuantizedWeight` leaves too — and the port's own
initializer builds the reference's tree."""
import collections

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.checkpoint import _flatten_with_paths
from repro.configs import get_config
from repro.core.quant import quantize_params
from repro.models.registry import Model
from repro_torch import bridge
from repro_torch.core.quant import QuantizedWeight
from repro_torch.models.registry import Model as TModel

torch.set_num_threads(2)

ARCHS = ["qwen1.5-0.5b", "llama3.1-8b"]


def _bits(t: torch.Tensor) -> np.ndarray:
    """The tensor's bytes (bf16 included, which numpy cannot hold)."""
    return t.detach().cpu().contiguous().view(torch.uint8).numpy()


@pytest.mark.parametrize("arch", ARCHS)
def test_every_leaf_round_trips_bit_exactly(arch):
    cfg = get_config(arch).reduced()
    params = Model(cfg).init(jax.random.PRNGKey(0))
    ref = _flatten_with_paths(params)
    tp = bridge.params_from_numpy(jax.tree.map(np.asarray, params), "cpu")
    assert all(isinstance(t, torch.Tensor) and t.device.type == "cpu"
               for t in bridge.flatten_with_paths(tp).values())
    port = bridge.flatten_with_paths(tp)
    assert sorted(port) == sorted(ref)
    for name, arr in ref.items():
        arr = np.asarray(arr)
        t = port[name]
        assert str(t.dtype).removeprefix("torch.") == arr.dtype.name, name
        assert tuple(t.shape) == arr.shape, name
        assert np.array_equal(_bits(t).reshape(-1),
                              arr.reshape(-1).view(np.uint8)), name


def test_bfloat16_leaves_carry_over_exactly():
    x = jax.random.normal(jax.random.PRNGKey(1), (7, 5)).astype(jnp.bfloat16)
    tp = bridge.params_from_numpy({"w": np.asarray(x)}, "cpu")
    assert tp["w"].dtype == torch.bfloat16
    assert np.array_equal(tp["w"].float().numpy(), np.asarray(x, np.float32))
    assert np.array_equal(_bits(tp["w"]).reshape(-1),
                          np.asarray(x).reshape(-1).view(np.uint8))


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("scheme", ["w4a16", "w8a8"])
def test_quantized_tree_round_trips_bit_exactly(arch, scheme):
    """A real `quantize_params` tree (stacked layers): every quantized leaf
    becomes the port's `QuantizedWeight` with the reference's codes,
    scales, scheme and shape; every float leaf carries over as before."""
    cfg = get_config(arch).reduced()
    qparams = quantize_params(Model(cfg).init(jax.random.PRNGKey(0)), scheme)
    ref = bridge.flatten_with_paths(jax.tree.map(np.asarray, qparams))
    port = bridge.flatten_with_paths(bridge.params_from_numpy(
        jax.tree.map(np.asarray, qparams), "cpu"))
    assert sorted(port) == sorted(ref)
    n_quant = 0
    for name, leaf in ref.items():
        t = port[name]
        if type(leaf).__name__ == "QuantizedWeight":
            n_quant += 1
            assert isinstance(t, QuantizedWeight), name
            assert (t.scheme, t.orig_shape) == (scheme, leaf.orig_shape)
            for got, want in ((t.q, leaf.q), (t.scale, leaf.scale)):
                want = np.asarray(want)
                assert str(got.dtype).removeprefix("torch.") == \
                    want.dtype.name, name
                assert np.array_equal(got.numpy(), want), name
        else:
            assert np.array_equal(_bits(t).reshape(-1),
                                  np.asarray(leaf).reshape(-1).view(np.uint8))
    assert n_quant == 7                    # wq wk wv wo gate up down


def test_namedtuple_leaves_are_refused():
    """The reference tree holds no NamedTuple leaf; one with a quantized
    leaf's fields is not taken for one."""
    QW = collections.namedtuple("QW", "q scale scheme orig_shape")
    tree = {"wq_w": QW(np.zeros((2, 2), np.int8), np.ones(2, np.float32),
                       "w8a8", (2, 2))}
    with pytest.raises(TypeError, match="NamedTuple"):
        bridge.params_from_numpy(tree, "cpu")


@pytest.mark.parametrize("arch", ARCHS)
def test_port_init_builds_the_reference_tree(arch):
    """Same leaf paths, shapes and dtypes; zero-init leaves are zero and
    fan-in normal leaves carry the reference's scale."""
    cfg = get_config(arch).reduced()
    ref = _flatten_with_paths(Model(cfg).init(jax.random.PRNGKey(0)))
    from repro_torch.configs import get_config as tget
    gen = torch.Generator().manual_seed(0)
    port = bridge.flatten_with_paths(TModel(tget(arch).reduced()).init(gen))
    assert sorted(port) == sorted(ref)
    for name, arr in ref.items():
        t = port[name]
        assert tuple(t.shape) == arr.shape, name
        assert t.dtype == torch.float32, name
        if not arr.any():
            assert not t.any(), name
        else:
            ratio = float(t.std()) / float(arr.std())
            assert 0.8 < ratio < 1.25, (name, ratio)
