"""PyTorch port: the logical-axis rules and the single-process mesh
(`distributed/sharding.py`, `launch/mesh.py`) on the CPU.

  * The six cases of `tests/test_sharding.py` on the port, each held to
    the reference's own function on the same arguments (specs, the
    one-use rule for mesh axes, the divisibility fallback, FSDP,
    multi-pod batch axes, a quantized leaf's shardings).
  * `mesh_from_devices` factors 1, 2, 4, 8 and 6 devices as the
    reference's does (its mesh over repeated copies of the one CPU
    device).
  * Shard-local storage: `shard` and `assemble` round-trip bit for bit
    over specs that split, repeat and combine axes; every coordinate's
    tensor is its own storage; `zeros` builds shards alone.
  * The collectives against numpy: `psum` / `pmax` / `pmean` over one
    axis and two, `ppermute` around a ring (zeros where nothing lands),
    and `axis_index` inside `map_shards` bodies and `manual_axes`.
"""
import jax
import numpy as np
import pytest
import torch

from repro.distributed import sharding as jshd
from repro.launch import mesh as jmesh
from repro_torch.distributed import sharding as shd
from repro_torch.distributed.sharding import P
from repro_torch.launch import mesh as tmesh


class FakeMesh:
    def __init__(self, shape):
        self.shape = shape


def _same(port_spec, ref_spec):
    return tuple(port_spec) == tuple(ref_spec)


@pytest.mark.parametrize("axes", [("embed", "mlp"), ("vocab", "embed"),
                                  (None, "heads"), ("mlp", "heads"),
                                  ("batch", "act_seq", "act_heads")],
                         ids=lambda a: "-".join(map(str, a)))
def test_logical_to_spec_matches_the_reference(axes):
    """Includes the one-use rule: ("mlp", "heads") both map to model."""
    got = shd.logical_to_spec(axes, shd.make_rules())
    assert _same(got, jshd.logical_to_spec(axes, jshd.make_rules()))
    if axes == ("mlp", "heads"):
        assert tuple(got) == ("model", None)


@pytest.mark.parametrize("shape,axes,fsdp", [
    ((51865, 512), ("vocab", "embed"), False),     # whisper vocab: whole
    ((51968, 512), ("vocab", "embed"), False),
    ((4096, 14336), ("embed", "mlp"), True),       # FSDP: embed over data
    ((4096, 14336), ("embed", "mlp"), False),
])
def test_spec_for_shape_divisibility_and_fsdp(shape, axes, fsdp):
    mesh = FakeMesh({"data": 16, "model": 16})
    got = shd.spec_for_shape(shape, axes, shd.make_rules(fsdp=fsdp), mesh)
    want = jshd.spec_for_shape(shape, axes, jshd.make_rules(fsdp=fsdp),
                               mesh)
    assert _same(got, want)
    assert tuple(shd.spec_for_shape((51865, 512), ("vocab", "embed"),
                                    shd.make_rules(), mesh)) == (None, None)


def test_multipod_batch_axes_and_rule_sets():
    rules = shd.make_rules(multi_pod=True, overrides={"kv_pages": None})
    want = jshd.make_rules(multi_pod=True, overrides={"kv_pages": None})
    assert rules == want
    assert shd.logical_to_spec(("batch", None), rules)[0] == ("pod", "data")
    assert shd.BASE_RULES == jshd.BASE_RULES
    assert shd.FSDP_RULES == jshd.FSDP_RULES


def test_quantized_weight_shardings():
    """A quantized leaf expands into q and scale shardings, each the
    reference's spec on a mesh where both divide."""
    from repro.core.quant import QuantizedWeight as JQW, quantize_weight
    from repro_torch.core.quant import QuantizedWeight, quantize_weight as tq
    rules = shd.make_rules()
    w = np.ones((64, 32), np.float32)
    qw = tq(torch.from_numpy(w), "w4a16")
    mesh = shd.Mesh(["cpu"] * 8, ("data", "model"), shape=(2, 4))
    specs = QuantizedWeight(("embed", "mlp"), ("mlp",), "w4a16", (64, 32))
    sh = shd.tree_shardings({"x_w": qw}, {"x_w": specs}, rules, mesh)
    assert isinstance(sh["x_w"], QuantizedWeight)
    assert sh["x_w"].q.mesh is mesh
    jm = jshd.make_mesh_compat((1, 1), ("data", "model"),
                               devices=jax.devices()[:1])
    jsh = jshd.tree_shardings(
        {"x_w": quantize_weight(jax.numpy.asarray(w), "w4a16")},
        {"x_w": JQW(("embed", "mlp"), ("mlp",), "w4a16", (64, 32))},
        jshd.make_rules(), jm)
    for leaf in ("q", "scale"):
        got = getattr(sh["x_w"], leaf).spec
        want = shd.spec_for_shape(getattr(qw, leaf).shape,
                                  getattr(specs, leaf), rules, mesh)
        assert got == want
        # on the reference's 1 x 1 mesh every dim divides: the bare rule
        assert _same(shd.logical_to_spec(getattr(specs, leaf), rules),
                     getattr(jsh["x_w"], leaf).spec)
    # the divisible q [32, 32] splits its columns over model
    assert tuple(sh["x_w"].q.spec) == (None, "model")
    assert tuple(shd.constrain(torch.ones(2), ("embed",), rules).shape) == (2,)


@pytest.mark.parametrize("n", [1, 2, 4, 8, 6])
def test_mesh_from_devices_factors_as_the_reference(n):
    got = tmesh.mesh_from_devices(["cpu"] * n)
    want = jmesh.mesh_from_devices([jax.devices()[0]] * n)
    assert got.shape == dict(want.shape)
    assert got.size == n and got.axis_names == ("data", "model")
    assert tmesh.mesh_axis_size(got, "model") == want.shape["model"]
    assert tmesh.mesh_axis_size(None, "model") == 1


def test_production_mesh_and_make_mesh_compat():
    m = tmesh.make_production_mesh(multi_pod=True, devices=["cpu"] * 512)
    assert m.shape == {"pod": 2, "data": 16, "model": 16}
    with pytest.raises(ValueError, match="needs 8 devices"):
        shd.make_mesh_compat((2, 4), ("data", "model"), ["cpu"] * 6)
    with pytest.raises(ValueError, match="no devices"):
        tmesh.mesh_from_devices([])
    assert shd.get_current_mesh() is None
    with m:
        assert shd.get_current_mesh() is m
        with tmesh.mesh_from_devices(["cpu"]) as inner:
            assert shd.get_current_mesh() is inner
        assert shd.get_current_mesh() is m
    assert shd.get_current_mesh() is None


MESH = shd.Mesh(["cpu"] * 8, ("pod", "data", "model"), shape=(2, 2, 2))


@pytest.mark.parametrize("spec", [P(), P("model"), P(None, "data"),
                                  P(("pod", "data"), "model"),
                                  P("model", ("data", "pod"), None)],
                         ids=str)
def test_shard_assemble_roundtrip_private_storage(spec):
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (8, 4, 3)).astype(np.float32))
    st = shd.shard(x, MESH, spec)
    assert torch.equal(st.assemble(), x) and st.shape == (8, 4, 3)
    ptrs = {t.data_ptr() for t in st.shards}
    assert len(ptrs) == 8 and x.data_ptr() not in ptrs
    st.shards[0].add_(1.0)                       # touches no other shard
    assert sum(not torch.equal(a, b) for a, b in zip(
        st.shards, shd.shard(x, MESH, spec).shards)) == 1
    z = shd.zeros(MESH, spec, (8, 4, 3), torch.int8)
    assert z.shape == (8, 4, 3) and z.dtype == torch.int8
    assert z.shards[0].shape == st.shards[0].shape


def test_collectives_against_numpy():
    rng = np.random.default_rng(1)
    vals = rng.standard_normal((8, 3, 5)).astype(np.float32)  # per coord
    x = shd.ShardedTensor(MESH, P(), [torch.from_numpy(v) for v in vals])
    v = vals.reshape(2, 2, 2, 3, 5)                            # pod data model
    for axes, red in ((("model",), (2,)), (("pod", "data"), (0, 1)),
                      (("pod",), (0,))):
        for op, fn in ((shd.psum, np.sum), (shd.pmax, np.max),
                       (shd.pmean, np.mean)):
            want = np.broadcast_to(fn(v, axis=red, keepdims=True), v.shape)
            got = np.stack([t.numpy() for t in op(x, axes).shards])
            np.testing.assert_allclose(got, want.reshape(8, 3, 5),
                                       rtol=1e-6, atol=1e-6)
    q = shd.ShardedTensor(MESH, P(), [torch.full((2,), i, dtype=torch.int8)
                                      for i in range(100, 108)])
    s = shd.psum(q, "model", dtype=torch.int32)
    assert s.dtype == torch.int32 and int(s.shards[0][0]) == 201
    ring = shd.ppermute(x, "model", [(0, 1), (1, 0)])
    got = np.stack([t.numpy() for t in ring.shards]).reshape(v.shape)
    np.testing.assert_array_equal(got, v[:, :, ::-1])
    half = shd.ppermute(x, "pod", [(0, 1)])
    got = np.stack([t.numpy() for t in half.shards]).reshape(v.shape)
    np.testing.assert_array_equal(got[1], v[0])
    assert not got[0].any()


def test_axis_index_in_bodies_and_manual_axes():
    def body(t):
        return t + 100 * shd.axis_index("pod") + 10 * shd.axis_index(
            "data") + shd.axis_index("model")
    out = shd.map_shards(body, shd.zeros(MESH, P(), (1,), torch.int64))
    assert [int(t) for t in out.shards] == [0, 1, 10, 11, 100, 101, 110, 111]
    with shd.manual_axes(pod=1, data=0):
        sub = shd.effective_mesh(MESH)
        assert sub.shape == {"model": 2}
        assert shd.axis_index("pod") == 1
        out = shd.map_shards(lambda t: t + shd.axis_index("model"),
                             shd.zeros(sub, P(), (1,), torch.int64))
        assert [int(t) for t in out.shards] == [0, 1]
    assert shd.current_manual() == {}
    with pytest.raises(KeyError):
        shd.axis_index("model")


def test_the_ambient_mesh_is_seen_from_other_threads():
    """A card's autograd backward runs on threads of its own, and a
    rematerialized layer recomputed there must take the same attention
    path (the ring) as its forward: the ambient mesh and the fixed axes
    are process-wide."""
    import threading
    seen = []
    with MESH, shd.manual_axes(pod=1):
        t = threading.Thread(target=lambda: seen.append(
            (shd.get_current_mesh(), shd.current_manual())))
        t.start()
        t.join(timeout=30)
    assert not t.is_alive()
    assert seen == [(MESH, {"pod": 1})]
    assert shd.get_current_mesh() is None and shd.current_manual() == {}
