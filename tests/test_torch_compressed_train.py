"""PyTorch port: int8-compressed data parallelism
(`training/grad_compress.py`, `train_step.make_compressed_train_step`),
elastic checkpoint restores and the `ef` bridge, on reduced
qwen1.5-0.5b over meshes of eight CPU entries.

The reference's compressed step computes wrong attention gradients when
the mesh has a `model` axis > 1 (ROADMAP §C: the ring attention nested
in its manual (pod, data) shard_map, under `check_vma=False`; wq_w's
gradient 0.75 off relative on (pod 2, data 2, model 2), 7e-7 on
(2, 4, 1)).  So the port is held to the reference's compressed steps on
(pod 2, data 4, model 1), and on (pod 2, data 2, model 2), where its
ring runs, to its own exact step with the reference's bounds and closer.

The reference side runs once, in one subprocess with 8 fake host
devices (`tests/_mp.py`), on the inputs a module fixture writes; it
returns every output in one npz, each device's copy of the reference's
error-feedback residual read from its buffers (the reference returns the
residual as replicated while each pod's devices hold their own, ROADMAP
§C).

  * `compressed_cross_pod_psum` on two pods' gradients and residuals:
    the int8 codes equal the reference's (one step at a rounding tie),
    the mean gradient within 1e-6 of max |g|, and each pod's bfloat16
    residual within one bf16 rounding of the reference's plus the f32
    rounding of g - q·scale (a code step where the code landed on the
    other side of a tie).
  * On (2, 2, 2): one compressed step against the exact step with the
    reference's bounds (loss within 1e-3, max param gap / max |param| <
    0.05), and of the elements it moves, at least 90% of every leaf's
    move the exact step's way (AdamW's first step moves each weight by
    ~lr times the sign of its gradient; the int8 codes zero the smallest
    gradients, and the averaged per-pod scale can tip a near-even sum;
    measured 0.929 at worst, the reference's own step ~0.65 on wq_w).
  * On (2, 4, 1), against the reference: the exact and the compressed
    step's losses within 1e-4 and params within 2e-3 (two lr steps: a
    near-zero gradient element may step the other way); the updates'
    signs agree on 99.9% of every leaf's elements.
  * A second compressed step from each pod's own residual, against the
    reference's second step, with the same bounds; each pod's residual
    against the reference devices' own buffers (within 5e-3 of a code
    step, measured 3.5e-3, but for codes across a tie).
  * `bridge` carries the reference's residual (its host read, one
    device's copy) into a port state; the step then gives it to every
    pod, as the reference's restore replicates it: that second step
    equals the reference's from its restored state within the same
    bounds.
  * A state saved on 8 shards restores onto a 4-device mesh bit-equal
    (the reference's elastic case), the per-pod residual included.
"""
import jax
import numpy as np
import pytest
import torch

from tests._mp import run_multidevice
from repro.configs import get_config
from repro.models.registry import Model
from repro_torch import bridge
from repro_torch.checkpoint.checkpoint import (restore_checkpoint,
                                               save_checkpoint)
from repro_torch.configs import EngineConfig as TEngineConfig
from repro_torch.configs import get_config as tget
from repro_torch.distributed.sharding import (Mesh, NamedSharding, P,
                                              ShardedTensor, shard)
from repro_torch.launch.mesh import mesh_from_devices
from repro_torch.models.transformer import Runtime
from repro_torch.training.grad_compress import (compressed_cross_pod_psum,
                                                int8_codes)
from repro_torch.training.optimizer import AdamWConfig
from repro_torch.training.train_step import (init_train_state,
                                             make_compressed_train_step,
                                             make_train_step)

torch.set_num_threads(2)

MESH = Mesh(["cpu"] * 8, ("pod", "data", "model"), shape=(2, 2, 2))
# where the reference's compressed step is right: no model axis
FLAT = Mesh(["cpu"] * 8, ("pod", "data", "model"), shape=(2, 4, 1))
ACFG = dict(lr=1e-3, warmup_steps=0, total_steps=100, min_lr_ratio=1.0)
SHAPES = {"a": (64, 24), "b": (300,)}

REF = r"""
import sys
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import PartitionSpec as P
from repro.distributed.sharding import make_mesh_compat
from repro.configs import get_config, EngineConfig
from repro.models.registry import Model
from repro.models.transformer import Runtime
from repro.core.seqpar import shard_map
from repro.training.grad_compress import compressed_cross_pod_psum
from repro.training.optimizer import AdamWConfig
from repro.training.train_step import (
    TrainState, make_train_step, make_compressed_train_step,
    init_train_state)
x = dict(np.load(sys.argv[1]))
out = {}
# --- compressed_cross_pod_psum over 2 pods ----------------------------
pm = make_mesh_compat((2,), ("pod",), devices=jax.devices()[:2])
names = sorted(n[2:] for n in x if n.startswith("g_"))
def body(*a):
    g = {n: a[i][0] for i, n in enumerate(names)}
    e = {n: a[len(names) + i][0] for i, n in enumerate(names)}
    codes = {}
    for n in names:
        gf = g[n].astype(jnp.float32) + e[n].astype(jnp.float32)
        scale = jnp.maximum(jnp.max(jnp.abs(gf)), 1e-12) / 127.0
        codes[n] = jnp.clip(jnp.round(gf / scale), -127, 127)[None]
    mg, ne = compressed_cross_pod_psum(g, e, n_pods=2)
    return (tuple(mg[n] for n in names), tuple(ne[n][None] for n in names),
            tuple(codes[n] for n in names))
ins = [jnp.asarray(x["g_" + n]) for n in names] + [
    jnp.asarray(x["e_" + n]).astype(jnp.bfloat16) for n in names]
mg, ne, codes = jax.jit(shard_map(
    body, mesh=pm, in_specs=tuple(P("pod") for _ in ins),
    out_specs=(tuple(P() for _ in names), tuple(P("pod") for _ in names),
               tuple(P("pod") for _ in names)), check_vma=False))(*ins)
for i, n in enumerate(names):
    out["psum_g_" + n] = mg[i]
    out["psum_e_" + n] = ne[i].astype(jnp.float32)
    out["psum_q_" + n] = codes[i]
# --- train steps on (pod 2, data 2, model 2) ---------------------------
mesh = make_mesh_compat((2, 4, 1), ("pod", "data", "model"))
cfg = get_config("qwen1.5-0.5b").reduced()
rt = Runtime()
params = Model(cfg, rt).init(jax.random.PRNGKey(0))
acfg = AdamWConfig(**%(acfg)r)
b1 = {k: jnp.asarray(x["b1_" + k]) for k in ("tokens", "labels")}
b2 = {k: jnp.asarray(x["b2_" + k]) for k in ("tokens", "labels")}
def leaves(prefix, tree):
    for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]:
        out[prefix + jax.tree_util.keystr(p)] = np.asarray(v, np.float32)
with mesh:
    s1, m1 = jax.jit(make_train_step(cfg, rt, acfg, EngineConfig()))(
        init_train_state(params, acfg), b1)
    cstep = jax.jit(make_compressed_train_step(cfg, rt, acfg, EngineConfig(),
                                               mesh))
    sc1, mc1 = cstep(init_train_state(params, acfg, compressed=True), b1)
    leaves("s1", s1.params)
    leaves("sc1", sc1.params)
    # each device's residual: the pods' devices hold their own
    for p, v in jax.tree_util.tree_flatten_with_path(sc1.ef)[0]:
        bufs = {s.device.id: np.asarray(s.data, np.float32)
                for s in v.addressable_shards}
        k = jax.tree_util.keystr(p)
        ids = [d.id for d in mesh.devices.flat]
        out["ef_dev" + k] = np.stack([bufs[i] for i in ids])
        out["ef_host" + k] = np.asarray(v, np.float32)
    sc2, mc2 = cstep(sc1, b2)
    leaves("sc2", sc2.params)
    # a restore replicates the host read of the residual
    restored = TrainState(sc1.params, sc1.opt, jax.tree.map(
        lambda e: jnp.asarray(np.asarray(e)), sc1.ef))
    sr2, mr2 = cstep(restored, b2)
    leaves("sr2", sr2.params)
for k, v in (("m1", m1), ("mc1", mc1), ("mc2", mc2), ("mr2", mr2)):
    out["loss_" + k] = np.asarray(v["loss"])
np.savez(sys.argv[2], **out)
print("compressed reference OK")
""" % {"acfg": ACFG}


def _inputs():
    r = np.random.default_rng(0)
    x = {}
    for n, s in SHAPES.items():
        x["g_" + n] = r.standard_normal((2,) + s).astype(np.float32)
        x["g_" + n][1] *= 3.0                   # the pods' scales differ
        x["e_" + n] = (r.standard_normal((2,) + s) * 1e-2).astype(np.float32)
    cfg = get_config("qwen1.5-0.5b").reduced()
    for b in ("b1", "b2"):
        for k in ("tokens", "labels"):
            x[f"{b}_{k}"] = r.integers(0, cfg.vocab_size, (8, 32)).astype(
                np.int32)
    return x


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    d = tmp_path_factory.mktemp("ctrain")
    x = _inputs()
    # the residuals as bf16 values, which the reference casts them to
    for n in SHAPES:
        x["e_" + n] = torch.from_numpy(x["e_" + n]).bfloat16().float().numpy()
    np.savez(d / "in.npz", **x)
    code = ("import sys; sys.argv[1:] = [%r, %r]\n"
            % (str(d / "in.npz"), str(d / "out.npz"))) + REF
    run_multidevice(code, timeout=400)
    return x, dict(np.load(d / "out.npz"))


@pytest.fixture(scope="module")
def weights():
    cfg = get_config("qwen1.5-0.5b").reduced()
    params = jax.tree.map(np.asarray, Model(cfg).init(jax.random.PRNGKey(0)))
    return params


def _params(weights):
    return bridge.params_from_numpy(weights, "cpu")


def _flat(tree, prefix=""):
    """{"['a']['b']": array} in jax's keystr form, for the npz keys."""
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_flat(tree[k], f"{prefix}['{k}']"))
        return out
    return {prefix: (tree.assemble() if isinstance(tree, ShardedTensor)
                     else tree).float().numpy().copy()}


def _batch(x, b):
    return {k: torch.from_numpy(x[f"{b}_{k}"]).long()
            for k in ("tokens", "labels")}


def _gap(got, want):
    return max(float(np.abs(got[k] - want[k]).max()) for k in got)


def test_compressed_cross_pod_psum_matches_the_reference(data):
    x, ref = data
    grads, ef = {}, {}
    for n in SHAPES:
        grads[n] = ShardedTensor(MESH, P(), [
            torch.from_numpy(x["g_" + n][c["pod"]]) for c in MESH.coords()])
        ef[n] = ShardedTensor(MESH, P(), [
            torch.from_numpy(x["e_" + n][c["pod"]]).bfloat16()
            for c in MESH.coords()])
    mean, new_e = compressed_cross_pod_psum(grads, ef, n_pods=2)
    for n in SHAPES:
        g = x["g_" + n]
        for c, gm, ne in zip(MESH.coords(), mean[n].shards, new_e[n].shards):
            p = c["pod"]
            q, s, _ = int8_codes(torch.from_numpy(g[p]),
                                 torch.from_numpy(x["e_" + n][p]))
            dq = np.abs(q.numpy().astype(np.int32) - ref["psum_q_" + n][p])
            assert dq.max() <= 1 and (dq > 0).mean() < 1e-3
            np.testing.assert_allclose(gm.numpy(), ref["psum_g_" + n],
                                       atol=1e-6 * np.abs(g).max())
            want = ref["psum_e_" + n][p]
            d = np.abs(ne.float().numpy() - want)
            # a bf16 residual: one bf16 rounding apart, plus the f32
            # rounding of g - q * scale (XLA may fuse it, |g| <= 127 *
            # scale), or a code step apart where the code itself landed
            # on the other side of a tie
            assert (d <= np.where(dq > 0, float(s) * 1.0001,
                                  np.abs(want) * 2 ** -7
                                  + float(s) * 2 ** -16)).all()
        assert mean[n].dtype == torch.float32
        assert new_e[n].dtype == torch.bfloat16


def _port_steps(x, weights, mesh, ref=None):
    """The port's exact step and compressed step on `mesh` (batch b1);
    with `ref`, a second compressed step (b2) from each pod's residual
    and one from the reference's bridged residual."""
    cfg = tget("qwen1.5-0.5b").reduced()
    rt, eng = Runtime(), TEngineConfig()
    acfg = AdamWConfig(**ACFG)
    b1, b2 = _batch(x, "b1"), _batch(x, "b2")
    with mesh:
        s1, m1 = make_train_step(cfg, rt, acfg, eng)(
            init_train_state(_params(weights), acfg), b1)
    cstep = make_compressed_train_step(cfg, rt, acfg, eng, mesh)
    sc1, mc1 = cstep(init_train_state(_params(weights), acfg,
                                      compressed=True), b1)
    out = {"p0": _flat(_params(weights)), "s1": _flat(s1.params),
           "sc1": _flat(sc1.params), "ef": _flat(sc1.ef),
           "loss_m1": float(m1["loss"]), "loss_mc1": float(mc1["loss"])}
    if ref is None:
        return out
    # the bridged reference state: its host read of the residual
    host = {k[len("ef_host"):]: v for k, v in ref.items()
            if k.startswith("ef_host")}
    bridged = bridge.train_state_from_numpy(
        bridge.train_state_to_numpy(sc1)._replace(
            ef=_unflat(host, weights)), "cpu")
    sc2, mc2 = cstep(sc1, b2)
    out["sc2"], out["loss_mc2"] = _flat(sc2.params), float(mc2["loss"])
    sr2, mr2 = cstep(bridged, b2)
    out["sr2"], out["loss_mr2"] = _flat(sr2.params), float(mr2["loss"])
    out["bridged_ef"] = bridged.ef
    return out


def _unflat(flat, like):
    """A tree of `like`'s structure from keystr-keyed leaves (bf16)."""
    import ml_dtypes

    def build(node, prefix):
        if isinstance(node, dict):
            return {k: build(v, f"{prefix}['{k}']") for k, v in node.items()}
        return flat[prefix].astype(ml_dtypes.bfloat16)
    return build(like, "")


_RUNS = {}


def _run(data, weights, mesh):
    key = tuple(mesh.shape.values())
    if key not in _RUNS:
        x, ref = data
        _RUNS[key] = _port_steps(x, weights, mesh,
                                 ref if mesh is FLAT else None)
    return _RUNS[key]


def _sign_agreement(a, b, p0, moved=False):
    """The least share, over the leaves, of elements whose updates from
    p0 have the same sign (an unmoved element's sign is 0); with `moved`,
    of the elements `a` moved, the k bias left out (its gradient is
    float noise: the softmax cancels it)."""
    sgn = lambda d: np.sign(np.round(d * 1e3))             # noqa: E731
    out = []
    for k in a:
        sa, sb = sgn(a[k] - p0[k]), sgn(b[k] - p0[k])
        if moved:
            if "wk_b" in k:
                continue
            sa, sb = sa[sa != 0], sb[sa != 0]
        out.append(float((sa == sb).mean()))
    return min(out)


def test_one_compressed_step_tracks_the_exact_step_under_the_ring(
        data, weights):
    """(2, 2, 2): the attention runs the ring over `model` inside each
    (pod, data) coordinate's gradient."""
    out = _run(data, weights, MESH)
    assert abs(out["loss_m1"] - out["loss_mc1"]) < 1e-3
    scale = max(float(np.abs(v).max()) for v in out["s1"].values())
    assert _gap(out["sc1"], out["s1"]) / scale < 0.05
    assert _sign_agreement(out["sc1"], out["s1"], out["p0"],
                           moved=True) > 0.9


def test_the_steps_match_the_reference(data, weights):
    """(2, 4, 1): the exact and the compressed step against the
    reference's."""
    x, ref = data
    out = _run(data, weights, FLAT)
    assert abs(out["loss_m1"] - float(ref["loss_m1"])) < 1e-4
    assert abs(out["loss_mc1"] - float(ref["loss_mc1"])) < 1e-4
    for key in ("s1", "sc1"):
        want = {k: ref[key + k] for k in out[key]}
        assert _gap(out[key], want) < 2e-3
        assert _sign_agreement(out[key], want, out["p0"]) > 0.999
    assert abs(out["loss_m1"] - out["loss_mc1"]) < 1e-3


def test_each_pod_keeps_its_residual_as_the_reference_devices_do(data,
                                                                  weights):
    x, ref = data
    out = _run(data, weights, FLAT)
    pod_of = [c["pod"] for c in FLAT.coords()]
    for k, got in out["ef"].items():          # [2, ...]: pod 0, pod 1
        dev = ref["ef_dev" + k]                # [8, ...]: every device
        for i, p in enumerate(pod_of):
            # the gradients of the two packages differ in f32 rounding:
            # the residuals within 5e-3 of the code step (~2 max |e|),
            # but for a code that landed across a tie (one step)
            d = np.abs(got[p] - dev[i])
            step = 2 * np.abs(dev[i]).max()
            assert (d <= 5e-3 * step).mean() > 0.999, (k, i)
            assert d.max() <= 1.05 * step, (k, i)
        # the reference's devices of one pod agree; the pods do not
        assert np.array_equal(dev[0], dev[3]) and np.array_equal(dev[4],
                                                                 dev[7])
    assert any(not np.array_equal(v[0], v[1]) for v in out["ef"].values())


def test_a_second_step_from_each_pods_residual_matches_the_reference(
        data, weights):
    x, ref = data
    out = _run(data, weights, FLAT)
    assert abs(out["loss_mc2"] - float(ref["loss_mc2"])) < 1e-4
    want = {k: ref["sc2" + k] for k in out["sc2"]}
    assert _gap(out["sc2"], want) < 2e-3
    assert _sign_agreement(out["sc2"], want, out["p0"]) > 0.999


def test_bridge_carries_the_reference_residual_to_every_pod(data, weights):
    x, ref = data
    out = _run(data, weights, FLAT)
    for k, leaf in _flat(out["bridged_ef"]).items():
        np.testing.assert_array_equal(leaf, ref["ef_host" + k])
    assert abs(out["loss_mr2"] - float(ref["loss_mr2"])) < 1e-4
    want = {k: ref["sr2" + k] for k in out["sr2"]}
    assert _gap(out["sr2"], want) < 2e-3
    assert _sign_agreement(out["sr2"], want, out["p0"]) > 0.999


def test_elastic_restore_onto_a_smaller_mesh_is_bit_equal(tmp_path):
    mesh8 = mesh_from_devices(["cpu"] * 8)             # (4, 2)
    mesh4 = mesh_from_devices(["cpu"] * 4)             # (2, 2)
    assert mesh8.shape == {"data": 4, "model": 2}
    w = torch.arange(64.0).reshape(8, 8)
    ef = torch.randn(2, 8, 8).bfloat16()
    state = {"w": shard(w, mesh8, P("data", "model")),
             "ef": ShardedTensor(MESH, P("pod"), [
                 ef[c["pod"]:c["pod"] + 1].clone() for c in MESH.coords()]),
             "step": torch.tensor(3)}
    save_checkpoint(str(tmp_path), 0, state)
    sh4 = NamedSharding(mesh4, P("data", "model"))
    restored, _ = restore_checkpoint(str(tmp_path), 0, state,
                                     shardings={"w": sh4, "ef": None,
                                                "step": None})
    assert restored["w"].sharding == sh4 and len(restored["w"].shards) == 4
    assert torch.equal(restored["w"].assemble(), w)
    # the residual goes back onto its own mesh and pods, bit for bit
    assert restored["ef"].sharding == state["ef"].sharding
    assert torch.equal(restored["ef"].assemble(), ef)
    assert restored["ef"].dtype == torch.bfloat16
    assert int(restored["step"]) == 3
