"""PyTorch port: `KVNANDEngine(mesh=...)` on a (data 2, model 4) mesh of
eight CPU entries against the reference engine on one device, in
process, on reduced qwen2.5-32b (GQA, 40 heads over 8 kv heads reduced
to 4 over 2) with the reference's weights.

  * `prefill` (ring attention, sharded fills) and three `decode_step`s
    (owning-shard appends, per-shard partials, the combine) at f32, kv8
    and kv4, compact and discrete: greedy tokens identical every step;
    logits (max |d| / max |ref|) within 1e-5 of the reference at f32
    (summation order and the two libraries' matmul rounding; measured
    9.3e-07; the reference holds its own mesh run to 5e-4) and within
    the reference's kv8 mesh bound, 5e-3, at kv8 / kv4 (a code on the
    other side of a rounding tie would move a logit by a code step;
    measured 7.8e-07 / 8.6e-07).  The same run without a mesh in the
    port differs from the mesh run by summation order only: 1e-5.
  * `prefill_chunk` on the stripe (sharded chunk fills and the past
    partial from the shards that hold the slot's row), then a masked
    decode step, f32 and kv8.
  * The shared pool: decode from an empty cache with an active mask
    (owning-shard appends through each shard's rows, the table walked
    per shard), against the reference single device.
  * gemma3-12b (window rings on the mesh: ring attention with a window,
    the window fill, ring appends and attention), f32.
  * The reference's mesh refusals raise at the same call with the same
    exception type in both packages (the reference on a mesh of eight
    copies of its one CPU device, which its refusals never run past).
  * After a decode each shard's pool is still its own tensor on its own
    device, and the page counts are rounded to the page shards.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JMesh

from repro.configs import EngineConfig, get_config
from repro.core.engine import KVNANDEngine
from repro.models.registry import Model
from repro_torch import bridge
from repro_torch.configs import EngineConfig as TEngineConfig
from repro_torch.configs import get_config as tget
from repro_torch.core.engine import KVNANDEngine as TEngine
from repro_torch.distributed.sharding import Mesh, ShardedTensor

torch.set_num_threads(2)

MESH = Mesh(["cpu"] * 8, ("data", "model"), shape=(2, 4))
ARCH = "qwen2.5-32b"
B, S, CTX, STEPS = 4, 16, 28, 3
_W = {}
# the bound on a logit gap, relative to max |logit| (see the docstring)
QUANT_TOL = {"none": 1e-5, "kv8": 5e-3, "kv4": 5e-3}


def _weights(arch):
    if arch not in _W:
        cfg = get_config(arch).reduced()
        params = Model(cfg).init(jax.random.PRNGKey(0))
        _W[arch] = (cfg, params, bridge.params_from_numpy(
            jax.tree.map(np.asarray, params), "cpu"))
    return _W[arch]


def _toks(cfg, shape, seed=1):
    return np.random.default_rng(seed).integers(1, cfg.vocab_size, shape)


def _rel(a, b):
    return float(np.abs(a - b).max() / np.abs(b).max())


def _run_port(arch, eng, mesh, toks):
    cfg, _, tp = _weights(arch)
    e = TEngine(tget(arch).reduced(), TEngineConfig(**eng), mesh=mesh,
                device="cpu")
    lg, c = e.prefill(tp, {"tokens": torch.from_numpy(toks[:, :S])}, CTX)
    out = [lg.numpy()]
    for i in range(STEPS):
        lg, c = e.decode_step(tp, c,
                              torch.from_numpy(toks[:, S + i:S + i + 1]))
        out.append(lg.numpy())
    return np.stack(out), c


def _run_ref(arch, eng, toks):
    cfg, params, _ = _weights(arch)
    e = KVNANDEngine(cfg, EngineConfig(**eng))
    lg, c = e.prefill(params, {"tokens": jnp.asarray(toks[:, :S], jnp.int32)},
                      CTX)
    out = [np.asarray(lg)]
    step = jax.jit(e.decode_step)
    for i in range(STEPS):
        lg, c = step(params, c, jnp.asarray(toks[:, S + i:S + i + 1],
                                            jnp.int32))
        out.append(np.asarray(lg))
    return np.stack(out)


@pytest.mark.parametrize("variant", ["compact", "discrete"])
@pytest.mark.parametrize("fmt", ["none", "kv8", "kv4"])
def test_mesh_prefill_and_decode_match_the_reference(fmt, variant):
    cfg = _weights(ARCH)[0]
    toks = _toks(cfg, (B, S + STEPS))
    eng = dict(page_tokens=4, kv_dtype="float32", kv_quant=fmt,
               variant=variant)
    want = _run_ref(ARCH, eng, toks)
    got, cache = _run_port(ARCH, eng, MESH, toks)
    solo, _ = _run_port(ARCH, eng, None, toks)
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))
    assert _rel(got, want) < QUANT_TOL[fmt], _rel(got, want)
    assert _rel(got, solo) < 1e-5, _rel(got, solo)
    pool = cache.k_pages_g
    assert isinstance(pool, ShardedTensor) and pool.mesh is MESH
    # NP = ceil(28 / 4) = 7 pages, rounded up to the 4 page shards
    assert pool.shape[3] == 8 and pool.shards[0].shape[1:4] == (2, 2, 2)
    assert len({t.data_ptr() for t in pool.shards}) == 8
    assert all(t.device.type == "cpu" and t.is_contiguous()
               for t in pool.shards)
    assert cache.lengths.tolist() == [S + STEPS] * B


@pytest.mark.parametrize("fmt", ["none", "kv8"])
def test_mesh_prefill_chunk_on_the_stripe_matches_the_reference(fmt):
    """Two chunks of slot 2's 24-token prompt (16 + 8, 16-token bucket),
    then one decode step with only slot 2 active."""
    cfg, params, tp = _weights(ARCH)
    toks = _toks(cfg, (1, 32))
    eng = dict(page_tokens=4, kv_dtype="float32", uniform_lengths=False,
               kv_quant=fmt)
    n, C = 24, 16
    active = np.array([False, False, True, False])
    je = KVNANDEngine(cfg, EngineConfig(**eng))
    jc = je.init_cache(B, 32)
    outs = []
    for c0 in range(0, 32, C):
        lg, jc = je.prefill_chunk(
            params, jc, {"tokens": jnp.asarray(toks[:, c0:c0 + C], jnp.int32)},
            jnp.asarray(2), jnp.asarray(c0), jnp.asarray(min(C, n - c0)),
            first=c0 == 0)
    outs.append(np.asarray(lg))
    lg, jc = je.decode_step(params, jc, jnp.full((B, 1), 5, jnp.int32),
                            active=jnp.asarray(active))
    outs.append(np.asarray(lg)[2:3])
    for mesh in (MESH, None):
        te = TEngine(tget(ARCH).reduced(), TEngineConfig(**eng), mesh=mesh,
                     device="cpu")
        tc = te.init_cache(B, 32)
        got = []
        for c0 in range(0, 32, C):
            lg, tc = te.prefill_chunk(
                tp, tc, {"tokens": torch.from_numpy(toks[:, c0:c0 + C])}, 2,
                c0, min(C, n - c0), first=c0 == 0)
        got.append(lg.numpy())
        lg, tc = te.decode_step(tp, tc, torch.full((B, 1), 5),
                                active=torch.from_numpy(active))
        got.append(lg.numpy()[2:3])
        for g, w in zip(got, outs):
            assert _rel(g, w) < QUANT_TOL[fmt] and (
                g.argmax(-1) == w.argmax(-1)).all()
        if mesh is not None:
            mesh_out = got
            assert tc.lengths.tolist() == [0, 0, n + 1, 0]
    for g, w in zip(mesh_out, got):
        assert _rel(g, w) < 1e-5


@pytest.mark.parametrize("fmt", ["none", "kv8"])
def test_mesh_shared_pool_decode_matches_the_reference(fmt):
    cfg, params, tp = _weights(ARCH)
    toks = _toks(cfg, (B, 10), seed=3)
    eng = dict(page_tokens=4, kv_dtype="float32", uniform_lengths=False,
               kv_quant=fmt, shared_pool=True)
    act = [np.array([True, True, i % 2 == 0, True]) for i in range(10)]
    je = KVNANDEngine(cfg, EngineConfig(**eng))
    jc = je.init_cache(B, 32)
    # a permuted table: every row's pages spread over the page shards
    perm = np.random.default_rng(5).permutation(B * 8).reshape(B, 8)
    jc = jc.__class__(**{**jc.__dict__,
                         "page_table_g": jnp.asarray(perm, jnp.int32)})
    want = []
    step = jax.jit(je.decode_step)
    for i in range(10):
        lg, jc = step(params, jc, jnp.asarray(toks[:, i:i + 1], jnp.int32),
                      jnp.asarray(act[i]))
        want.append(np.asarray(lg))
    te = TEngine(tget(ARCH).reduced(), TEngineConfig(**eng), mesh=MESH,
                 device="cpu")
    tc = te.init_cache(B, 32)
    tc.page_table_g.copy_(torch.from_numpy(perm))
    for i in range(10):
        lg, tc = te.decode_step(tp, tc, torch.from_numpy(toks[:, i:i + 1]),
                                active=torch.from_numpy(act[i]))
        assert _rel(lg.numpy(), want[i]) < QUANT_TOL[fmt]
        assert (lg.numpy().argmax(-1) == want[i].argmax(-1)).all()
    assert tc.k_pages_g.spec[2] == "model"
    assert tc.lengths.tolist() == np.asarray(jc.lengths).tolist()


def test_mesh_window_rings_match_the_reference():
    """gemma3-12b reduced: 80-token prompts over 16-token pages, window
    64 (a ring of 5 pages, 8 on the mesh), then three steps."""
    arch = "gemma3-12b"
    cfg, params, tp = _weights(arch)
    toks = _toks(cfg, (B, 83))
    eng = dict(page_tokens=16, kv_dtype="float32")
    je = KVNANDEngine(cfg, EngineConfig(**eng))
    te = TEngine(tget(arch).reduced(), TEngineConfig(**eng), mesh=MESH,
                 device="cpu")
    jl, jc = je.prefill(params, {"tokens": jnp.asarray(toks[:, :80],
                                                       jnp.int32)}, 96)
    tl, tc = te.prefill(tp, {"tokens": torch.from_numpy(toks[:, :80])}, 96)
    assert _rel(tl.numpy(), np.asarray(jl)) < 1e-4
    assert tc.k_pages_w.shape[3] == 8 and tc.page_pos_w.shape[1] == 8
    for i in range(3):
        jl, jc = je.decode_step(params, jc, jnp.asarray(
            toks[:, 80 + i:81 + i], jnp.int32))
        tl, tc = te.decode_step(tp, tc, torch.from_numpy(
            toks[:, 80 + i:81 + i]))
        assert _rel(tl.numpy(), np.asarray(jl)) < 1e-4
        assert (tl.numpy().argmax(-1) == np.asarray(jl).argmax(-1)).all()


def _jmesh():
    d = np.empty(8, dtype=object)
    d[:] = [jax.devices()[0]] * 8
    return JMesh(d.reshape(2, 4), ("data", "model"))


def _refusals(pkg, arch, **eng):
    """The calls each package refuses on a mesh, as thunks."""
    if pkg == "ref":
        cfg, params, _ = _weights(arch)
        e = KVNANDEngine(cfg, EngineConfig(page_tokens=4, **eng),
                         mesh=_jmesh())
        toks = jnp.ones((B, 16), jnp.int32)
        n = jnp.asarray
    else:
        cfg, _, params = _weights(arch)
        e = TEngine(tget(arch).reduced(), TEngineConfig(page_tokens=4, **eng),
                    mesh=MESH)
        toks = torch.ones((B, 16), dtype=torch.long)
        n = int
    return {
        "verify": lambda: e.verify_step(params, e.init_cache(B, 28),
                                        toks[:, :3], accept=None),
        "prompt_len": lambda: e.prefill(params, {"tokens": toks}, 28,
                                        prompt_len=n(10)),
        "prefill": lambda: e.prefill(params, {"tokens": toks}, 28),
        "chunk": lambda: e.prefill_chunk(params, e.init_cache(B, 32),
                                         {"tokens": toks[:1]}, n(0), n(0),
                                         n(16), first=True),
    }


@pytest.mark.parametrize("arch,eng,call,err", [
    (ARCH, dict(uniform_lengths=False), "verify", NotImplementedError),
    (ARCH, {}, "prompt_len", ValueError),
    (ARCH, dict(shared_pool=True), "prefill", NotImplementedError),
    (ARCH, dict(shared_pool=True, uniform_lengths=False), "chunk",
     NotImplementedError),
    ("gemma3-12b", dict(uniform_lengths=False), "chunk",
     NotImplementedError),
    ("rwkv6-3b", dict(uniform_lengths=False), "chunk", NotImplementedError),
    ("hymba-1.5b", dict(uniform_lengths=False), "chunk",
     NotImplementedError),
], ids=["verify", "prompt_len", "shared_prefill", "shared_chunk",
        "window_chunk", "rwkv_chunk", "hybrid_chunk"])
def test_the_reference_mesh_refusals_stand(arch, eng, call, err):
    for pkg in ("ref", "port"):
        with pytest.raises(err) as exc:
            _refusals(pkg, arch, **eng)[call]()
        if pkg == "ref":
            msg = str(exc.value)
        else:
            assert str(exc.value) == msg
