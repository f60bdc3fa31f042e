"""PyTorch port: checkpoints (`checkpoint/checkpoint.py`) on the CPU.

The reference's `tests/test_checkpoint.py` cases on the port (roundtrip
with `extra`, keep-K, a corrupt newest checkpoint skipped, a partial
write invisible, the async writer, dtypes preserved), and the format
shared with the reference: a checkpoint the reference saves restores in
the port to equal tensors and the reverse, a bfloat16 leaf included;
the flat dicts of the two flatteners are equal key for key; and a raw
2-byte bfloat16 payload is read through its int16 view.

Train states cross between the packages: three steps of one package's
`launch.train` write a `TrainState(params, AdamWState(step, m, v),
ef=None)` checkpoint; from copies of it the reference's driver and the
port's (`--device cpu`) each resume for steps 3-5, with losses within
1e-4 and step-6 states within the bounds of
`tests/test_torch_train.py::test_five_train_steps_match_reference`
(the reference's read back through `bridge.train_state_from_numpy`),
both ways.  The reference's periodic save is labelled one step behind
the updates it holds (ROADMAP §C).
"""
import collections
import json
import os
import shutil
import signal

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import checkpoint as jck
from repro.configs import get_config
from repro.launch import train as jtrain
from repro.models.registry import Model as JModel
from repro.training.optimizer import AdamWConfig, init_adamw
from repro.training.train_step import init_train_state as j_init_state
from repro_torch import bridge
from repro_torch.checkpoint import checkpoint as ck
from repro_torch.configs import get_config as tget
from repro_torch.launch import train as ttrain
from repro_torch.models.registry import Model as TModel
from repro_torch.training import optimizer as topt
from repro_torch.training.train_step import init_train_state as t_init_state

torch.set_num_threads(2)

State = collections.namedtuple("State", "step m v")


def _state():
    params = {"layers": {"w": torch.arange(12.0).reshape(3, 4)},
              "emb": torch.ones((5, 2))}
    zeros = {"layers": {"w": torch.zeros(3, 4)}, "emb": torch.zeros(5, 2)}
    return {"params": params,
            "opt": State(torch.zeros((), dtype=torch.int32), zeros,
                         {"layers": {"w": torch.full((3, 4), 0.5)},
                          "emb": torch.zeros(5, 2)}),
            "aux": None}


def _leaves(tree):
    return [v for v in bridge.flatten_with_paths(tree, records=True).values()
            if v is not None]


def test_roundtrip_exact(tmp_path):
    state = _state()
    ck.save_checkpoint(str(tmp_path), 7, state, extra={"cursor": 99})
    restored, extra = ck.restore_checkpoint(str(tmp_path), 7, state)
    assert extra["cursor"] == 99
    assert isinstance(restored["opt"], State) and restored["aux"] is None
    for a, b in zip(_leaves(state), _leaves(restored)):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_keep_k_retention(tmp_path):
    state = _state()
    for s in range(6):
        ck.save_checkpoint(str(tmp_path), s, state, keep=3)
    assert ck.list_steps(str(tmp_path)) == [3, 4, 5]


def test_corrupted_checkpoint_skipped(tmp_path):
    state = _state()
    ck.save_checkpoint(str(tmp_path), 1, state)
    ck.save_checkpoint(str(tmp_path), 2, state)
    with open(os.path.join(str(tmp_path), "step_00000002", "arrays.npz"),
              "r+b") as f:
        f.seek(10)
        f.write(b"\x00" * 32)
    assert ck.latest_step(str(tmp_path)) == 1
    with pytest.raises(ValueError):
        ck.restore_checkpoint(str(tmp_path), 2, state)


def test_partial_write_invisible(tmp_path):
    """A crash mid-write (tmp dir never renamed) is never listed."""
    state = _state()
    ck.save_checkpoint(str(tmp_path), 1, state)
    os.makedirs(os.path.join(str(tmp_path), "step_00000009.tmp-abc"))
    assert ck.list_steps(str(tmp_path)) == [1]


def test_async_checkpointer(tmp_path):
    """The async writer snapshots on save: a tensor mutated right after
    `save` is stored as it was."""
    state = _state()
    ac = ck.AsyncCheckpointer(str(tmp_path), keep=2)
    for s in (1, 2, 3):
        ac.save(s, state, extra={"cursor": s})
        state["params"]["emb"] += 1.0
    ac.wait()
    assert ck.latest_step(str(tmp_path)) == 3
    assert ck.list_steps(str(tmp_path)) == [2, 3]
    restored, extra = ck.restore_checkpoint(str(tmp_path), 3, state)
    assert extra["cursor"] == 3
    assert torch.equal(restored["params"]["emb"], torch.full((5, 2), 3.0))


def test_restore_dtype_preserved(tmp_path):
    state = {"w": torch.ones((4, 4), dtype=torch.bfloat16) / 3}
    ck.save_checkpoint(str(tmp_path), 0, state)
    restored, _ = ck.restore_checkpoint(str(tmp_path), 0, state)
    assert restored["w"].dtype == torch.bfloat16
    assert torch.equal(restored["w"], state["w"])


# ---------------------------------------------------------------------------
# one format: each package restores the other's checkpoints
# ---------------------------------------------------------------------------

def _jax_state():
    rng = np.random.default_rng(0)
    params = {"layers": {"w": jnp.asarray(rng.standard_normal((3, 4)),
                                          jnp.float32)},
              "emb": jnp.asarray(rng.standard_normal((5, 2)),
                                 jnp.bfloat16),
              "ids": jnp.arange(6, dtype=jnp.int32)}
    return {"params": params, "opt": init_adamw(params, AdamWConfig())}


def _as_torch(tree):
    """The same tree (NamedTuples kept) with torch leaves."""
    return jax.tree.map(
        lambda x: bridge.params_from_numpy({"x": np.asarray(x)}, "cpu")["x"],
        tree)


def _bits(x):
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy(), "bfloat16"
        return x.numpy(), str(x.numpy().dtype)
    a = np.asarray(x)
    if a.dtype.name == "bfloat16":
        return a.view(np.int16), "bfloat16"
    return a, str(a.dtype)


def _assert_same(jtree, ttree):
    jl = jax.tree.leaves(jtree)
    tl = jax.tree.leaves(ttree)
    assert len(jl) == len(tl)
    for j, t in zip(jl, tl):
        (ja, jd), (ta, td) = _bits(j), _bits(t)
        assert jd == td and np.array_equal(ja, ta)


def test_flat_dicts_equal_the_reference():
    jstate = _jax_state()
    want = jck._flatten_with_paths(jstate)
    got = ck._flatten_with_paths(_as_torch(jstate))
    assert list(got) == list(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and np.array_equal(
            got[k], want[k]), k


def test_reference_checkpoint_restores_in_the_port(tmp_path):
    jstate = _jax_state()
    jck.save_checkpoint(str(tmp_path), 4, jstate, extra={"cursor": 5})
    like = jax.tree.map(torch.zeros_like, _as_torch(jstate))
    restored, extra = ck.restore_checkpoint(str(tmp_path), 4, like)
    assert extra == {"cursor": 5}
    assert restored["params"]["emb"].dtype == torch.bfloat16
    _assert_same(jstate, restored)


def test_port_checkpoint_restores_in_the_reference(tmp_path):
    jstate = _jax_state()
    ck.save_checkpoint(str(tmp_path), 4, _as_torch(jstate),
                       extra={"cursor": 6})
    assert jck.latest_step(str(tmp_path)) == 4
    like = jax.tree.map(jnp.zeros_like, jstate)
    restored, extra = jck.restore_checkpoint(str(tmp_path), 4, like)
    assert extra == {"cursor": 6}
    assert restored["params"]["emb"].dtype == jnp.bfloat16
    _assert_same(restored, _as_torch(jstate))


def test_raw_bfloat16_payload_reads_through_its_int16_view(tmp_path):
    """A writer that stores bfloat16 as its 2-byte pattern (manifest
    dtype "bfloat16") restores bit for bit, without ml_dtypes."""
    w = torch.tensor([1.0, -2.5, 3.140625, 1e-3], dtype=torch.bfloat16)
    path = tmp_path / "step_00000001"
    path.mkdir()
    np.savez(path / "arrays.npz", w=w.view(torch.int16).numpy())
    import hashlib
    digest = hashlib.sha256((path / "arrays.npz").read_bytes()).hexdigest()
    (path / "manifest.json").write_text(json.dumps({
        "step": 1, "sha256": digest, "keys": ["w"],
        "shapes": {"w": [4]}, "dtypes": {"w": "bfloat16"}}))
    restored, _ = ck.restore_checkpoint(str(tmp_path), 1,
                                        {"w": torch.zeros_like(w)})
    assert torch.equal(restored["w"].view(torch.int16), w.view(torch.int16))


# ---------------------------------------------------------------------------
# train states: a run of one package resumes in the other
# ---------------------------------------------------------------------------

TRAIN_ARGS = ["--reduced", "--seq-len", "32", "--global-batch", "4",
              "--lr", "3e-3", "--log-every", "1"]


def _reference_train(argv):
    before = signal.getsignal(signal.SIGTERM)
    try:
        return jtrain.train(TRAIN_ARGS + argv)
    finally:   # the reference's driver leaves its handler installed
        signal.signal(signal.SIGTERM, before)


def _port_train(argv):
    return ttrain.train(TRAIN_ARGS + argv + ["--device", "cpu"])


def _restored_states(d_ref, d_port, step):
    """The step's checkpoint of each directory, the reference's restored
    by the reference and carried over by the bridge, the port's by the
    port."""
    cfg = get_config("qwen1.5-0.5b").reduced()
    jlike = j_init_state(JModel(cfg).init(jax.random.PRNGKey(0)),
                         AdamWConfig())
    jstate, jextra = jck.restore_checkpoint(d_ref, step, jlike)
    assert jstate.ef is None
    tlike = t_init_state(TModel(tget("qwen1.5-0.5b").reduced()).init(
        torch.Generator().manual_seed(0)), topt.AdamWConfig())
    tstate, textra = ck.restore_checkpoint(d_port, step, tlike)
    assert jextra == textra and tstate.ef is None
    return (bridge.train_state_from_numpy(
        jax.tree.map(np.asarray, jstate), "cpu"), tstate)


def _assert_states_close(want, got, lr_sum):
    assert int(want.opt.step) == int(got.opt.step)
    for path, w in bridge.flatten_with_paths(want.params).items():
        g = bridge.flatten_with_paths(got.params)[path]
        diff = (g - w).abs()
        assert float(diff.max()) <= 2 * lr_sum, path
        if not path.endswith("wk_b"):     # see test_torch_train.py
            assert float((diff <= 1e-6).float().mean()) >= 0.99, path
    for name in ("m", "v"):
        for w, g in zip(topt.tree_leaves(getattr(want.opt, name)),
                        topt.tree_leaves(getattr(got.opt, name))):
            torch.testing.assert_close(g, w, atol=1e-4, rtol=1e-2)


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_train_state_resumes_across_the_packages(tmp_path, writer):
    d, d_ref, d_port = (str(tmp_path / n) for n in ("d", "ref", "port"))
    first = (_reference_train if writer == "reference" else _port_train)(
        ["--steps", "3", "--ckpt-dir", d])
    assert len(first) == 3 and jck.latest_step(d) == ck.latest_step(d) == 3
    for dst in (d_ref, d_port):
        shutil.copytree(d, dst)
    want = _reference_train(["--steps", "6", "--ckpt-dir", d_ref])
    got = _port_train(["--steps", "6", "--ckpt-dir", d_port])
    assert len(got) == len(want) == 3
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)
    acfg = topt.AdamWConfig(lr=3e-3, warmup_steps=2, total_steps=6)
    lr_sum = sum(float(topt.lr_schedule(acfg, torch.tensor(s)))
                 for s in (4, 5, 6))
    _assert_states_close(*_restored_states(d_ref, d_port, 6), lr_sum)


def test_reference_periodic_save_is_one_step_behind(tmp_path):
    """The reference labels a periodic save with the loop step just run,
    which has applied one more update; the port labels it with the
    updates (ROADMAP §C, `launch/train.py`)."""
    d_ref, d_port = str(tmp_path / "ref"), str(tmp_path / "port")
    _reference_train(["--steps", "4", "--ckpt-every", "2", "--ckpt-dir",
                      d_ref])
    _port_train(["--steps", "4", "--ckpt-every", "2", "--ckpt-dir", d_port])
    for d, label in ((d_ref, 2), (d_port, 3)):
        data = np.load(os.path.join(d, f"step_{label:08d}", "arrays.npz"))
        assert int(data["opt/step"]) == 3
        assert json.load(open(os.path.join(
            d, f"step_{label:08d}", "manifest.json")))["extra"] == {
                "data_index": 3}
