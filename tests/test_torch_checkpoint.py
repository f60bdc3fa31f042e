"""PyTorch port: checkpoints (`checkpoint/checkpoint.py`) on the CPU.

The reference's `tests/test_checkpoint.py` cases on the port (roundtrip
with `extra`, keep-K, a corrupt newest checkpoint skipped, a partial
write invisible, the async writer, dtypes preserved), and the format
shared with the reference: a checkpoint the reference saves restores in
the port to equal tensors and the reverse, a bfloat16 leaf included;
the flat dicts of the two flatteners are equal key for key; and a raw
2-byte bfloat16 payload is read through its int16 view.
"""
import collections
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import checkpoint as jck
from repro.training.optimizer import AdamWConfig, init_adamw
from repro_torch import bridge
from repro_torch.checkpoint import checkpoint as ck

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
