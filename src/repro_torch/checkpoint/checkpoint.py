"""Fault-tolerant checkpoints (port of `repro.checkpoint.checkpoint`):
atomic, integrity-checked, keep-K, over trees of torch tensors.

The on-disk format is the reference's own, so a checkpoint written by
either package restores in the other:

    ckpt_dir/step_00000123.tmp-<nonce>/   (written first)
        arrays.npz        flat {path -> host array}
        manifest.json     {step, sha256 of arrays.npz, keys, shapes,
                           dtypes, wall time, extra}
    ckpt_dir/step_00000123/               (atomic rename when complete)

Paths are the reference's (`bridge.flatten_with_paths` with records:
dict keys sorted, NamedTuple fields in order, a None leaf stored as
``<path>/__none__``).  npz has no bfloat16: a bf16 leaf is stored as
float32 (lossless), as the reference stores it, and restore casts each
leaf to the dtype of the matching leaf of `like`.  A payload that does
carry 2-byte bfloat16 (manifest dtype "bfloat16") is read through an
int16 view, never through `ml_dtypes`.

A quantized weight (`core.quant.QuantizedWeight`) is stored as the
record of its arrays, ``<path>/q`` and ``<path>/scale``, and restored
into the scheme and shape of the `like` leaf.  That is the form the
reference writes and reads for a NamedTuple with fields (q, scale); its
own `QuantizedWeight` leaf goes into the npz as a pickled object, which
its restore refuses (ROADMAP §C).

A corrupt or partial checkpoint (bad hash, missing file, a `.tmp-`
directory never renamed) is skipped: `latest_step` reports only
directories whose manifest validates.

Checkpoints are topology-agnostic: a leaf sharded over a device mesh
(`distributed.sharding.ShardedTensor`) is stored whole, and
`restore_checkpoint(shardings=...)` places each leaf on whatever mesh the
restart has (elastic restart on fewer devices); a sharded `like` leaf
with no sharding given goes back onto its own mesh.
"""
from __future__ import annotations

import hashlib
import json
import os
import shutil
import tempfile
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.bridge import SEP, flatten_with_paths, to_numpy
from repro_torch.core.quant import QuantizedWeight
from repro_torch.distributed.sharding import ShardedTensor, place


def _host(leaf) -> np.ndarray:
    """One leaf as the npz stores it (bf16 as float32); a tensor as a
    private copy, since torch tensors are written in place."""
    if isinstance(leaf, (torch.Tensor, ShardedTensor)):
        return to_numpy(leaf)
    arr = np.asarray(leaf)
    if arr.dtype.name == "bfloat16":       # an ml_dtypes array handed in
        arr = arr.astype(np.float32)
    return arr


def _flatten_with_paths(tree) -> Dict[str, np.ndarray]:
    """{path: host array}, the reference's flat checkpoint dict (a
    quantized weight as its q and scale)."""
    flat = {}
    for k, v in flatten_with_paths(tree, records=True).items():
        if isinstance(v, QuantizedWeight):
            flat[f"{k}{SEP}q"], flat[f"{k}{SEP}scale"] = (_host(v.q),
                                                          _host(v.scale))
        else:
            flat[k] = np.zeros((), np.int8) if v is None else _host(v)
    return flat


def _write(ckpt_dir: str, step: int, flat: Dict[str, np.ndarray],
           keep: int, extra: Optional[Dict[str, Any]]) -> str:
    os.makedirs(ckpt_dir, exist_ok=True)
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    tmp = tempfile.mkdtemp(prefix=f"step_{step:08d}.tmp-", dir=ckpt_dir)
    try:
        npz_path = os.path.join(tmp, "arrays.npz")
        np.savez(npz_path, **flat)
        with open(npz_path, "rb") as f:
            digest = hashlib.sha256(f.read()).hexdigest()
        manifest = {
            "step": step,
            "sha256": digest,
            "keys": sorted(flat.keys()),
            "shapes": {k: list(v.shape) for k, v in flat.items()},
            "dtypes": {k: str(v.dtype) for k, v in flat.items()},
            "time": time.time(),
        }
        if extra:
            manifest["extra"] = extra
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    _prune(ckpt_dir, keep)
    return final


def save_checkpoint(ckpt_dir: str, step: int, tree, *, keep: int = 3,
                    extra: Optional[Dict[str, Any]] = None) -> str:
    """Atomic checkpoint write; prunes to the newest `keep` checkpoints."""
    return _write(ckpt_dir, step, _flatten_with_paths(tree), keep, extra)


def _prune(ckpt_dir: str, keep: int):
    steps = sorted(list_steps(ckpt_dir))
    for s in steps[:-keep] if keep > 0 else []:
        shutil.rmtree(os.path.join(ckpt_dir, f"step_{s:08d}"),
                      ignore_errors=True)


def list_steps(ckpt_dir: str) -> List[int]:
    if not os.path.isdir(ckpt_dir):
        return []
    out = []
    for name in os.listdir(ckpt_dir):
        if name.startswith("step_") and ".tmp-" not in name:
            path = os.path.join(ckpt_dir, name, "manifest.json")
            if os.path.exists(path):
                try:
                    out.append(int(name[len("step_"):]))
                except ValueError:
                    pass
    return sorted(out)


def latest_step(ckpt_dir: str) -> Optional[int]:
    """Newest step whose checkpoint passes integrity validation."""
    for s in reversed(list_steps(ckpt_dir)):
        if validate_checkpoint(os.path.join(ckpt_dir, f"step_{s:08d}")):
            return s
    return None


def validate_checkpoint(path: str) -> bool:
    try:
        with open(os.path.join(path, "manifest.json")) as f:
            manifest = json.load(f)
        with open(os.path.join(path, "arrays.npz"), "rb") as f:
            digest = hashlib.sha256(f.read()).hexdigest()
        return digest == manifest["sha256"]
    except (OSError, json.JSONDecodeError, KeyError):
        return False


def _tensor(arr: np.ndarray, stored: Optional[str]) -> torch.Tensor:
    """A stored array as a CPU tensor; raw 2-byte bfloat16 through an
    int16 view."""
    if stored == "bfloat16" or arr.dtype.kind == "V":
        return torch.from_numpy(
            np.ascontiguousarray(arr).view(np.int16).copy()).view(
                torch.bfloat16)
    return torch.from_numpy(np.array(arr))


def restore_checkpoint(ckpt_dir: str, step: int, like, device=None,
                       shardings=None) -> Tuple[Any, Dict[str, Any]]:
    """Restore into the structure of `like` (values replaced): every
    leaf becomes a tensor of the like-leaf's dtype, on `device` or else
    on the like-leaf's device (the CPU for a non-tensor leaf).
    `shardings`: an optional tree of `like`'s structure holding a
    `NamedSharding` (or None) a leaf: that leaf is split onto its mesh
    (`sharding.place`), so a restore works on any mesh; a sharded `like`
    leaf without one keeps its own."""
    path = os.path.join(ckpt_dir, f"step_{step:08d}")
    if not validate_checkpoint(path):
        raise ValueError(f"checkpoint {path} failed integrity check")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    stored = manifest.get("dtypes", {})
    data = np.load(os.path.join(path, "arrays.npz"))

    def leaf(key, node, sh):
        t = _tensor(data[key], stored.get(key))
        if isinstance(node, ShardedTensor):
            return place(t.to(node.dtype), sh or node.sharding)
        if isinstance(node, torch.Tensor):
            t = t.to(device=device or node.device, dtype=node.dtype)
        else:
            if hasattr(node, "dtype"):
                t = torch.from_numpy(t.numpy().astype(node.dtype))
            t = t.to(device or "cpu")
        return place(t, sh)

    def rebuild(prefix, node, sh):
        def sub(k):
            if sh is None:
                return None
            return sh[k] if isinstance(sh, dict) else getattr(sh, k)
        if isinstance(node, dict):
            return {k: rebuild(f"{prefix}{SEP}{k}" if prefix else str(k), v,
                               sub(k)) for k, v in node.items()}
        if hasattr(node, "_fields"):
            return type(node)(*[
                rebuild(f"{prefix}{SEP}{k}" if prefix else k,
                        getattr(node, k), sub(k)) for k in node._fields])
        if node is None:
            return None
        if isinstance(node, QuantizedWeight):
            return QuantizedWeight(
                leaf(f"{prefix}{SEP}q", node.q, sh and sh.q),
                leaf(f"{prefix}{SEP}scale", node.scale, sh and sh.scale),
                node.scheme, node.orig_shape)
        return leaf(prefix, node, sh)

    return rebuild("", like, shardings), manifest.get("extra", {})


class AsyncCheckpointer:
    """Background-thread checkpoint writer: `save` copies the tree to the
    host on the caller's thread (so the caller may go on mutating its
    tensors), and the npz write, hash and rename run on a thread."""

    def __init__(self, ckpt_dir: str, keep: int = 3):
        self.ckpt_dir = ckpt_dir
        self.keep = keep
        self._thread: Optional[threading.Thread] = None
        self.last_error: Optional[BaseException] = None

    def save(self, step: int, tree, extra=None):
        self.wait()
        flat = _flatten_with_paths(tree)

        def work():
            try:
                _write(self.ckpt_dir, step, flat, self.keep, extra)
            except BaseException as e:  # surfaced on next wait()
                self.last_error = e

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self.last_error is not None:
            err, self.last_error = self.last_error, None
            raise err
