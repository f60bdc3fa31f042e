"""Weight bridge: the JAX reference's parameter tree -> the port's tensors.

The reference keeps parameters as a nested dict of arrays (stacked
layers carry a leading layer axis).  The port keeps the SAME tree of
torch tensors, so every leaf keeps the name it has in
`repro/checkpoint/checkpoint.py::_flatten_with_paths` ("layers/attn/wq_w",
"embedding", ...) and a test can compare the two leaf by leaf.

Input is a nested dict of numpy arrays (what `jax.tree.map(np.asarray,
params)` gives); no jax import is needed.  bfloat16 leaves arrive as
ml_dtypes arrays and are carried over bit-exactly through their uint16
view.  A quantized weight leaf (the reference's `QuantizedWeight`, a
registered pytree class holding numpy `q` and `scale` after the tree map)
is recognised by its attributes and carried over, codes and scales bit
for bit, into the port's `core.quant.QuantizedWeight`.

A train state crosses both ways: `train_state_from_numpy` takes the
reference's `TrainState(params, AdamWState(step, m, v), ef)` with numpy
leaves and builds the port's, and `train_state_to_numpy` gives the
port's back as the same NamedTuples (the port's types) of numpy leaves.
The error-feedback residuals `ef` (the compressed data-parallel step's)
cross too: a reference residual (one array a leaf, what a reference
restore replicates) becomes one plain bfloat16 tensor a leaf, which the
port's compressed step gives to every pod; the port's per-pod residuals
([n_pods, ...] over the mesh's pod axis) come back as those stacks.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from repro_torch.core.quant import QuantizedWeight

SEP = "/"


def tree_leaves(tree):
    """The leaves of a nested dict in the reference's flattening order
    (sorted keys), which is the order `jax.tree.leaves` gives."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    return [tree]


def tree_map(fn, tree, *rest):
    """`fn` over the leaves of nested dicts of one structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return fn(tree, *rest)


def tree_unflatten(like, leaves):
    """Nested dicts of `like`'s structure holding `leaves`, given in
    `tree_leaves` order."""
    it = iter(leaves)

    def build(node):
        if isinstance(node, dict):
            return {k: build(node[k]) for k in sorted(node)}
        return next(it)

    return build(like)


def flatten_with_paths(tree, *, records: bool = False) -> Dict[str, Any]:
    """{"a/b/c": leaf} in the reference checkpoint's sorted-key order.

    The parameter tree is dicts of leaves, and a NamedTuple in it is
    refused.  With `records` (the checkpoint's and the KV envelope's
    trees) a NamedTuple is walked field by field and a None leaf is kept
    as ``"<path>/__none__": None``, as the reference's
    `_flatten_with_paths` keeps them."""
    flat: Dict[str, Any] = {}

    def walk(prefix, node):
        if isinstance(node, dict):
            for k in sorted(node):
                walk(f"{prefix}{SEP}{k}" if prefix else str(k), node[k])
        elif hasattr(node, "_fields"):
            if not records:
                raise TypeError(
                    f"{prefix}: a NamedTuple leaf is not part of the "
                    "reference's parameter tree")
            for k in node._fields:
                walk(f"{prefix}{SEP}{k}" if prefix else k, getattr(node, k))
        elif node is None and records:
            flat[prefix + SEP + "__none__"] = None
        else:
            flat[prefix] = node

    walk("", tree)
    return flat


def to_numpy(t) -> np.ndarray:
    """A private host copy of a tensor (the way back from `_to_tensor`):
    bfloat16 as float32, which npz can store and which holds every bf16
    value exactly, as the reference's checkpoint flattener stores it.  A
    card's tensor is read with a same-stream copy; a mesh's sharded leaf
    is assembled first."""
    if hasattr(t, "assemble"):
        t = t.assemble()
    t = t.detach()
    if t.dtype == torch.bfloat16:
        return t.float().cpu().numpy()
    if t.device.type == "cpu":
        return t.numpy().copy()
    return t.cpu().numpy()


def unflatten(flat: Dict[str, Any]) -> Dict[str, Any]:
    tree: Dict[str, Any] = {}
    for path, leaf in flat.items():
        node = tree
        *parents, name = path.split(SEP)
        for p in parents:
            node = node.setdefault(p, {})
        node[name] = leaf
    return tree


def _is_quantized(node) -> bool:
    return all(hasattr(node, a) for a in ("q", "scale", "scheme",
                                          "orig_shape"))


def _to_tensor(arr: np.ndarray, device) -> torch.Tensor:
    arr = np.array(arr)                    # a private, writable copy
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.view(np.uint16)).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(arr).to(device)


def params_from_numpy(tree, device="cuda") -> Dict[str, Any]:
    """Reference numpy params -> the port's params on `device`."""

    def leaf(a):
        if _is_quantized(a):
            return QuantizedWeight(_to_tensor(a.q, device),
                                   _to_tensor(a.scale, device), a.scheme,
                                   a.orig_shape)
        return _to_tensor(a, device)

    return unflatten({p: leaf(a)
                      for p, a in flatten_with_paths(tree).items()})


def train_state_from_numpy(state, device="cuda") -> "TrainState":
    """A reference `TrainState` with numpy leaves (`jax.tree.map(
    np.asarray, state)`) -> the port's on `device`: the params, both
    moments and the error-feedback residuals (when there are) through
    `params_from_numpy`, the step a 0-d int32 tensor."""
    from repro_torch.training.optimizer import AdamWState
    from repro_torch.training.train_step import TrainState
    opt = state.opt
    return TrainState(
        params_from_numpy(state.params, device),
        AdamWState(torch.tensor(int(np.asarray(opt.step)), dtype=torch.int32,
                                device=device),
                   params_from_numpy(opt.m, device),
                   params_from_numpy(opt.v, device)),
        None if state.ef is None else params_from_numpy(state.ef, device))


def train_state_to_numpy(state: "TrainState") -> "TrainState":
    """The port's `TrainState` -> the same NamedTuples of host numpy
    leaves (bfloat16 moments as float32, as the checkpoint stores them),
    from which a test rebuilds the reference's with `jnp.asarray`."""
    from repro_torch.training.optimizer import AdamWState
    from repro_torch.training.train_step import TrainState
    opt = state.opt
    return TrainState(tree_map(to_numpy, state.params),
                      AdamWState(to_numpy(opt.step), tree_map(to_numpy, opt.m),
                                 tree_map(to_numpy, opt.v)),
                      None if state.ef is None
                      else tree_map(to_numpy, state.ef))
