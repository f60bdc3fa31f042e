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
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from repro_torch.core.quant import QuantizedWeight

SEP = "/"


def flatten_with_paths(tree) -> Dict[str, Any]:
    """{"a/b/c": leaf} in the reference checkpoint's sorted-key order."""
    flat: Dict[str, Any] = {}

    def walk(prefix, node):
        if isinstance(node, dict):
            for k in sorted(node):
                walk(f"{prefix}{SEP}{k}" if prefix else str(k), node[k])
        elif hasattr(node, "_fields"):
            raise TypeError(
                f"{prefix}: a NamedTuple leaf is not part of the reference's "
                "parameter tree")
        else:
            flat[prefix] = node

    walk("", tree)
    return flat


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
