"""Logical-axis sharding and the single-process device mesh (port of
`repro.distributed.sharding`).

The rules are the reference's: every parameter or activation carries a
tuple of logical axis names, and a rules dict maps them to mesh axes
(`logical_to_spec`, `spec_for_shape` with its divisibility fallback,
`tree_shardings`).

The mesh is the port's own, and one process drives all of it, as the
reference's one controller drives its `shard_map` bodies:

  * `Mesh` is an object array of `torch.device` with named axes
    (`.shape` an ordered name -> size map, `.size`, `.axis_names`;
    `with mesh:` sets the ambient mesh that `get_current_mesh` reads).
    Entries may repeat a device, so eight `cuda:0` entries run the
    sharded dataflow on one card (eight `cpu` entries in the tests).
  * `ShardedTensor` keeps a global tensor as one tensor per mesh
    coordinate, on that coordinate's device: `shard` splits a global
    tensor by a spec `P`, `ShardedTensor.assemble` puts one back
    together.  A coordinate's tensor is its own storage (a copy, never a
    view of a global tensor), so a write into one shard touches no other,
    on one card as on several.
  * `map_shards` calls a local body once per coordinate with
    `axis_index(name)` answering for that coordinate (the reference's
    `shard_map` body); the collectives `pmax`, `psum`, `pmean` and
    `ppermute` run between such calls, over named axes: each gathers a
    group's shard tensors onto the group's first device, reduces there
    and sends the result back with `.to(device)` (a no-op where the
    entries share a card).  A body that needs a collective partway
    through is split at it.
  * `manual_axes(**coord)` fixes mesh axes for the code inside it (the
    reference's shard_map manual over those axes, e.g. the compressed
    train step's pod and data): `effective_mesh` then leaves only the
    free axes, which nested sharded code (ring attention) maps over.

`constrain` is the identity: the reference uses it only as an XLA
layout hint (`with_sharding_constraint`), and nothing here lays out a
tensor behind the caller's back.
"""
from __future__ import annotations

import math
from contextlib import contextmanager
from dataclasses import dataclass
from typing import (Any, Callable, Dict, List, Mapping, Optional, Sequence,
                    Tuple, Union)

import numpy as np
import torch

Rules = Mapping[str, Union[str, Tuple[str, ...], None]]


class P(tuple):
    """A partition spec: one entry per dimension, None (whole), a mesh
    axis name, or a tuple of names (the dimension split over their
    product, the first name the outermost)."""

    def __new__(cls, *axes):
        return super().__new__(cls, axes)

    def __repr__(self):
        return "P(" + ", ".join(repr(a) for a in self) + ")"


def entry_axes(entry) -> Tuple[str, ...]:
    """The mesh axes of one spec entry, as a tuple."""
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def axes_spec(axes: Sequence[str]):
    """A spec entry for a tuple of mesh axes (the reference's
    `_axes_spec`): None, one name, or the tuple."""
    axes = tuple(axes)
    if not axes:
        return None
    return axes[0] if len(axes) == 1 else axes


# ---------------------------------------------------------------------------
# The mesh
# ---------------------------------------------------------------------------

# The ambient mesh, the fixed (manual) axes and the coordinate of the
# body being run: process-wide, not per thread, because autograd runs a
# card's backward on threads of its own, and a rematerialized layer
# recomputed there must see the mesh its forward saw
_STACKS = {"meshes": [], "manual": [], "coords": []}


def _stack(name: str) -> list:
    return _STACKS[name]


class Mesh:
    """Devices on named axes: `devices` is a sequence (or an array) of
    torch devices or device strings, reshaped to `shape` when given."""

    def __init__(self, devices, axis_names: Sequence[str],
                 shape: Optional[Sequence[int]] = None):
        flat = list(np.asarray(devices, dtype=object).reshape(-1))
        arr = np.empty(len(flat), dtype=object)
        for i, d in enumerate(flat):
            arr[i] = torch.device(d)
        if shape is None:
            shape = np.shape(np.asarray(devices, dtype=object))
        self.devices = arr.reshape(tuple(shape))
        self.axis_names = tuple(axis_names)
        if len(self.axis_names) != self.devices.ndim:
            raise ValueError(f"{len(self.axis_names)} axis names for a mesh "
                             f"of shape {self.devices.shape}")
        self.shape = dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    @property
    def empty(self) -> bool:
        return self.size == 0

    @property
    def first_device(self) -> torch.device:
        return self.devices.flat[0]

    def coords(self) -> List[Dict[str, int]]:
        """Every coordinate as {axis: index}, in row-major order (the
        order of `ShardedTensor.shards`)."""
        return [dict(zip(self.axis_names, c))
                for c in np.ndindex(*self.devices.shape)]

    def device(self, i: int) -> torch.device:
        return self.devices.flat[i]

    def submesh(self, fixed: Mapping[str, int]) -> "Mesh":
        """The mesh of the axes not in `fixed`, at those axes' indices."""
        idx = tuple(fixed.get(a, slice(None)) for a in self.axis_names)
        names = [a for a in self.axis_names if a not in fixed]
        return Mesh(self.devices[idx], names,
                    shape=[self.shape[a] for a in names])

    def __enter__(self):
        _stack("meshes").append(self)
        return self

    def __exit__(self, *exc):
        _stack("meshes").pop()
        return False

    def __eq__(self, other):
        return (isinstance(other, Mesh)
                and self.axis_names == other.axis_names
                and self.devices.shape == other.devices.shape
                and all(a == b for a, b in zip(self.devices.flat,
                                               other.devices.flat)))

    def __hash__(self):
        return hash((self.axis_names, self.devices.shape))

    def __repr__(self):
        return f"Mesh({self.shape}, {list(self.devices.flat)})"


def visible_devices() -> List[torch.device]:
    """Every visible card (the reference's `jax.devices()`)."""
    return [torch.device("cuda", i)
            for i in range(torch.cuda.device_count())]


def make_mesh_compat(shape: Sequence[int], axes: Sequence[str],
                     devices=None) -> Mesh:
    """A mesh of `shape` over `devices` (default every visible card),
    whose count must be the shape's product, as `jax.make_mesh` asks."""
    devices = visible_devices() if devices is None else list(devices)
    if len(devices) != math.prod(shape):
        raise ValueError(f"a {tuple(shape)} mesh needs {math.prod(shape)} "
                         f"devices, got {len(devices)}")
    return Mesh(devices, axes, shape=shape)


def get_current_mesh() -> Optional[Mesh]:
    """The innermost `with mesh:` mesh, or None."""
    st = _stack("meshes")
    if not st or st[-1].empty:
        return None
    return st[-1]


@contextmanager
def manual_axes(**coord: int):
    """Fix mesh axes at `coord` for the code inside (nests)."""
    st = _stack("manual")
    st.append(dict(coord))
    try:
        yield
    finally:
        st.pop()


def current_manual() -> Dict[str, int]:
    """Every axis fixed by the enclosing `manual_axes` blocks."""
    out: Dict[str, int] = {}
    for c in _stack("manual"):
        out.update(c)
    return out


def effective_mesh(mesh: Mesh) -> Mesh:
    """`mesh` without the axes fixed by `manual_axes` (itself when none
    of its axes is fixed)."""
    fixed = {a: i for a, i in current_manual().items() if a in mesh.shape}
    return mesh.submesh(fixed) if fixed else mesh


# ---------------------------------------------------------------------------
# Shard-local storage
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class NamedSharding:
    """Where a leaf goes: a mesh and a spec (the reference's
    `jax.sharding.NamedSharding`)."""
    mesh: Mesh
    spec: P


def _blocks(mesh: Mesh, spec: Sequence, ndim: int) -> List[int]:
    """Number of blocks along each of `ndim` dimensions."""
    spec = tuple(spec) + (None,) * (ndim - len(spec))
    return [math.prod(mesh.shape[a] for a in entry_axes(e)) for e in spec]


def _block_index(mesh: Mesh, spec: Sequence, ndim: int,
                 coord: Mapping[str, int]) -> Tuple[int, ...]:
    """The block a coordinate holds, along each dimension."""
    spec = tuple(spec) + (None,) * (ndim - len(spec))
    out = []
    for e in spec:
        i = 0
        for a in entry_axes(e):
            i = i * mesh.shape[a] + coord[a]
        out.append(i)
    return tuple(out)


def _private_copy(t: torch.Tensor, device) -> torch.Tensor:
    out = torch.empty(t.shape, dtype=t.dtype, device=device)
    out.copy_(t)
    return out


class ShardedTensor:
    """A global tensor as one tensor per coordinate of `mesh`
    (`shards`, row-major over `mesh.coords()`), laid out by `spec`.
    Replicas along an axis the spec does not name each hold their own
    copy."""

    def __init__(self, mesh: Mesh, spec: Sequence, shards: List):
        if len(shards) != mesh.size:
            raise ValueError(f"{len(shards)} shards for a mesh of "
                             f"{mesh.size}")
        self.mesh = mesh
        self.spec = P(*spec)
        self.shards = list(shards)

    @property
    def ndim(self) -> int:
        return self.shards[0].ndim

    @property
    def dtype(self) -> torch.dtype:
        return self.shards[0].dtype

    @property
    def shape(self) -> Tuple[int, ...]:
        n = _blocks(self.mesh, self.spec, self.ndim)
        return tuple(s * b for s, b in zip(self.shards[0].shape, n))

    @property
    def sharding(self) -> NamedSharding:
        return NamedSharding(self.mesh, self.spec)

    def local(self, coord: Mapping[str, int]) -> torch.Tensor:
        i = 0
        for a in self.mesh.axis_names:
            i = i * self.mesh.shape[a] + coord[a]
        return self.shards[i]

    def map(self, fn: Callable, spec: Optional[Sequence] = None
            ) -> "ShardedTensor":
        """fn over every shard (views stay views), laid out by `spec`
        (default this one's)."""
        return ShardedTensor(self.mesh, self.spec if spec is None else spec,
                             [fn(t) for t in self.shards])

    def assemble(self, device=None) -> torch.Tensor:
        """The global tensor on `device` (default the mesh's first),
        each block read from the first coordinate that holds it.
        Differentiable."""
        device = self.mesh.first_device if device is None else device
        nb = _blocks(self.mesh, self.spec, self.ndim)
        held: Dict[Tuple[int, ...], torch.Tensor] = {}
        for coord, t in zip(self.mesh.coords(), self.shards):
            held.setdefault(_block_index(self.mesh, self.spec, self.ndim,
                                         coord), t)

        def build(prefix: Tuple[int, ...], d: int) -> torch.Tensor:
            if d == self.ndim:
                return held[prefix].to(device)
            if nb[d] == 1:
                return build(prefix + (0,), d + 1)
            return torch.cat([build(prefix + (i,), d + 1)
                              for i in range(nb[d])], dim=d)

        return build((), 0)

    def __repr__(self):
        return (f"ShardedTensor({tuple(self.shape)}, {self.dtype}, "
                f"{self.spec}, {self.mesh.shape})")


def shard(x: torch.Tensor, mesh: Mesh, spec: Sequence, *,
          copy: bool = True) -> ShardedTensor:
    """Split a global tensor by `spec` onto the mesh.  copy=True gives
    each coordinate storage of its own (a pool that will be written);
    copy=False may hand back views where a device holds the source
    (read-only operands; differentiable)."""
    nb = _blocks(mesh, spec, x.ndim)
    for d, (n, b) in enumerate(zip(x.shape, nb)):
        if n % b:
            raise ValueError(f"dim {d} of {tuple(x.shape)} does not split "
                             f"into {b} blocks ({P(*spec)} over "
                             f"{mesh.shape})")
    out = []
    for i, coord in enumerate(mesh.coords()):
        blk = _block_index(mesh, spec, x.ndim, coord)
        sl = tuple(slice(j * (n // b), (j + 1) * (n // b))
                   for j, n, b in zip(blk, x.shape, nb))
        part = x[sl]
        out.append(_private_copy(part, mesh.device(i)) if copy
                   else part.to(mesh.device(i)))
    return ShardedTensor(mesh, spec, out)


def zeros(mesh: Mesh, spec: Sequence, shape: Sequence[int],
          dtype: torch.dtype) -> ShardedTensor:
    """A zero global tensor of `shape` laid out by `spec`, built shard by
    shard on the coordinates' devices (no global tensor is made)."""
    nb = _blocks(mesh, spec, len(shape))
    if any(n % b for n, b in zip(shape, nb)):
        raise ValueError(f"{tuple(shape)} does not split by {P(*spec)} over "
                         f"{mesh.shape}")
    local = tuple(n // b for n, b in zip(shape, nb))
    return ShardedTensor(mesh, spec, [
        torch.zeros(local, dtype=dtype, device=mesh.device(i))
        for i in range(mesh.size)])


def place(x, sharding: Optional[NamedSharding]):
    """A leaf put where `sharding` says (the reference's
    `jax.device_put(x, sharding)`): a tensor or a ShardedTensor split
    onto its mesh; None leaves it as it is."""
    if sharding is None:
        return x
    if isinstance(x, ShardedTensor):
        x = x.assemble()
    return shard(x, sharding.mesh, sharding.spec)


# ---------------------------------------------------------------------------
# Local bodies and collectives
# ---------------------------------------------------------------------------

@contextmanager
def _at(mesh: Mesh, coord: Dict[str, int]):
    st = _stack("coords")
    st.append((mesh, coord))
    try:
        yield
    finally:
        st.pop()


def axis_index(name: str) -> int:
    """This coordinate's index along `name`, inside a `map_shards`
    body, or along an axis fixed by `manual_axes`."""
    st = _stack("coords")
    if st and name in st[-1][1]:
        return st[-1][1][name]
    manual = current_manual()
    if name in manual:
        return manual[name]
    raise KeyError(f"axis_index({name!r}) outside a body mapped over it")


def axis_size(name: str) -> int:
    st = _stack("coords")
    if st and name in st[-1][0].shape:
        return st[-1][0].shape[name]
    mesh = get_current_mesh()
    if mesh is not None and name in mesh.shape:
        return mesh.shape[name]
    raise KeyError(f"axis_size({name!r}) outside a mesh with that axis")


def map_shards(fn: Callable, *args, mesh: Optional[Mesh] = None,
               out_specs=None):
    """Call `fn` once per mesh coordinate on that coordinate's shard of
    every ShardedTensor argument (any other argument is passed as it
    is), with `axis_index` answering for the coordinate.  Returns a
    ShardedTensor (or a tuple of them when `fn` returns a tuple; None
    when it returns None) laid out by `out_specs` (default the first
    ShardedTensor argument's spec)."""
    sharded = [a for a in args if isinstance(a, ShardedTensor)]
    if mesh is None:
        mesh = sharded[0].mesh
    outs = []
    for i, coord in enumerate(mesh.coords()):
        loc = [a.shards[i] if isinstance(a, ShardedTensor) else a
               for a in args]
        with _at(mesh, coord):
            outs.append(fn(*loc))
    if outs[0] is None:
        return None
    if out_specs is None:
        out_specs = sharded[0].spec
    if isinstance(outs[0], tuple):
        specs = (out_specs if isinstance(out_specs, list)
                 else [out_specs] * len(outs[0]))
        return tuple(ShardedTensor(mesh, s, [o[j] for o in outs])
                     for j, s in enumerate(specs))
    return ShardedTensor(mesh, out_specs, outs)


def _groups(mesh: Mesh, axes: Sequence[str]) -> List[List[int]]:
    """Coordinates (flat indices) that differ only along `axes`."""
    groups: Dict[Tuple, List[int]] = {}
    for i, c in enumerate(mesh.coords()):
        key = tuple(v for a, v in c.items() if a not in axes)
        groups.setdefault(key, []).append(i)
    return list(groups.values())


def _reduce(x: ShardedTensor, axes, op) -> ShardedTensor:
    axes = entry_axes(axes) if isinstance(axes, str) else tuple(axes)
    out: List[Optional[torch.Tensor]] = [None] * x.mesh.size
    for members in _groups(x.mesh, axes):
        home = x.mesh.device(members[0])
        r = op([x.shards[i].to(home) for i in members])
        for i in members:
            out[i] = r.to(x.mesh.device(i))
    return ShardedTensor(x.mesh, x.spec, out)


def pmax(x: ShardedTensor, axes) -> ShardedTensor:
    """Elementwise max over the coordinates along `axes`."""
    return _reduce(x, axes, lambda v: torch.stack(v).amax(dim=0))


def psum(x: ShardedTensor, axes, dtype: Optional[torch.dtype] = None
         ) -> ShardedTensor:
    """Sum over the coordinates along `axes`, in coordinate order; with
    `dtype`, each shard moves as it is and is cast to `dtype` before
    the sum (int8 codes summed in int32)."""
    def add(v):
        v = v if dtype is None else [t.to(dtype) for t in v]
        acc = v[0]
        for t in v[1:]:
            acc = acc + t
        return acc
    return _reduce(x, axes, add)


def pmean(x: ShardedTensor, axes) -> ShardedTensor:
    axes = (axes,) if isinstance(axes, str) else tuple(axes)
    n = math.prod(x.mesh.shape[a] for a in axes)
    return psum(x, axes).map(lambda t: t / n)


def ppermute(x: ShardedTensor, axis: str,
             perm: Sequence[Tuple[int, int]]) -> ShardedTensor:
    """Send each coordinate's shard along `axis` from index src to index
    dst for every (src, dst) in `perm`; a coordinate no pair names gets
    zeros (as `jax.lax.ppermute`)."""
    mesh = x.mesh
    coords = mesh.coords()
    where = {tuple(c.values()): i for i, c in enumerate(coords)}
    dst_of = dict(perm)
    out: List[Optional[torch.Tensor]] = [None] * mesh.size
    for i, c in enumerate(coords):
        if c[axis] not in dst_of:
            continue
        d = dict(c, **{axis: dst_of[c[axis]]})
        j = where[tuple(d.values())]
        out[j] = x.shards[i].to(mesh.device(j))
    for j, t in enumerate(out):
        if t is None:
            out[j] = torch.zeros_like(x.shards[j])
    return ShardedTensor(mesh, x.spec, out)


# ---------------------------------------------------------------------------
# Rule sets
# ---------------------------------------------------------------------------

# Tensor-parallel baseline: weights TP over "model", replicated over data/pod.
BASE_RULES: Dict[str, Any] = {
    # parameter axes
    "layer": None,          # stacked-layer leading axis
    "vocab": "model",
    "embed": None,          # d_model
    "heads": "model",       # flattened G*d_head (head-group-major)
    "head_dim": "model",    # per-kv-head d_head columns
    "kv": "model",          # flattened n_kv*d_head
    "mlp": "model",         # dense FFN hidden
    "expert": "model",      # MoE expert axis (EP)
    "moe_mlp": None,        # per-expert FFN hidden (expert axis already TP)
    "norm": None,
    "ssm": None,            # small SSM/decay params
    # activation axes
    "batch": ("data",),
    "act_seq": "model",     # sequence-parallel activations
    "act_heads": "model",
    "act_embed": None,
    "act_mlp": "model",
    "kv_pages": "model",    # paged KV cache page axis (the paper's G2 shards)
}

# FSDP addition: shard the d_model axis of params over "data" as well.
FSDP_RULES: Dict[str, Any] = dict(BASE_RULES, embed="data", moe_mlp="data")


def make_rules(*, fsdp: bool = False, multi_pod: bool = False,
               overrides: Optional[Rules] = None) -> Dict[str, Any]:
    rules = dict(FSDP_RULES if fsdp else BASE_RULES)
    if multi_pod:
        # batch data-parallel over both pod and data axes
        rules["batch"] = ("pod", "data")
    if overrides:
        rules.update(overrides)
    return rules


def logical_to_spec(axes: Sequence[Optional[str]], rules: Rules) -> P:
    """Map a tuple of logical axis names to a spec; a mesh axis is used
    by one dimension at most (the first that asks for it)."""
    mesh_axes = []
    used: set = set()
    for ax in axes:
        m = None if ax is None else rules.get(ax, None)
        if m is None:
            mesh_axes.append(None)
            continue
        flat = (m,) if isinstance(m, str) else tuple(m)
        avail = tuple(a for a in flat if a not in used)
        used.update(avail)
        if not avail:
            mesh_axes.append(None)
        elif len(avail) == 1:
            mesh_axes.append(avail[0])
        else:
            mesh_axes.append(avail)
    return P(*mesh_axes)


def spec_for_shape(shape: Sequence[int], axes: Sequence[Optional[str]],
                   rules: Rules, mesh) -> P:
    """`logical_to_spec` with the divisibility fallback: a dimension the
    mesh does not divide stays whole.  `mesh` needs only `.shape`."""
    spec = logical_to_spec(axes, rules)
    fixed = []
    for dim, m in zip(shape, spec):
        n = math.prod(mesh.shape[a] for a in entry_axes(m))
        fixed.append(m if m is not None and n > 0 and dim % n == 0
                     else None)
    return P(*fixed)


def tree_shardings(abstract_tree: Any, spec_tree: Any, rules: Rules,
                   mesh: Mesh) -> Any:
    """A tree of `NamedSharding`s for (params, logical-axes) trees of one
    structure (nested dicts).  A `QuantizedWeight` leaf expands into a
    `QuantizedWeight` of shardings for its q and scale; a None axes
    entry replicates the leaf."""
    from repro_torch.core.quant import QuantizedWeight

    def one(leaf, axes):
        if isinstance(leaf, QuantizedWeight):
            return QuantizedWeight(one(leaf.q, tuple(axes.q)),
                                   one(leaf.scale, tuple(axes.scale)),
                                   leaf.scheme, leaf.orig_shape)
        if axes is None:
            return NamedSharding(mesh, P())
        return NamedSharding(mesh, spec_for_shape(leaf.shape, axes, rules,
                                                  mesh))

    if isinstance(abstract_tree, dict):
        return {k: tree_shardings(v, spec_tree[k], rules, mesh)
                for k, v in abstract_tree.items()}
    return one(abstract_tree, spec_tree)


def constrain(x, axes: Sequence[Optional[str]], rules: Rules,
              mesh: Optional[Mesh] = None):
    """The identity: the reference's `with_sharding_constraint` is an
    XLA layout hint, and eager torch has no layout pass to hint."""
    return x
