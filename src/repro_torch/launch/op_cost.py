"""Op-level cost counter for the dry-run (counterpart of
`repro.launch.hlo_cost`, which reads XLA's optimized HLO text).

The port has no compiled program to read, so `OpCounter` is a
`TorchDispatchMode` over one run of the step on meta tensors: every aten
op the step (and its backward) dispatches passes through it with its
shapes and dtypes, and nothing is computed or allocated.  The accounting
is hlo_cost's:

  flops   — matrix products: 2 · |result| · K for `mm`, `addmm`, `bmm`
            and `baddbmm`, which is what `linear`, `matmul` and `einsum`
            decompose into at the aten level, forward and backward.
            The dry-run's cells run the single-device program, which
            runs no collective, so there is no collective count.
  bytes   — per op: Σ operands + result, except
              * views, reshapes, permutes, expands and aliases → 0
                (hlo's bitcast / get-tuple-element / tuple), and an
                uninitialized allocation → 0;
              * slicing reads (`index`, `index_select`, `gather`,
                `embedding`) → |result| (a slice is a view, which its
                consumer reads);
              * writes (`index_put_`, `scatter`, `copy_`, into a slice
                or not) → 2 · |update|, and a fill → its result;
              * a dequantize of int8 / packed int4 codes into a float
                weight (elementwise ops reading int8 / uint8 storage, and
                whatever elementwise ops follow them) → 0, and its first
                non-elementwise consumer reads the packed codes and
                scales in place of the float weight, as B3 reads the
                packed form (hlo_cost's fused-dequantization rule).
            An op whose result's last two dims are in `fusible_last2`
            (attention score / probability blocks, page layout copies)
            counts into `fusible_bytes` instead: the plain path
            materializes them, a kernel keeps them on chip.
  peak    — the storages allocated on meta while the step runs, freed
            through weakrefs as the step drops them: `peak_bytes` is the
            most alive at once (the step's outputs included).

Eager code runs every layer, so hlo_cost's while-loop trip-count
multiplication has no counterpart: a loop of n products dispatches n
products.
"""
from __future__ import annotations

import dataclasses
import weakref
from typing import Dict, Iterable

import torch
from torch.utils._python_dispatch import TorchDispatchMode

aten = torch.ops.aten

_INT_STORAGE = (torch.int8, torch.uint8)

_MATMULS = {aten.mm, aten.addmm, aten.bmm, aten.baddbmm}

# hlo's bitcast / get-tuple-element / tuple / parameter: no traffic (and
# every view op, `func.is_view`)
_ZERO = {aten._unsafe_view, aten.alias, aten.detach, aten.lift_fresh,
         aten.empty, aten.empty_like}

# writes of a constant: their result
_FILLS = {aten.fill_, aten.zeros, aten.ones, aten.full, aten.zeros_like,
          aten.ones_like, aten.full_like, aten.new_zeros, aten.arange,
          aten.scalar_tensor}

# the data a slicing op moves: its result
_SLICE_READS = {aten.index, aten.index_select, aten.gather, aten.embedding}

# writes: op -> position of the update operand
_WRITES = {aten.index_put_: 2, aten.index_put: 2, aten.scatter: 3,
           aten.scatter_: 3, aten.scatter_add: 3, aten.scatter_add_: 3,
           aten.copy_: 1}

# elementwise ops beyond those tagged pointwise: a dequant chain flows
# through them (hlo_cost's ELEMENTWISE: convert, copy, concatenate)
_ELEMENTWISE = {aten._to_copy, aten.clone, aten.cat, aten.stack}


def _nbytes(t: torch.Tensor) -> float:
    return float(t.numel() * t.element_size())


def _tensors(x) -> list:
    """The tensors of an op's arguments or results (tensors, and lists,
    tuples and dicts of them, one level deep as aten passes them)."""
    if isinstance(x, torch.Tensor):
        return [x]
    out = []
    for a in (x.values() if isinstance(x, dict) else x):
        if isinstance(a, torch.Tensor):
            out.append(a)
        elif isinstance(a, (list, tuple, dict)):
            out.extend(_tensors(a))
    return out


def tensor_leaves(x) -> list:
    """Every tensor in a step's arguments or results: nested dicts,
    lists and tuples, dataclasses (a `DecodeCache`) and quantized weights
    (codes and scales)."""
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, dict):
        return [t for v in x.values() for t in tensor_leaves(v)]
    if isinstance(x, (list, tuple)):
        return [t for v in x for t in tensor_leaves(v)]
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return [t for f in dataclasses.fields(x)
                for t in tensor_leaves(getattr(x, f.name))]
    if hasattr(x, "q") and hasattr(x, "scale"):     # QuantizedWeight
        return tensor_leaves([x.q, x.scale])
    return []


def _storage_key(t: torch.Tensor) -> int:
    return t.untyped_storage()._cdata


def _view_key(t: torch.Tensor):
    return (_storage_key(t), t.storage_offset(), tuple(t.shape),
            tuple(t.stride()), t.dtype)


def _matmul_flops(packet, args, out: torch.Tensor) -> float:
    lhs = args[1] if packet in (aten.addmm, aten.baddbmm) else args[0]
    return 2.0 * out.numel() * lhs.shape[-1]


@dataclasses.dataclass
class CostSummary:
    flops: float = 0.0
    bytes_accessed: float = 0.0
    fusible_bytes: float = 0.0     # attention-intermediate traffic a
    #                                fused kernel keeps on chip
    peak_bytes: float = 0.0        # most bytes allocated at once
    output_bytes: float = 0.0      # the step's results in new storage
    alias_bytes: float = 0.0       # the step's results in its arguments
    ops: int = 0                   # aten ops dispatched

    def to_dict(self):
        return dataclasses.asdict(self)


class OpCounter(TorchDispatchMode):
    """Counts what the ops run under it would cost (see the module
    docstring); `summary` holds the totals."""

    def __init__(self, fusible_last2: Iterable = frozenset()):
        super().__init__()
        self.fusible_last2 = frozenset(tuple(x) for x in fusible_last2)
        self.summary = CostSummary()
        self._live: Dict[int, float] = {}
        self._live_bytes = 0.0
        self._known: set = set()       # storages seen (args or new)
        # storage -> {root view key: bytes}: results of a dequant chain
        self._packed: Dict[int, Dict] = {}

    # -- storages ------------------------------------------------------
    def _freed(self, key: int):
        self._live_bytes -= self._live.pop(key, 0.0)
        self._known.discard(key)
        self._packed.pop(key, None)

    def _note_new(self, t: torch.Tensor):
        key = _storage_key(t)
        if key in self._known:
            return
        self._known.add(key)
        st = t.untyped_storage()
        nb = float(st.nbytes())
        self._live[key] = nb
        self._live_bytes += nb
        self.summary.peak_bytes = max(self.summary.peak_bytes,
                                      self._live_bytes)
        weakref.finalize(st, self._freed, key)

    def mark_known(self, tensors):
        """Storages that exist before the run (the step's arguments)."""
        for t in tensors:
            self._known.add(_storage_key(t))

    # -- ops -----------------------------------------------------------
    def _operand_bytes(self, t: torch.Tensor) -> float:
        roots = self._packed.get(_storage_key(t))
        if roots is None:
            return _nbytes(t)
        return float(sum(roots.values()))     # the packed read

    def _bytes(self, func, kind, args, ins, outs) -> float:
        if kind == "zero":
            return 0.0
        if kind in ("fill", "slice"):
            return sum(_nbytes(t) for t in outs)
        if kind == "write":
            pos = _WRITES[func.overloadpacket]
            upd = args[pos] if len(args) > pos else None
            if isinstance(upd, torch.Tensor):
                return 2.0 * _nbytes(upd)
            idx = next((a for a in args[1:] if isinstance(a, torch.Tensor)),
                       None)       # a scalar scattered at an index
            return 2.0 * (_nbytes(idx) if idx is not None
                          else sum(_nbytes(t) for t in outs))
        if kind == "elementwise":
            keys = [_storage_key(t) for t in ins]
            if any(k in self._packed or t.dtype in _INT_STORAGE
                   for k, t in zip(keys, ins)):
                # a dequant step: free; its consumer reads the roots
                roots: Dict = {}
                for k, t in zip(keys, ins):
                    r = self._packed.get(k)
                    if r is not None:
                        roots.update(r)
                    elif t.numel() > 1:
                        roots[_view_key(t)] = _nbytes(t)
                for t in outs:
                    self._packed.setdefault(_storage_key(t), {}).update(
                        roots)
                return 0.0
        return (sum(self._operand_bytes(t) for t in ins)
                + sum(_nbytes(t) for t in outs))

    def _fusible(self, outs) -> bool:
        return any(t.dim() >= 2 and tuple(t.shape[-2:]) in
                   self.fusible_last2 for t in outs)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        outs = _tensors(out)
        ins = _tensors(args) + _tensors(kwargs)
        s = self.summary
        s.ops += 1
        kind = _kind(func)
        if kind == "matmul":
            s.flops += _matmul_flops(func.overloadpacket, args, outs[0])
        b = self._bytes(func, kind, args, ins, outs)
        if b and self.fusible_last2 and self._fusible(outs):
            s.fusible_bytes += b
        else:
            s.bytes_accessed += b
        # views and in-place results live in their inputs' storage
        if outs:
            in_keys = {_storage_key(t) for t in ins}
            for t in outs:
                if _storage_key(t) not in in_keys:
                    self._note_new(t)
        return out


_KINDS: Dict = {}


def _kind(func) -> str:
    """How an op is costed: matmul, zero, fill, slice, write,
    elementwise or other (cached per overload)."""
    kind = _KINDS.get(func)
    if kind is None:
        packet = func.overloadpacket
        if packet in _MATMULS:
            kind = "matmul"
        elif func.is_view or packet in _ZERO:
            kind = "zero"
        elif packet in _FILLS:
            kind = "fill"
        elif packet in _SLICE_READS:
            kind = "slice"
        elif packet in _WRITES:
            kind = "write"
        elif packet in _ELEMENTWISE or torch.Tag.pointwise in func.tags:
            kind = "elementwise"
        else:
            kind = "other"
        _KINDS[func] = kind
    return kind


def count(fn, *args, fusible_last2=frozenset()) -> CostSummary:
    """Run fn(*args) (meta tensors) under an `OpCounter`; the summary
    also splits the results into new storage (`output_bytes`) and
    storage of the arguments (`alias_bytes`, a donated cache or state
    updated in place)."""
    counter = OpCounter(fusible_last2)
    arg_ts = tensor_leaves(args)
    counter.mark_known(arg_ts)
    arg_keys = {_storage_key(t) for t in arg_ts}
    with counter:
        out = fn(*args)
    s = counter.summary
    for t in tensor_leaves(out):
        if _storage_key(t) in arg_keys:
            s.alias_bytes += _nbytes(t)
        else:
            s.output_bytes += _nbytes(t)
    return s
