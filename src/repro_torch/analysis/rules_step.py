"""TK001 step purity · TK002 stale alias after an in-place step · TK003
build and compile hazards (the counterpart of the reference's
`repro/analysis/rules_jit.py`).

The reference's rules key on `jax.jit` sites; the port's steps are eager
torch functions, so its rules start from `STEP_ROOTS`, one entry (or
more) for each of the reference's jit sites.  TK001 walks the functions
reachable from every root with a fixpoint over which parameters carry a
tensor, and flags each host sync on one; TK002 inspects the call sites
of the roots that write their cache in place; TK003 looks for builds and
compiles anywhere, and in the step's path.

Tensor flow is name-based and flow-insensitive: a root's non-host
parameters carry tensors, a local carries one when any assignment to it
does, a tensor method's result carries one, and a project function's
result carries one when one of its return values does for the
arguments it gets.  Flow stops at a sync that hands back host data
(`.item()`, `.cpu()`, `int(x)` ...), so one sync is one finding, not a
cascade; it goes on through `.nonzero()` and its kin, whose result stays
on the device.  Values held on `self` carry no flow.
"""
from __future__ import annotations

import ast
from typing import Dict, FrozenSet, List, Optional, Set, Tuple

from repro_torch.analysis.callgraph import (FuncInfo, ProjectIndex,
                                            StepRoot, call_candidates,
                                            dotted, map_args_to_params)
from repro_torch.analysis.core import FileCtx, Finding

_ENGINE = "repro_torch/core/engine.py"
_PAGED_KV = "repro_torch/core/paged_kv.py"
_SAMPLER = "repro_torch/serving/sampler.py"

# The reference's 17 `jax.jit` sites (src/repro/<path>:<line>, the line of
# the jit call or of its decorator) and the port's function in each one's
# place.  `host` names the parameters that carry host data (the
# reference's static arguments, and the port's host ints and callables);
# `writes` the ones the step writes in place (the reference donates them).
STEP_ROOTS: Tuple[StepRoot, ...] = (
    StepRoot("serving/scheduler.py:152", _SAMPLER,
             "sample_with_logprobs", host=("true_vocab",)),
    StepRoot("serving/scheduler.py:337", _ENGINE,
             "KVNANDEngine.decode_step", writes=("cache",)),
    StepRoot("serving/scheduler.py:337", "repro_torch/serving/scheduler.py",
             "ContinuousBatcher._sample_dev",
             host=("rows", "positions", "live")),
    StepRoot("serving/scheduler.py:356", _ENGINE,
             "KVNANDEngine.verify_step", host=("accept",),
             writes=("cache",)),
    StepRoot("serving/scheduler.py:356", _SAMPLER,
             "speculative_accept",
             host=("seeds", "positions", "true_vocab", "temperature",
                   "top_k", "top_p")),
    StepRoot("serving/scheduler.py:360", _ENGINE,
             "KVNANDEngine.prefill_chunk",
             host=("slot", "start", "chunk_len", "first"),
             writes=("cache",)),
    StepRoot("serving/scheduler.py:364", _ENGINE,
             "KVNANDEngine.prefill_chunk",
             host=("slot", "start", "chunk_len", "first"),
             writes=("cache",)),
    StepRoot("serving/scheduler.py:453", _PAGED_KV,
             "copy_page_shared", host=("src", "dst"), writes=("pool",)),
    StepRoot("serving/scheduler.py:462", _PAGED_KV,
             "stage_hot_slot", host=("slot",), writes=("cache",)),
    StepRoot("serving/scheduler.py:1354", _ENGINE, "KVNANDEngine.prefill",
             host=("max_context", "prompt_len")),
    StepRoot("serving/scheduler.py:1356", _ENGINE, "KVNANDEngine.prefill",
             host=("max_context", "prompt_len")),
    StepRoot("serving/scheduler.py:1359", _PAGED_KV,
             "splice_slot", host=("i",), writes=("cache",)),
    StepRoot("serving/replica.py:238", _PAGED_KV,
             "import_slot_rows", host=("i", "rows"), writes=("cache",)),
    StepRoot("serving/replica.py:246", _PAGED_KV,
             "stage_hot_slot", host=("slot",), writes=("cache",)),
    StepRoot("launch/steps.py:259", "repro_torch/training/train_step.py",
             "make_train_step.train_step"),
    StepRoot("launch/steps.py:295", "repro_torch/launch/steps.py",
             "build_prefill_cell.prefill_step"),
    StepRoot("launch/steps.py:328", "repro_torch/launch/steps.py",
             "build_decode_cell.serve_step", writes=("cache",)),
    StepRoot("launch/train.py:101", "repro_torch/training/train_step.py",
             "make_train_step.train_step"),
    StepRoot("kernels/flash_attention/ops.py:35",
             "repro_torch/kernels/flash_attention/ops.py", "flash_attention",
             host=("causal", "window", "impl")),
)

# reference jit sites the port has no step for, each with its reason
NO_COUNTERPART: Dict[str, str] = {}

# attribute reads on a tensor that are host metadata
STATIC_ATTRS = {"shape", "ndim", "dtype", "device", "is_cuda", "is_cpu",
                "is_meta", "requires_grad", "layout", "is_sparse", "names",
                "is_leaf", "grad_fn"}
# tensor methods that return host metadata without a sync
STATIC_METHODS = {"size", "dim", "numel", "stride", "is_contiguous",
                  "data_ptr", "element_size", "is_floating_point",
                  "is_complex", "storage_offset", "get_device", "nelement"}
# syncs that hand back host data (the flow stops at them)
HOST_PULLS = {"item", "tolist", "cpu", "numpy"}
# syncs whose result stays on the device: its size depends on the data
SIZE_SYNCS = {"nonzero", "unique", "unique_consecutive", "masked_select",
              "argwhere"}
HOST_CASTS = {"int", "float", "bool"}
NUMPY_PULLS = {"np.asarray", "np.array", "numpy.asarray", "numpy.array"}
UPLOADS = {"torch.as_tensor", "torch.tensor"}
# builtins whose result is host data whatever they are given
_HOST_BUILTINS = {"len", "isinstance", "type", "hasattr", "id", "callable",
                  "str", "repr", "range", "print", "format", "issubclass",
                  "super", *HOST_CASTS}
_COLLECTORS = {"append", "extend", "insert", "add", "update", "appendleft",
               "setdefault"}


def _finding(ctx: FileCtx, node: ast.AST, rule: str, msg: str) -> Finding:
    return Finding(rule, ctx.rel, node.lineno, node.col_offset, msg,
                   ctx.qualname_of(node))


def _names_bound(target: ast.AST) -> Set[str]:
    """Names an assignment target binds, and the container a subscript or
    attribute store writes into (`out[i] = t` makes `out` carry `t`)."""
    out: Set[str] = set()
    for t in ast.walk(target):
        if isinstance(t, ast.Name) and isinstance(t.ctx, ast.Store):
            out.add(t.id)
        elif isinstance(t, (ast.Subscript, ast.Attribute)) \
                and isinstance(t.ctx, ast.Store):
            base = t.value
            while isinstance(base, (ast.Subscript, ast.Attribute)):
                base = base.value
            if isinstance(base, ast.Name) and base.id not in ("self", "cls"):
                out.add(base.id)
    return out


def _is_none_test(node: ast.Compare) -> bool:
    return all(isinstance(op, (ast.Is, ast.IsNot)) for op in node.ops) \
        and all(isinstance(c, ast.Constant) and c.value is None
                for c in node.comparators)


def _cpu_literal(node: ast.AST) -> bool:
    if isinstance(node, ast.Constant):
        return node.value == "cpu"
    return isinstance(node, ast.Call) \
        and dotted(node.func) == "torch.device" and bool(node.args) \
        and _cpu_literal(node.args[0])


def _kw(call: ast.Call, name: str) -> Optional[ast.AST]:
    return next((k.value for k in call.keywords if k.arg == name), None)


def _to_cpu(call: ast.Call) -> bool:
    """`x.to("cpu")` / `x.to(device="cpu")` / `x.to(torch.device("cpu"))`."""
    target = call.args[0] if call.args else _kw(call, "device")
    return target is not None and _cpu_literal(target)


def _non_blocking(call: ast.Call) -> bool:
    v = _kw(call, "non_blocking")
    return isinstance(v, ast.Constant) and v.value is True


def _own_nodes(fn_node: ast.AST):
    """The nodes of a function body, not descending into nested defs."""
    body = fn_node.body if isinstance(fn_node.body, list) \
        else [fn_node.body]
    stack = list(body)
    while stack:
        node = stack.pop()
        yield node
        for child in ast.iter_child_nodes(node):
            if not isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef,
                                      ast.Lambda, ast.ClassDef)):
                stack.append(child)


# ---------------------------------------------------------------------------
# tensor flow
# ---------------------------------------------------------------------------

class TensorFlow:
    """Which names carry a tensor: per function and flowing parameter set,
    its flowing locals (a fixpoint over its bindings), and whether (and
    in which positions of a returned tuple) its return value carries one.

    A parameter annotated as a Python scalar (`int`, `bool`, `float`,
    `str`, or Optional of one) carries none, nor does a field of a project
    class annotated so (`qw.scheme`), nor a C entry's return code."""

    def __init__(self, index: ProjectIndex):
        self.index = index
        self._names: Dict[Tuple[FuncInfo, FrozenSet[str]],
                          FrozenSet[str]] = {}
        self._returns: Dict[Tuple[FuncInfo, FrozenSet[str]], object] = {}
        self._bindings: Dict[FuncInfo, list] = {}
        self.host_fields = _host_fields(index)
        self._scalar_params: Dict[FuncInfo, Set[str]] = {}

    def scalar_params(self, fn: FuncInfo) -> Set[str]:
        got = self._scalar_params.get(fn)
        if got is None:
            a = fn.node.args
            got = self._scalar_params[fn] = {
                p.arg for p in [*getattr(a, "posonlyargs", []), *a.args,
                                *a.kwonlyargs]
                if p.annotation is not None and _scalar(p.annotation)}
        return got

    def flows(self, fn: FuncInfo, expr: ast.AST, names: Set[str]) -> bool:
        """Whether `expr`, in `fn` with flowing `names`, carries a tensor."""
        return _truthy(self.shape(fn, expr, names))

    def shape(self, fn: FuncInfo, expr: ast.AST, names: Set[str]):
        """`expr`'s flow: a bool, or for a tuple a pair (per-position
        shapes, the shape of positions past them)."""
        ctx = fn.ctx

        def visit(node: ast.AST) -> bool:
            return _truthy(shape(node))

        def shape(node: ast.AST):
            if isinstance(node, ast.Name):
                return node.id in names
            if isinstance(node, (ast.Tuple, ast.List)) and not any(
                    isinstance(e, ast.Starred) for e in node.elts):
                return ([shape(e) for e in node.elts], False)
            if isinstance(node, ast.BinOp) and isinstance(node.op, ast.Add) \
                    and isinstance(node.left, ast.Tuple):
                head = shape(node.left)
                if isinstance(head, tuple):
                    return (head[0], visit(node.right))
            if isinstance(node, ast.Attribute):
                return node.attr not in STATIC_ATTRS \
                    and node.attr not in self.host_fields \
                    and visit(node.value)
            if isinstance(node, ast.Subscript):
                return visit(node.value)
            if isinstance(node, (ast.Constant, ast.JoinedStr, ast.Lambda)):
                return False
            if isinstance(node, ast.Compare) and (
                    _is_none_test(node) or all(
                        isinstance(op, (ast.In, ast.NotIn))
                        for op in node.ops)):
                return False
            if isinstance(node, ast.IfExp):
                return visit(node.body) or visit(node.orelse)
            if isinstance(node, (ast.ListComp, ast.SetComp,
                                 ast.GeneratorExp)):
                return visit(node.elt)
            if isinstance(node, ast.DictComp):
                return visit(node.value)
            if isinstance(node, ast.Call):
                return call(node)
            return any(visit(c) for c in ast.iter_child_nodes(node))

        def call(node: ast.Call):
            f = node.func
            d = dotted(f)
            if isinstance(f, ast.Name) and f.id in _HOST_BUILTINS:
                return False
            if d is not None and d.split(".")[0] in ("np", "numpy", "math"):
                return False
            if isinstance(f, ast.Call) and (dotted(f.func) or "") \
                    .rsplit(".", 1)[-1] == "entry":
                return False                # a C entry's return code
            if isinstance(f, ast.Attribute):
                if f.attr in STATIC_METHODS or f.attr in HOST_PULLS \
                        or (f.attr == "to" and _to_cpu(node)):
                    return False
                if visit(f.value):
                    return True             # a torch op on a tensor
            cands = call_candidates(self.index, ctx, node)
            if cands:
                via_attr = isinstance(f, ast.Attribute)
                return _merge([self.return_shape(c, frozenset(
                    p for p, a in map_args_to_params(node, c, via_attr)
                    if visit(a))) for c in cands])
            return any(visit(a) for a in node.args) or any(
                visit(k.value) for k in node.keywords)

        return shape(expr)

    def iter_shape(self, fn: FuncInfo, expr: ast.AST, names: Set[str]):
        """The flow of one element of the iterable `expr`."""
        if isinstance(expr, ast.Call) and isinstance(expr.func, ast.Name) \
                and expr.args and not expr.keywords:
            if expr.func.id == "enumerate" and len(expr.args) == 1:
                return ([False, self.iter_shape(fn, expr.args[0], names)],
                        False)
            if expr.func.id == "zip":
                return ([self.iter_shape(fn, a, names) for a in expr.args],
                        False)
        return self.flows(fn, expr, names)

    def _binding_sites(self, fn: FuncInfo) -> list:
        """(target, value, kind) for every binding in `fn`, nested defs
        included: assignments, loop and comprehension targets ("iter"),
        `with ... as`, and `xs.append(v)`-style collection into a
        container ("collect")."""
        sites = self._bindings.get(fn)
        if sites is not None:
            return sites
        sites = []
        for node in ast.walk(fn.node):
            if isinstance(node, ast.Assign):
                sites += [(t, node.value, "assign") for t in node.targets]
            elif isinstance(node, (ast.AugAssign, ast.AnnAssign)) \
                    and node.value is not None:
                sites.append((node.target, node.value, "assign"))
            elif isinstance(node, (ast.For, ast.AsyncFor, ast.comprehension)):
                sites.append((node.target, node.iter, "iter"))
            elif isinstance(node, ast.withitem) \
                    and node.optional_vars is not None:
                sites.append((node.optional_vars, node.context_expr,
                              "assign"))
            elif isinstance(node, ast.NamedExpr):
                sites.append((node.target, node.value, "assign"))
            elif isinstance(node, ast.Call) \
                    and isinstance(node.func, ast.Attribute) \
                    and node.func.attr in _COLLECTORS \
                    and isinstance(node.func.value, ast.Name) \
                    and node.func.value.id not in ("self", "cls"):
                for a in [*node.args, *(k.value for k in node.keywords)]:
                    sites.append((node.func.value, a, "collect"))
        self._bindings[fn] = sites
        return sites

    def names(self, fn: FuncInfo, params: FrozenSet[str]) -> FrozenSet[str]:
        """The names of `fn` that carry a tensor when `params` do."""
        params = params - self.scalar_params(fn)
        key = (fn, params)
        got = self._names.get(key)
        if got is not None:
            return got
        self._names[key] = params           # recursion guard
        flowing = set(params)
        host = self.scalar_params(fn)
        sites = self._binding_sites(fn)
        changed = True
        while changed:
            changed = False
            for target, value, kind in sites:
                if kind == "collect":
                    bound = {target.id} if self.flows(fn, value, flowing) \
                        else set()
                else:
                    bound = _bind(target, self.iter_shape(
                        fn, value, flowing) if kind == "iter"
                        else self.shape(fn, value, flowing))
                bound -= host
                if not bound <= flowing:
                    flowing |= bound
                    changed = True
        got = frozenset(flowing)
        self._names[key] = got
        return got

    def return_shape(self, fn: FuncInfo, params: FrozenSet[str]):
        """The flow of `fn`'s return value when `params` carry tensors."""
        key = (fn, params)
        if key in self._returns:
            return self._returns[key]
        self._returns[key] = False          # recursion guard
        names = set(self.names(fn, params))
        if isinstance(fn.node, ast.Lambda):
            got = self.shape(fn, fn.node.body, names)
        else:
            got = _merge([self.shape(fn, n.value, names)
                          for n in _own_nodes(fn.node)
                          if isinstance(n, ast.Return)
                          and n.value is not None])
        self._returns[key] = got
        return got

    def project_calls(self, fn: FuncInfo, call: ast.Call,
                      names: Set[str]) -> List[FuncInfo]:
        """The project functions `call` may reach (none for a torch op on
        a tensor: a method called on one)."""
        if isinstance(call.func, ast.Attribute) \
                and self.flows(fn, call.func.value, names):
            return []
        return call_candidates(self.index, fn.ctx, call)


_SCALARS = {"int", "bool", "float", "str"}
_CONTAINERS = {"Optional", "Tuple", "tuple", "List", "list", "Sequence",
               "FrozenSet", "Set", "Dict", "dict"}


def _scalar(ann: ast.AST) -> bool:
    """An annotation naming host data: a Python scalar, or Optional of
    one, or a tuple / list / set / dict of them."""
    if isinstance(ann, ast.Constant) and isinstance(ann.value, str):
        try:
            ann = ast.parse(ann.value, mode="eval").body
        except SyntaxError:
            return False
    if isinstance(ann, ast.Name):
        return ann.id in _SCALARS
    if isinstance(ann, ast.Subscript) and (dotted(ann.value) or "") \
            .rsplit(".", 1)[-1] in _CONTAINERS:
        args = ann.slice.elts if isinstance(ann.slice, ast.Tuple) \
            else [ann.slice]
        return all(_scalar(a) or (isinstance(a, ast.Constant)
                                  and a.value is Ellipsis) for a in args)
    return False


def _host_fields(index: ProjectIndex) -> Set[str]:
    """Attribute names that every project class declaring them declares
    host data: a class-level annotation (dataclass fields), or in
    `__init__` a `self.x = x` of a parameter annotated so."""
    kinds: Dict[str, Set[bool]] = {}
    for ctx in index.ctxs:
        for cls in ast.walk(ctx.tree):
            if not isinstance(cls, ast.ClassDef):
                continue
            for st in cls.body:
                if isinstance(st, ast.AnnAssign) \
                        and isinstance(st.target, ast.Name):
                    kinds.setdefault(st.target.id, set()).add(
                        _scalar(st.annotation))
                if not (isinstance(st, ast.FunctionDef)
                        and st.name == "__init__"):
                    continue
                a = st.args
                anns = {p.arg: p.annotation for p in [*a.args, *a.kwonlyargs]}
                for n in ast.walk(st):
                    if not isinstance(n, ast.Assign):
                        continue
                    for t in n.targets:
                        if isinstance(t, ast.Attribute) \
                                and dotted(t.value) == "self":
                            v = n.value
                            ann = anns.get(v.id) \
                                if isinstance(v, ast.Name) else None
                            kinds.setdefault(t.attr, set()).add(
                                ann is not None and _scalar(ann))
    return {name for name, k in kinds.items() if k == {True}}


def _truthy(shape) -> bool:
    if isinstance(shape, tuple):
        return any(_truthy(s) for s in shape[0]) or shape[1]
    return bool(shape)


def _merge(shapes: list):
    """The flow of a value that may be any of `shapes` (positions merge
    where every shape is a tuple of the same width)."""
    if not shapes:
        return False
    if all(isinstance(s, tuple) for s in shapes) \
            and len({len(s[0]) for s in shapes}) == 1:
        return ([_merge(list(col)) for col in zip(*(s[0] for s in shapes))],
                any(s[1] for s in shapes))
    return any(_truthy(s) for s in shapes)


def _bind(target: ast.AST, shape) -> Set[str]:
    """The names `target` binds to a flowing value, given the value's
    flow (a tuple target takes its flow position by position)."""
    if isinstance(target, (ast.Tuple, ast.List)) and isinstance(shape,
                                                                tuple):
        out: Set[str] = set()
        heads, rest = shape
        for i, el in enumerate(target.elts):
            if isinstance(el, ast.Starred):
                if rest or any(_truthy(h) for h in heads[i:]):
                    out |= _names_bound(el.value)
                continue
            out |= _bind(el, heads[i] if i < len(heads) else rest)
        return out
    return _names_bound(target) if _truthy(shape) else set()


def propagate_flow(index: ProjectIndex, flow: TensorFlow
                   ) -> Dict[FuncInfo, Set[str]]:
    """Map every function reachable from a step root to the set of its
    parameters that can carry a tensor (flow over call edges until
    fixpoint)."""
    reached: Dict[FuncInfo, Set[str]] = {}
    work: List[FuncInfo] = []

    def absorb(fn: FuncInfo, names: FrozenSet[str]):
        cur = reached.get(fn)
        if cur is None:
            reached[fn] = set(names)
            work.append(fn)
        elif not names <= cur:
            cur |= names
            work.append(fn)

    for root, fn in index.roots:
        absorb(fn, frozenset(p for p in fn.callable_params
                             if p not in root.host))
    while work:
        fn = work.pop()
        names = set(flow.names(fn, frozenset(reached[fn])))
        for node in ast.walk(fn.node):
            if not isinstance(node, ast.Call):
                continue
            via_attr = isinstance(node.func, ast.Attribute)
            for cand in flow.project_calls(fn, node, names):
                hot = frozenset(p for p, arg in map_args_to_params(
                    node, cand, via_attr) if flow.flows(fn, arg, names))
                absorb(cand, hot)
    return reached


# ---------------------------------------------------------------------------
# TK001 — no host sync in the step
# ---------------------------------------------------------------------------

def _upload(call: ast.Call, d: Optional[str]) -> bool:
    """`torch.as_tensor(host, device=d)` and kin: a copy from pageable
    host memory, which waits for the stream (unless `non_blocking=True`)."""
    if _non_blocking(call):
        return False
    if d in UPLOADS:
        dev = _kw(call, "device")
        return dev is not None and not _cpu_literal(dev)
    f = call.func
    if isinstance(f, ast.Attribute) and f.attr in ("to", "cuda") \
            and isinstance(f.value, ast.Call) \
            and dotted(f.value.func) in (*UPLOADS, "torch.from_numpy") \
            and _kw(f.value, "device") is None:
        return f.attr == "cuda" or not _to_cpu(call)
    return False


def _scan_purity(flow: TensorFlow, fn: FuncInfo, params: Set[str],
                 out: List[Finding]):
    ctx = fn.ctx
    top = set(flow.names(fn, frozenset(params)))

    def hit(node, msg):
        out.append(_finding(ctx, node, "TK001", msg))

    def scan(node: ast.AST, names: Set[str]):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.Lambda)) and node is not fn.node:
            # nested function: its own params shadow
            inner = names - set(
                p.arg for p in list(node.args.args)
                + list(node.args.kwonlyargs)
                + list(getattr(node.args, "posonlyargs", [])))
            for child in ast.iter_child_nodes(node):
                scan(child, inner)
            return
        flows = lambda e: flow.flows(fn, e, names)  # noqa: E731
        if isinstance(node, ast.Call):
            f = node.func
            d = dotted(f)
            attr = f.attr if isinstance(f, ast.Attribute) else None
            if attr in HOST_PULLS and flows(f.value):
                hit(node, f"`.{attr}()` on a tensor in the step syncs the "
                    "host with the card — keep the value on the device or "
                    "move the read to the host caller")
            elif attr == "to" and _to_cpu(node) and flows(f.value):
                hit(node, "`.to('cpu')` on a tensor in the step syncs the "
                    "host with the card")
            elif attr in SIZE_SYNCS and flows(f.value):
                hit(node, f"`.{attr}()` in the step: its output size "
                    "depends on the data, so the host waits for the card "
                    "— use a fixed-size mask instead")
            elif d in {f"torch.{s}" for s in SIZE_SYNCS} and any(
                    flows(a) for a in node.args):
                hit(node, f"`{d}` in the step: its output size depends on "
                    "the data, so the host waits for the card")
            elif d == "torch.where" and len(node.args) == 1 \
                    and flows(node.args[0]):
                hit(node, "one-argument `torch.where` is `nonzero`: the "
                    "host waits for the card")
            elif attr == "synchronize":
                hit(node, "`synchronize()` reached from a step root blocks "
                    "the host on the card")
            elif d == "print":
                hit(node, "`print` in the step — a tensor argument syncs, "
                    "and a step prints nothing")
            elif d in NUMPY_PULLS and any(flows(a) for a in node.args):
                hit(node, f"`{d}` on a tensor copies it to the host, "
                    "waiting for the card")
            elif isinstance(f, ast.Name) and f.id in HOST_CASTS \
                    and node.args and flows(node.args[0]):
                hit(node, f"`{f.id}()` on a tensor reads it on the host, "
                    "waiting for the card — keep the computation in torch")
            elif _upload(node, d) and not any(flows(a) for a in node.args):
                hit(node, "an upload from pageable host memory waits for "
                    "the stream — upload through `paged_kv.host_to_device` "
                    "(a pinned snapshot, non-blocking)")
        elif isinstance(node, (ast.If, ast.While, ast.IfExp, ast.Assert)):
            if flow.flows(fn, node.test, names):
                kind = {ast.If: "if", ast.While: "while", ast.IfExp: "if",
                        ast.Assert: "assert"}[type(node)]
                hit(node, f"Python `{kind}` on a tensor reads it on the "
                    "host, waiting for the card — use torch.where or a "
                    "mask, or decide on host data")
        for child in ast.iter_child_nodes(node):
            scan(child, names)

    body = fn.node.body if isinstance(fn.node.body, list) \
        else [fn.node.body]
    for stmt in body:
        scan(stmt, top)


# ---------------------------------------------------------------------------
# TK002 — a stale alias of the cache after an in-place step
# ---------------------------------------------------------------------------

def _targets_of(stmt: ast.AST) -> Set[str]:
    """Names (re)bound by an assignment statement."""
    targets: List[ast.AST] = []
    if isinstance(stmt, ast.Assign):
        targets = list(stmt.targets)
    elif isinstance(stmt, (ast.AugAssign, ast.AnnAssign, ast.For)):
        targets = [stmt.target]
    return {t.id for tgt in targets for t in ast.walk(tgt)
            if isinstance(t, ast.Name) and isinstance(t.ctx, ast.Store)}


def _loads_in(node: ast.AST, name: str) -> List[ast.AST]:
    return [n for n in ast.walk(node) if isinstance(n, ast.Name)
            and n.id == name and isinstance(n.ctx, ast.Load)]


def _stmt_sequence_after(ctx: FileCtx, stmt: ast.AST,
                         stop: ast.AST) -> List[Tuple[str, ast.AST]]:
    """Statements that may execute after `stmt` inside `stop` (the
    enclosing function): later siblings at each nesting level walking
    outward, plus a loop re-entry pass for enclosing loops."""
    seq: List[Tuple[str, ast.AST]] = []
    child = stmt
    parent = ctx.parents.get(child)
    while parent is not None and child is not stop:
        for field in ("body", "orelse", "finalbody"):
            block = getattr(parent, field, None)
            if isinstance(block, list) and child in block:
                idx = block.index(child)
                for later in block[idx + 1:]:
                    seq.append(("after", later))
                if isinstance(parent, (ast.For, ast.While)) \
                        and field == "body":
                    for earlier in block[:idx + 1]:
                        seq.append(("reentry", earlier))
        child = parent
        parent = ctx.parents.get(child)
    return seq


def _aliases(value: ast.AST, sym: str) -> bool:
    """`value` is `sym`, one of its leaves or a view into one (a slice):
    not a copy (`.clone()`, or any other call but `getattr(sym, ...)`)."""
    while isinstance(value, ast.Subscript):
        value = value.value
    if isinstance(value, ast.Call):
        return dotted(value.func) == "getattr" and bool(value.args) \
            and dotted(value.args[0]) == sym
    d = dotted(value)
    return d is not None and (d == sym or d.startswith(sym + "."))


def _check_stale_alias(index: ProjectIndex, ctx: FileCtx, call: ast.Call,
                       root: StepRoot, fn: FuncInfo, out: List[Finding]):
    caller = index.enclosing_func(ctx, call)
    if caller is None:
        return
    stmt = index.enclosing_stmt(ctx, call)
    rebound_here = _targets_of(stmt)
    via_attr = isinstance(call.func, ast.Attribute)
    for pname, arg in map_args_to_params(call, fn, via_attr):
        if pname not in root.writes:
            continue
        sym = dotted(arg)
        if sym is None:
            continue
        # the last binding of each local before the call
        last: Dict[str, ast.Assign] = {}
        for node in ast.walk(caller.node):
            if isinstance(node, ast.Assign) and node.lineno < stmt.lineno:
                for name in _targets_of(node):
                    prev = last.get(name)
                    if prev is None or prev.lineno < node.lineno:
                        last[name] = node
        for name, bind in sorted(last.items()):
            if name in rebound_here or name == sym.split(".")[0] \
                    or not _aliases(bind.value, sym):
                continue
            for phase, later in _stmt_sequence_after(ctx, stmt,
                                                     caller.node):
                if phase == "reentry" and later is stmt:
                    break
                loads = _loads_in(later, name)
                if loads:
                    out.append(_finding(
                        ctx, loads[0], "TK002",
                        f"`{name}` aliases `{sym}`, which the step "
                        f"`{fn.name}` at line {call.lineno} writes in "
                        "place, and is read again here — it may no longer "
                        "hold what it held; read from the step's result "
                        "or take a `.clone()`"))
                    break
                if name in _targets_of(later):
                    break


# ---------------------------------------------------------------------------
# TK003 — builds and compiles
# ---------------------------------------------------------------------------

BUILD_FILE = "kernels/_build.py"
_COMPILERS = {"torch.compile", "torch.jit.script", "torch.jit.trace",
              "ctypes.CDLL", "ctypes.cdll.LoadLibrary"}


def _builder(d: Optional[str]) -> Optional[str]:
    """What `d` (a called or decorating name) builds, or None."""
    if d is None:
        return None
    if d in _COMPILERS:
        return f"`{d}`"
    if "cpp_extension.load" in d:
        return "`torch.utils.cpp_extension`"
    if d.startswith("subprocess."):
        return f"`{d}`"
    return None


def _in_loop(ctx: FileCtx, node: ast.AST) -> bool:
    cur = ctx.parents.get(node)
    while cur is not None and not isinstance(
            cur, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)):
        if isinstance(cur, (ast.For, ast.While, ast.AsyncFor)):
            return True
        cur = ctx.parents.get(cur)
    return False


def _check_builds(index: ProjectIndex, reached: Set[FuncInfo],
                  out: List[Finding]):
    for ctx in index.ctxs:
        in_build = ctx.rel.endswith(BUILD_FILE)
        for node in ast.walk(ctx.tree):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                for dec in node.decorator_list:
                    what = _builder(dotted(dec.func if isinstance(
                        dec, ast.Call) else dec))
                    if what is not None and not in_build:
                        out.append(_finding(
                            ctx, dec, "TK003",
                            f"{what} outside {BUILD_FILE} — the port's "
                            "kernels are built in one place, from the "
                            "checkout's sources"))
            if not isinstance(node, ast.Call):
                continue
            d = dotted(node.func)
            what = _builder(d)
            if what is not None and not in_build:
                out.append(_finding(
                    ctx, node, "TK003",
                    f"{what} outside {BUILD_FILE} — the port builds and "
                    "loads its kernels there only, and compiles nothing "
                    "else"))
            heavy = None
            if d in ("torch.cuda.CUDAGraph", "torch.compile"):
                heavy = f"`{d}`"
            elif d is not None and d.rsplit(".", 1)[-1] == "build" and any(
                    c.ctx.rel.endswith(BUILD_FILE)
                    for c in index.resolve(d, ctx, scope=node)):
                heavy = "the kernel build"
            if heavy is None:
                continue
            fn = index.enclosing_func(ctx, node)
            if _in_loop(ctx, node):
                out.append(_finding(
                    ctx, node, "TK003",
                    f"{heavy} inside a loop builds (or captures) again "
                    "every iteration — hoist it out"))
            elif fn is not None and fn in reached:
                out.append(_finding(
                    ctx, node, "TK003",
                    f"{heavy} in a function reachable from a step root: "
                    "the step would build (or capture) on its path — do "
                    "it once, before the first step"))


# ---------------------------------------------------------------------------
# entry point
# ---------------------------------------------------------------------------

def check(index: ProjectIndex, selected: Set[str]) -> List[Finding]:
    findings: List[Finding] = []
    flow = TensorFlow(index)
    reached = propagate_flow(index, flow) \
        if selected & {"TK001", "TK003"} else {}
    if "TK001" in selected:
        purity: List[Finding] = []
        for fn, params in reached.items():
            _scan_purity(flow, fn, params, purity)
        seen = set()
        for f in purity:
            k = (f.path, f.line, f.col, f.message)
            if k not in seen:
                seen.add(k)
                findings.append(f)
    if "TK002" in selected:
        writers = {fn: r for r, fn in index.roots if r.writes}
        for ctx in index.ctxs:
            for node in ast.walk(ctx.tree):
                if not isinstance(node, ast.Call):
                    continue
                cands = call_candidates(index, ctx, node)
                for fn, r in writers.items():
                    if fn in cands:
                        _check_stale_alias(index, ctx, node, r, fn,
                                           findings)
    if "TK003" in selected:
        _check_builds(index, set(reached), findings)
    return findings
