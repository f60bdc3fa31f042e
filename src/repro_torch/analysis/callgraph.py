"""Project index + step-root call graph for the port's kvlint rules (the
counterpart of the reference's `repro/analysis/callgraph.py`, with step
roots in place of jit sites).

Name-based, flow-insensitive resolution tuned to the port's idioms:

  * plain-name calls resolve within the defining file, then through
    explicit ``from module import name`` imports;
  * ``alias.func(...)`` resolves through module aliases
    (``from repro_torch.core import paged_kv``  →  ``paged_kv.fill_layer``);
  * ``self.method(...)`` resolves in the enclosing class first, then to
    any same-named method project-wide (``self.engine.decode_step`` has
    no type information — method-name matching over-approximates, which
    is the safe direction for reachability).

The port has no jit boundary: its steps are eager torch functions.  A
step root (`StepRoot`, listed in ``rules_step.STEP_ROOTS``) names the
function that stands where the reference's ``jax.jit`` site stands, its
host (static) parameters, and the parameters it writes in place (where
the reference donates).
"""
from __future__ import annotations

import ast
import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.analysis.core import FileCtx

# aliases that are never project modules — attribute calls on these are
# external and must not resolve by bare method name
EXTERNAL_BASES = {
    "torch", "F", "nn", "np", "numpy", "einops", "functools",
    "dataclasses", "math", "os", "sys", "time", "json", "re", "ast",
    "pytest", "hypothesis", "itertools", "collections", "asyncio",
    "logging", "struct", "random", "string", "textwrap", "threading",
    "ctypes", "subprocess", "shutil", "tempfile", "hashlib", "warnings",
    "traceback", "contextlib", "pathlib", "Path", "operator", "copy",
    "queue", "socket", "signal", "statistics",
}


@dataclasses.dataclass(frozen=True)
class StepRoot:
    """One of the port's step functions, standing where the reference has
    the `jax.jit` site `reference` ("path:line" in `src/repro`)."""
    reference: str
    path: str                      # the port's file, e.g. "core/engine.py"
    qualname: str                  # e.g. "KVNANDEngine.decode_step"
    host: Tuple[str, ...] = ()     # parameters that carry host data
    writes: Tuple[str, ...] = ()   # parameters written in place

    def matches(self, rel: str) -> bool:
        return rel == self.path or rel.endswith("/" + self.path)


def dotted(node: ast.AST) -> Optional[str]:
    """'a.b.c' for Name/Attribute chains, else None."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


@dataclasses.dataclass(eq=False)   # identity hashing: one entry per def
class FuncInfo:
    qualname: str
    node: ast.AST                     # FunctionDef / AsyncFunctionDef / Lambda
    ctx: FileCtx
    params: List[str]
    is_method: bool
    class_name: Optional[str]

    @property
    def name(self) -> str:
        return self.qualname.rsplit(".", 1)[-1]

    @property
    def callable_params(self) -> List[str]:
        return self.params[1:] if self.is_method else self.params


def _param_names(node: ast.AST) -> List[str]:
    a = node.args
    names = [p.arg for p in getattr(a, "posonlyargs", [])]
    names += [p.arg for p in a.args]
    names += [p.arg for p in a.kwonlyargs]
    return names


class ProjectIndex:
    def __init__(self, ctxs: Sequence[FileCtx],
                 step_roots: Sequence[StepRoot] = ()):
        self.ctxs = list(ctxs)
        self.funcs: List[FuncInfo] = []
        self.by_name: Dict[str, List[FuncInfo]] = {}
        self.by_node: Dict[ast.AST, FuncInfo] = {}
        # per-file: alias -> dotted module ("paged_kv" ->
        # "repro_torch.core.paged_kv")
        self.mod_aliases: Dict[str, Dict[str, str]] = {}
        # per-file: name -> (module, original name) from `from m import n`
        self.from_imports: Dict[str, Dict[str, Tuple[str, str]]] = {}
        self.module_of: Dict[str, str] = {}      # rel path -> module name
        for ctx in self.ctxs:
            self._index_file(ctx)
        # the step roots found among the files, each with its function
        self.roots: List[Tuple[StepRoot, FuncInfo]] = [
            (r, f) for r in step_roots for f in self.funcs
            if f.qualname == r.qualname and r.matches(f.ctx.rel)]

    # -- indexing ------------------------------------------------------
    def _index_file(self, ctx: FileCtx):
        rel = ctx.rel
        mod = rel[:-3].replace("/", ".")
        for prefix in ("src.",):
            if mod.startswith(prefix):
                mod = mod[len(prefix):]
        if mod.endswith(".__init__"):
            mod = mod[: -len(".__init__")]
        self.module_of[rel] = mod
        aliases: Dict[str, str] = {}
        froms: Dict[str, Tuple[str, str]] = {}
        for node in ast.walk(ctx.tree):
            if isinstance(node, ast.Import):
                for al in node.names:
                    aliases[al.asname or al.name.split(".")[0]] = al.name
            elif isinstance(node, ast.ImportFrom) and node.module:
                for al in node.names:
                    froms[al.asname or al.name] = (node.module, al.name)
                    # `from repro_torch.core import paged_kv` imports a
                    # MODULE
                    aliases.setdefault(al.asname or al.name,
                                       f"{node.module}.{al.name}")
            elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                self._add_func(ctx, node)
        self.mod_aliases[rel] = aliases
        self.from_imports[rel] = froms

    def _add_func(self, ctx: FileCtx, node: ast.AST) -> FuncInfo:
        info = self.by_node.get(node)
        if info is not None:
            return info
        qual = ctx.qualname_of(node)
        cls = None
        parent = ctx.parents.get(node)
        if isinstance(parent, ast.ClassDef):
            cls = parent.name
        params = _param_names(node)
        is_method = cls is not None and bool(params) \
            and params[0] in ("self", "cls")
        info = FuncInfo(qual, node, ctx, params, is_method, cls)
        self.funcs.append(info)
        self.by_node[node] = info
        self.by_name.setdefault(info.name, []).append(info)
        return info

    # -- structural helpers --------------------------------------------
    def enclosing_stmt(self, ctx: FileCtx, node: ast.AST) -> ast.AST:
        cur = node
        while cur in ctx.parents and not isinstance(cur, ast.stmt):
            cur = ctx.parents[cur]
        return cur

    def enclosing_func(self, ctx: FileCtx,
                       node: ast.AST) -> Optional[FuncInfo]:
        cur: Optional[ast.AST] = ctx.parents.get(node)
        while cur is not None:
            if isinstance(cur, (ast.FunctionDef, ast.AsyncFunctionDef)):
                return self.by_node.get(cur)
            cur = ctx.parents.get(cur)
        return None

    def _enclosing_class(self, ctx: FileCtx,
                         node: ast.AST) -> Optional[str]:
        cur: Optional[ast.AST] = ctx.parents.get(node)
        while cur is not None:
            if isinstance(cur, ast.ClassDef):
                return cur.name
            cur = ctx.parents.get(cur)
        return None

    # -- call resolution -----------------------------------------------
    def resolve(self, name: str, ctx: FileCtx,
                scope: Optional[ast.AST] = None) -> List[FuncInfo]:
        """Candidate FuncInfos for a call spelled `name` in `ctx`."""
        parts = name.split(".")
        last = parts[-1]
        if len(parts) == 1:
            local = [f for f in self.by_name.get(last, ())
                     if f.ctx is ctx]
            if local:
                return local
            imp = self.from_imports.get(ctx.rel, {}).get(last)
            if imp is not None:
                mod, orig = imp
                # exact module match, or a package __init__ re-export
                # (def lives in a submodule of the imported package)
                return [f for f in self.by_name.get(orig, ())
                        if (self.module_of.get(f.ctx.rel) == mod
                            or self.module_of.get(f.ctx.rel, "")
                            .startswith(mod + "."))
                        and "." not in f.qualname]
            return []
        base = parts[0]
        if len(parts) == 2 and base not in ("self", "cls"):
            alias = self.mod_aliases.get(ctx.rel, {}).get(base)
            if alias is not None:
                hits = [f for f in self.by_name.get(last, ())
                        if self.module_of.get(f.ctx.rel) == alias
                        and "." not in f.qualname]
                if hits:
                    return hits
            if base in EXTERNAL_BASES:
                return []
        if base in EXTERNAL_BASES:
            return []
        if base in ("self", "cls") and len(parts) == 2:
            cls = self._enclosing_class(ctx, scope) if scope is not None \
                else None
            if cls is not None:
                own = [f for f in self.by_name.get(last, ())
                       if f.class_name == cls]
                if own:
                    return own
        # attribute call on an object of unknown type: every same-named
        # METHOD in the project (over-approximate reachability)
        return [f for f in self.by_name.get(last, ())
                if f.class_name is not None or base in ("self", "cls")]


def call_candidates(index: ProjectIndex, ctx: FileCtx,
                    call: ast.Call) -> List[FuncInfo]:
    d = dotted(call.func)
    if d is None:
        return []
    return index.resolve(d, ctx, scope=call)


def map_args_to_params(call: ast.Call, fn: FuncInfo,
                       via_attribute: bool) -> List[Tuple[str, ast.AST]]:
    """(param name, arg expr) pairs for a call site; bound-method calls
    (`obj.m(...)`) skip the receiver slot."""
    params = fn.callable_params if (fn.is_method and via_attribute) \
        else fn.params
    out: List[Tuple[str, ast.AST]] = []
    for i, arg in enumerate(call.args):
        if isinstance(arg, ast.Starred):
            break
        if i < len(params):
            out.append((params[i], arg))
    for kw in call.keywords:
        if kw.arg is not None and kw.arg in fn.params:
            out.append((kw.arg, kw.value))
    return out
