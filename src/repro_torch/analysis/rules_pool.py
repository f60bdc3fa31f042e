"""TK004 — pool-write discipline (the counterpart of the reference's
`repro/analysis/rules_pool.py`).

Every in-place write into a KV pool leaf must go through the writer
family in ``core/paged_kv.py`` (the drop-gated appends, chunk fills,
span writers, page copies, tier staging and slot splices).  The port
writes its pools in place by torch idioms the reference's KV004 cannot
see: subscript assignment (``pool[b, :, p, s] = new``), the in-place
methods (``index_put_``, ``copy_``, ``scatter_``, ``fill_`` ...) and
in-place arithmetic (``pool += x``).  Any of them on a pool leaf in any
other module is a finding.
"""
from __future__ import annotations

import ast
from typing import Dict, List, Optional

from repro_torch.analysis.callgraph import ProjectIndex, dotted
from repro_torch.analysis.core import FileCtx, Finding

# the KV pool data / scale / page-table leaves of DecodeCache (the
# reference's `POOL_LEAVES`: ring position rows `page_pos_w` and `lengths`
# are engine-owned metadata, not KV bytes, and stay out of scope)
POOL_LEAVES = {
    "k_pages", "v_pages", "k_scale", "v_scale",
    "k_pages_g", "v_pages_g", "k_scale_g", "v_scale_g",
    "k_pages_w", "v_pages_w", "k_scale_w", "v_scale_w",
    "page_table_g", "page_table_w",
}
# parameter names that conventionally carry a pool leaf in this repo
POOLISH_PARAMS = {"pool", "pools", "k_pages", "v_pages", "cache"}
ALLOWED_FILES = ("core/paged_kv.py",)

# torch's in-place writers (a trailing underscore)
IN_PLACE_METHODS = {
    "index_put_", "index_copy_", "index_fill_", "index_add_", "copy_",
    "scatter_", "scatter_add_", "scatter_reduce_", "masked_scatter_",
    "masked_fill_", "fill_", "zero_", "put_", "add_", "sub_", "mul_",
    "div_", "clamp_",
}


def _leafish(ctx: FileCtx, expr: ast.AST,
             fn_node: Optional[ast.AST]) -> Optional[str]:
    """Why `expr` denotes a pool leaf, or None.

    Catches: `cache.k_pages_g`, a local assigned from such an attribute,
    a local assigned from `getattr(cache_like, ...)` (the generic
    all-leaf writer idiom), and parameters named like a pool.
    """
    if isinstance(expr, ast.Attribute) and expr.attr in POOL_LEAVES:
        return f"cache leaf `.{expr.attr}`"
    if isinstance(expr, ast.Name):
        if fn_node is not None:
            args = fn_node.args
            params = {p.arg for p in list(args.args)
                      + list(args.kwonlyargs)
                      + list(getattr(args, "posonlyargs", []))}
            if expr.id in params and expr.id in POOLISH_PARAMS:
                return f"pool-carrying parameter `{expr.id}`"
            scope = fn_node
        else:
            scope = ctx.tree
        for node in ast.walk(scope):
            if isinstance(node, ast.Assign):
                targets, value = node.targets, node.value
            elif isinstance(node, ast.For):
                targets, value = [node.target], node.iter
            else:
                continue
            stores = {t.id for tgt in targets for t in ast.walk(tgt)
                      if isinstance(t, ast.Name)
                      and isinstance(t.ctx, ast.Store)}
            if expr.id not in stores:
                continue
            for v in ast.walk(value):
                if isinstance(v, ast.Attribute) and v.attr in POOL_LEAVES:
                    return (f"local `{expr.id}` bound from cache leaf "
                            f"`.{v.attr}`")
                if isinstance(v, ast.Call) \
                        and dotted(v.func) == "getattr" and v.args:
                    base = dotted(v.args[0]) or ""
                    if base in ("cache", "c", "cur", "one", "self.cache",
                                "pool"):
                        return (f"local `{expr.id}` bound from "
                                f"getattr({base}, ...) over cache leaves")
    return None


def _enclosing_fn_node(ctx: FileCtx, node: ast.AST) -> Optional[ast.AST]:
    cur = ctx.parents.get(node)
    while cur is not None:
        if isinstance(cur, (ast.FunctionDef, ast.AsyncFunctionDef,
                            ast.Lambda)):
            return cur
        cur = ctx.parents.get(cur)
    return None


def _base(expr: ast.AST) -> ast.AST:
    """The tensor a subscript chain indexes (`pool[b][:, p]` -> `pool`)."""
    while isinstance(expr, ast.Subscript):
        expr = expr.value
    return expr


def _writes(node: ast.AST):
    """(written expression, kind) for each in-place write `node` makes."""
    if isinstance(node, ast.Assign):
        for t in node.targets:
            for el in (t.elts if isinstance(t, (ast.Tuple, ast.List))
                       else [t]):
                if isinstance(el, ast.Subscript):
                    yield _base(el), "subscript assignment"
    elif isinstance(node, ast.AugAssign):
        kind = ("in-place arithmetic" if not isinstance(
            node.target, ast.Subscript) else "subscript assignment")
        yield _base(node.target), kind
    elif isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute) \
            and node.func.attr in IN_PLACE_METHODS:
        yield _base(node.func.value), f"`.{node.func.attr}()`"


def check(index: ProjectIndex) -> List[Finding]:
    out: List[Finding] = []
    cache: Dict[int, Optional[str]] = {}
    for ctx in index.ctxs:
        if ctx.rel.endswith(ALLOWED_FILES):
            continue
        for node in ast.walk(ctx.tree):
            for base, kind in _writes(node):
                key = id(base)
                if key not in cache:
                    cache[key] = _leafish(ctx, base,
                                          _enclosing_fn_node(ctx, node))
                why = cache[key]
                if why is None:
                    continue
                out.append(Finding(
                    "TK004", ctx.rel, node.lineno, node.col_offset,
                    f"{kind} on {why} outside core/paged_kv.py — every KV "
                    "pool write must go through the writers there "
                    "(append_*/fill_*/span/copy_page/stage/splice) so "
                    "drop-gating and requant chains stay intact",
                    ctx.qualname_of(node)))
    return out
