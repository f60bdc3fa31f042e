"""TK005 — kernel hygiene (the counterpart of the reference's
`repro/analysis/rules_pallas.py`).

The reference checks its Pallas calls; the port's kernels are CUDA C++
behind thin Python wrappers, and the rules that keep them honest live in
docstrings (`kernels/__init__.py`, `kernels/*/ops.py`): a wrapper
dispatches by its tensors' device alone and has no fallback, a launch's
error reaches the caller, every launch is counted, and a kernel is a
kernel, not a library call.  This rule checks them.

In the Python wrappers (files under ``kernels/``):

  * a device test other than ``PLAIN_DEVICES`` (``torch.cuda.
    is_available()``, or a branch on ``.device.type`` / ``.is_cuda``
    whose body is not a lone ``raise``);
  * a ``try`` with handlers around ``entry(...)``, ``build()`` or
    ``_raise_on(...)`` (a swallowed launch or build is a fallback);
  * a C entry's return value not passed straight to ``_raise_on``;
  * a function that calls a C entry without bumping a ``LaunchCount``;
  * in ``kernels/*/kernel.py``, a library call standing in for the
    kernel (``scaled_dot_product_attention``, ``torch.matmul``, ``@``,
    ``torch.bmm``, ``torch.einsum``, ``F.linear``, ``torch.compile`` ...).

In the CUDA sources (a text scan of ``.cu`` / ``.cuh``, comments and
strings blanked):

  * a ``__global__`` function without ``__launch_bounds__``;
  * ``printf`` in device code;
  * a kernel launch (``<<<...>>>``, ``cudaLaunchKernelEx``) whose entry
    does not return ``cudaGetLastError()`` after it.
"""
from __future__ import annotations

import ast
import re
from typing import List, Optional, Sequence, Set

from repro_torch.analysis.callgraph import ProjectIndex, dotted
from repro_torch.analysis.core import FileCtx, Finding, SourceText

_LIBRARY_CALLS = {
    "torch.nn.functional.scaled_dot_product_attention",
    "F.scaled_dot_product_attention", "torch.matmul", "torch.mm",
    "torch.bmm", "torch.einsum", "F.linear", "torch.nn.functional.linear",
    "torch.compile", "torch.baddbmm", "torch.addmm",
}
_ENTRY_NAMES = {"entry", "_build.entry"}
_BUILD_NAMES = {"build", "_build.build"}


def _finding(ctx: FileCtx, node: ast.AST, msg: str) -> Finding:
    return Finding("TK005", ctx.rel, node.lineno, node.col_offset, msg,
                   ctx.qualname_of(node))


def _is_entry(call: ast.Call, entry_locals: Set[str]) -> bool:
    """`call` launches a C entry: `entry("sym")(...)`, or `fn(...)` with
    `fn` bound from `entry("sym")`."""
    f = call.func
    if isinstance(f, ast.Call):
        return dotted(f.func) in _ENTRY_NAMES
    return isinstance(f, ast.Name) and f.id in entry_locals


def _device_test(test: ast.AST) -> Optional[str]:
    """A device test in a branch condition other than `PLAIN_DEVICES`."""
    for n in ast.walk(test):
        if isinstance(n, ast.Attribute) and n.attr in ("is_cuda", "is_cpu"):
            return f"`.{n.attr}`"
        if isinstance(n, ast.Compare):
            left = n.left
            if isinstance(left, ast.Attribute) and left.attr == "type" \
                    and not any(isinstance(c, ast.Name)
                                and c.id == "PLAIN_DEVICES"
                                for c in n.comparators):
                return "`.device.type` compared to a device name"
    return None


def _guard(node: ast.If) -> bool:
    return len(node.body) == 1 and isinstance(node.body[0], ast.Raise) \
        and not node.orelse


def _launch_counts(ctx: FileCtx) -> Set[str]:
    """Module-level names bound to `LaunchCount()`."""
    return {t.id for node in ctx.tree.body if isinstance(node, ast.Assign)
            and isinstance(node.value, ast.Call)
            and (dotted(node.value.func) or "").endswith("LaunchCount")
            for t in node.targets if isinstance(t, ast.Name)}


def _check_wrapper(ctx: FileCtx, out: List[Finding]):
    counts = _launch_counts(ctx)
    library = ctx.rel.endswith("/kernel.py")
    for node in ast.walk(ctx.tree):
        if isinstance(node, ast.Call) \
                and dotted(node.func) == "torch.cuda.is_available":
            out.append(_finding(
                ctx, node, "`torch.cuda.is_available()` in a kernel "
                "wrapper — dispatch by the tensors' device (`PLAIN_DEVICES`"
                "), never by what the machine has"))
        elif isinstance(node, (ast.If, ast.IfExp, ast.While)):
            what = _device_test(node.test)
            if what is not None and not (isinstance(node, ast.If)
                                         and _guard(node)):
                out.append(_finding(
                    ctx, node, f"a branch on {what} in a kernel wrapper — "
                    "the plain version is taken on `PLAIN_DEVICES` only, "
                    "and a CUDA tensor launches the kernel or raises"))
        elif isinstance(node, ast.Try) and node.handlers:
            for n in ast.walk(ast.Module(body=node.body, type_ignores=[])):
                if isinstance(n, ast.Call) and (
                        dotted(n.func) in _ENTRY_NAMES | _BUILD_NAMES
                        | {"_raise_on"} or _is_entry(n, set())):
                    out.append(_finding(
                        ctx, node, "a `try` around a kernel's build or "
                        "launch — a failed build or launch must reach the "
                        "caller, not fall back"))
                    break
        elif library and isinstance(node, ast.Call) \
                and dotted(node.func) in _LIBRARY_CALLS:
            out.append(_finding(
                ctx, node, f"`{dotted(node.func)}` in a kernel module — a "
                "library call does not stand in for the hand-written "
                "kernel"))
        elif library and isinstance(node, ast.BinOp) \
                and isinstance(node.op, ast.MatMult):
            out.append(_finding(
                ctx, node, "`@` in a kernel module — a library matmul does "
                "not stand in for the hand-written kernel"))
    for fn in ast.walk(ctx.tree):
        if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        entry_locals = {t.id for n in ast.walk(fn)
                        if isinstance(n, ast.Assign)
                        and isinstance(n.value, ast.Call)
                        and dotted(n.value.func) in _ENTRY_NAMES
                        for t in n.targets if isinstance(t, ast.Name)}
        launches = [n for n in ast.walk(fn) if isinstance(n, ast.Call)
                    and _is_entry(n, entry_locals)]
        for call in launches:
            parent = ctx.parents.get(call)
            if not (isinstance(parent, ast.Call)
                    and dotted(parent.func) == "_raise_on"):
                out.append(_finding(
                    ctx, call, "a C entry's return code not passed to "
                    "`_raise_on` — a failed launch must raise"))
        bumped = any(isinstance(n, ast.AugAssign)
                     and isinstance(n.target, ast.Attribute)
                     and n.target.attr == "value"
                     and isinstance(n.target.value, ast.Name)
                     and n.target.value.id in counts
                     for n in ast.walk(fn))
        if launches and not bumped:
            out.append(_finding(
                ctx, launches[0], f"`{fn.name}` launches a C entry without "
                "bumping a `LaunchCount` — every launch is counted, so a "
                "run can show it went through the kernel"))


# ---------------------------------------------------------------------------
# CUDA sources
# ---------------------------------------------------------------------------

_BLANK_RE = re.compile(r'//[^\n]*|/\*.*?\*/|"(?:\\.|[^"\\\n])*"'
                       r"|'(?:\\.|[^'\\\n])*'", re.S)
_LAUNCH_RE = re.compile(r"<<<|\bcudaLaunchKernelEx\s*\(")


def _blank(text: str) -> str:
    """`text` with comments and string literals blanked (newlines kept,
    so offsets keep their lines)."""
    return _BLANK_RE.sub(lambda m: re.sub(r"[^\n]", " ", m.group(0)), text)


def _line_of(text: str, pos: int) -> int:
    return text.count("\n", 0, pos) + 1


def _body_span(code: str, start: int) -> Optional[range]:
    """The brace-matched body of the declaration starting at `start`, or
    None for a declaration without a body."""
    depth = 0
    i = start
    while i < len(code):
        c = code[i]
        if c == "(":
            depth += 1
        elif c == ")":
            depth -= 1
        elif c == ";" and depth == 0:
            return None
        elif c == "{" and depth == 0:
            break
        i += 1
    else:
        return None
    open_at, depth = i, 0
    for j in range(open_at, len(code)):
        if code[j] == "{":
            depth += 1
        elif code[j] == "}":
            depth -= 1
            if depth == 0:
                return range(open_at, j + 1)
    return None


def _check_cuda(src: SourceText, out: List[Finding]):
    code = _blank(src.source)

    def hit(pos: int, msg: str):
        out.append(Finding("TK005", src.rel, _line_of(code, pos), 0, msg,
                           "<module>"))

    device_bodies: List[range] = []
    for m in re.finditer(r"\b__global__\b|\b__device__\b", code):
        body = _body_span(code, m.end())
        if m.group(0) == "__global__":
            end = body.start if body else code.find(";", m.end())
            if "__launch_bounds__" not in code[m.end():end]:
                hit(m.start(), "`__global__` without `__launch_bounds__` — "
                    "state the block size the kernel is built for, so the "
                    "compiler budgets registers for it")
        if body is not None:
            device_bodies.append(body)
    for m in re.finditer(r"\bprintf\s*\(", code):
        if any(m.start() in b for b in device_bodies):
            hit(m.start(), "`printf` in device code — a kernel reports "
                "through its outputs and its entry's return code")
    for m in _LAUNCH_RE.finditer(code):
        ret = re.search(r"\breturn\b[^;]*;", code[m.end():])
        after = code[m.end():m.end() + ret.end()] if ret else ""
        if "cudaGetLastError" not in after:
            hit(m.start(), "a kernel launch not followed by a return of "
                "`cudaGetLastError()` — the entry must hand the launch's "
                "error to its caller")


def check(index: ProjectIndex, cuda: Sequence[SourceText]) -> List[Finding]:
    out: List[Finding] = []
    for ctx in index.ctxs:
        rel = "/" + ctx.rel
        if "/kernels/" in rel and not rel.endswith("/_build.py"):
            _check_wrapper(ctx, out)
    for src in cuda:
        _check_cuda(src, out)
    return out
