"""The port's kvlint engine: findings, suppressions, baseline,
orchestration (the counterpart of the reference's
`repro/analysis/core.py`, copied with the port's rules and one addition:
the CUDA sources under `csrc/` are read as text for TK005).

Machinery only — the rules live in ``rules_step`` / ``rules_pool`` /
``rules_cuda``.  Everything here is stdlib-only, so the linter runs on a
bare interpreter, with neither torch nor jax installed.
"""
from __future__ import annotations

import ast
import dataclasses
import re
import zlib
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Sequence, Set

RULES = ("TK001", "TK002", "TK003", "TK004", "TK005")

# `# kvlint: disable=TK001` in Python, `// kvlint: disable=TK005` in CUDA
_SUPPRESS_RE = re.compile(r"(?:#|//)\s*kvlint:\s*disable=([A-Z0-9,\s]+)")
CUDA_SUFFIXES = (".cu", ".cuh")


@dataclasses.dataclass(frozen=True)
class Finding:
    """One rule violation, anchored to a source line.

    ``fingerprint`` keys baseline entries: it hashes the rule, the
    enclosing function's qualname and the *text* of the flagged line, so
    entries survive unrelated edits that renumber lines.
    """
    rule: str
    path: str          # repo-relative, forward slashes
    line: int          # 1-indexed
    col: int
    message: str
    qualname: str      # enclosing function ("<module>" at top level)

    @property
    def fingerprint(self) -> str:
        return f"{self.rule}:{self.path}::{self.qualname}"

    def key(self, src_line: str) -> str:
        crc = zlib.crc32(src_line.strip().encode())
        return f"{self.fingerprint}::{crc:08x}"


class SourceText:
    """A source file's lines and its per-line suppression map (a CUDA
    source is linted as this text alone)."""

    def __init__(self, path: Path, rel: str):
        self.path = path
        self.rel = rel
        self.source = path.read_text()
        self.lines = self.source.splitlines()
        self.suppressed: Dict[int, Set[str]] = self._scan_suppressions()

    def _scan_suppressions(self) -> Dict[int, Set[str]]:
        """``# kvlint: disable=TK001[,TK002]`` suppresses its own line;
        a standalone suppression comment suppresses the next code line."""
        out: Dict[int, Set[str]] = {}
        for i, text in enumerate(self.lines, start=1):
            m = _SUPPRESS_RE.search(text)
            if not m:
                continue
            rules = {r.strip() for r in m.group(1).split(",") if r.strip()}
            target = i
            if _is_comment(text):                 # standalone comment line
                j = i + 1
                while j <= len(self.lines) and (
                        not self.lines[j - 1].strip()
                        or _is_comment(self.lines[j - 1])):
                    j += 1
                target = j
            out.setdefault(target, set()).update(rules)
        return out

    def is_suppressed(self, rule: str, line: int) -> bool:
        return rule in self.suppressed.get(line, ())

    def src_line(self, line: int) -> str:
        if 1 <= line <= len(self.lines):
            return self.lines[line - 1]
        return ""


def _is_comment(text: str) -> bool:
    return text.strip().startswith(("#", "//"))


class FileCtx(SourceText):
    """Parsed Python source + per-line suppression map + parent links."""

    def __init__(self, path: Path, rel: str):
        super().__init__(path, rel)
        self.tree = ast.parse(self.source, filename=rel)
        self.parents: Dict[ast.AST, ast.AST] = {}
        for node in ast.walk(self.tree):
            for child in ast.iter_child_nodes(node):
                self.parents[child] = node

    def qualname_of(self, node: ast.AST) -> str:
        parts: List[str] = []
        cur: Optional[ast.AST] = node
        while cur is not None:
            if isinstance(cur, (ast.FunctionDef, ast.AsyncFunctionDef,
                                ast.ClassDef)):
                parts.append(cur.name)
            elif isinstance(cur, ast.Lambda):
                parts.append("<lambda>")
            cur = self.parents.get(cur)
        return ".".join(reversed(parts)) or "<module>"


class Baseline:
    """Grandfathered findings: ``RULE path::qualname::crc  justification``
    per line.  A finding whose key matches an entry is reported only in
    verbose mode and never fails the run."""

    def __init__(self, path: Optional[Path]):
        self.path = path
        self.entries: Dict[str, str] = {}
        if path is not None and path.exists():
            for raw in path.read_text().splitlines():
                line = raw.strip()
                if not line or line.startswith("#"):
                    continue
                fields = line.split(None, 2)
                if len(fields) < 2:
                    continue
                rule, key = fields[0], fields[1]
                note = fields[2] if len(fields) > 2 else ""
                self.entries[f"{rule}:{key}"] = note

    def matches(self, finding: Finding, src_line: str) -> bool:
        rule_key = finding.key(src_line)
        # stored form: "RULE path::qual::crc"
        return f"{finding.rule}:{rule_key.split(':', 1)[1]}" in self.entries

    @staticmethod
    def format_entry(finding: Finding, src_line: str,
                     note: str = "TODO: justify this entry") -> str:
        key = finding.key(src_line)
        return f"{finding.rule} {key.split(':', 1)[1]}  {note}"


def iter_files(paths: Sequence[str], root: Path,
               suffixes: Sequence[str]) -> List[Path]:
    files: List[Path] = []
    for p in paths:
        pp = (root / p) if not Path(p).is_absolute() else Path(p)
        if pp.is_dir():
            files.extend(sorted(f for f in pp.rglob("*")
                                if f.suffix in suffixes and f.is_file()
                                and "__pycache__" not in f.parts))
        elif pp.suffix in suffixes:
            files.append(pp)
    return files


def _rel(f: Path, root: Path) -> str:
    try:
        return f.relative_to(root).as_posix()
    except ValueError:
        return f.as_posix()


def load_files(paths: Sequence[str], root: Path) -> List[FileCtx]:
    """Every Python file under `paths`, parsed."""
    return [FileCtx(f, _rel(f, root))
            for f in iter_files(paths, root, (".py",))]


def load_cuda(paths: Sequence[str], root: Path) -> List[SourceText]:
    """Every CUDA source (`.cu`, `.cuh`) under `paths`, as text."""
    return [SourceText(f, _rel(f, root))
            for f in iter_files(paths, root, CUDA_SUFFIXES)]


def run_paths(paths: Sequence[str], root: Path,
              rules: Optional[Iterable[str]] = None,
              step_roots=None) -> List[Finding]:
    """Parse every .py (and read every .cu/.cuh) under `paths`, run the
    rules, apply per-line suppressions (the baseline filter is the CLI's
    job).  `step_roots` replaces `rules_step.STEP_ROOTS` (fixtures)."""
    from repro_torch.analysis import rules_cuda, rules_pool, rules_step
    from repro_torch.analysis.callgraph import ProjectIndex

    ctxs = load_files(paths, root)
    cuda = load_cuda(paths, root)
    index = ProjectIndex(ctxs, rules_step.STEP_ROOTS
                         if step_roots is None else step_roots)
    selected = set(rules) if rules is not None else set(RULES)
    findings: List[Finding] = []
    if selected & {"TK001", "TK002", "TK003"}:
        findings += rules_step.check(index, selected)
    if "TK004" in selected:
        findings += rules_pool.check(index)
    if "TK005" in selected:
        findings += rules_cuda.check(index, cuda)
    by_rel = {c.rel: c for c in [*ctxs, *cuda]}
    kept = [f for f in findings
            if not by_rel[f.path].is_suppressed(f.rule, f.line)]
    kept.sort(key=lambda f: (f.path, f.line, f.rule))
    return kept
