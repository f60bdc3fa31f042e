"""The port's kvlint CLI — ``python -m repro_torch.analysis.kvlint
src/repro_torch chip_smoke.py`` (the counterpart of the reference's
`repro/analysis/kvlint.py`, with the same flags and exit codes).

Exit status: 0 when every finding is suppressed or baselined, 1 when any
live finding remains, 2 on usage errors.  Text output is
``path:line:col: RULE message``; ``--format json`` emits a
machine-readable list.  ``--update-baseline`` rewrites the baseline file
with the current findings (each new entry then needs a one-line
justification in place of the TODO marker).
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path
from typing import List

from repro_torch.analysis.core import (RULES, Baseline, Finding, load_cuda,
                                       load_files, run_paths)

DEFAULT_BASELINE = "kvlint_torch_baseline.txt"


def _root() -> Path:
    """Repo root = nearest ancestor of the working directory holding
    ROADMAP.md or .git, falling back to the working directory."""
    here = Path.cwd()
    for cand in (here, *here.parents):
        if (cand / "ROADMAP.md").exists() or (cand / ".git").exists():
            return cand
    return here


def main(argv: List[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis.kvlint",
        description="the PyTorch/CUDA port's static analyzer (TK001-TK005)")
    ap.add_argument("paths", nargs="+",
                    help="files or directories to analyze")
    ap.add_argument("--rules", default=",".join(RULES),
                    help="comma-separated rule subset (default: all)")
    ap.add_argument("--baseline", default=DEFAULT_BASELINE,
                    help=f"baseline file (default {DEFAULT_BASELINE}; "
                         "'none' disables)")
    ap.add_argument("--update-baseline", action="store_true",
                    help="write current findings to the baseline")
    ap.add_argument("--format", choices=("text", "json"), default="text")
    ap.add_argument("--root", default=None,
                    help="repo root override (tests)")
    args = ap.parse_args(argv)

    root = Path(args.root) if args.root else _root()
    rules = [r.strip() for r in args.rules.split(",") if r.strip()]
    unknown = [r for r in rules if r not in RULES]
    if unknown:
        print(f"kvlint: unknown rule(s) {unknown}; known: {RULES}",
              file=sys.stderr)
        return 2

    findings = run_paths(args.paths, root, rules)
    ctx_by_rel = {c.rel: c for c in [*load_files(args.paths, root),
                                     *load_cuda(args.paths, root)]}

    bl_path = None if args.baseline == "none" \
        else (root / args.baseline)
    baseline = Baseline(bl_path)

    live: List[Finding] = []
    grandfathered: List[Finding] = []
    for f in findings:
        src = ctx_by_rel[f.path].src_line(f.line)
        (grandfathered if baseline.matches(f, src) else live).append(f)

    if args.update_baseline:
        if bl_path is None:
            print("kvlint: --update-baseline needs a baseline path",
                  file=sys.stderr)
            return 2
        lines = ["# kvlint baseline of the PyTorch/CUDA port — "
                 "grandfathered findings.",
                 "# One entry per line:  RULE path::qualname::crc  "
                 "justification",
                 "# Every entry MUST carry a one-line justification; "
                 "fix the finding instead when you can.", ""]
        keys = set()
        for f in findings:
            src = ctx_by_rel[f.path].src_line(f.line)
            key = f"{f.rule}:{f.key(src).split(':', 1)[1]}"
            if key in keys:
                continue            # two findings on one line: one entry
            keys.add(key)
            lines.append(Baseline.format_entry(
                f, src, baseline.entries.get(key)
                or "TODO: justify this entry"))
        bl_path.write_text("\n".join(lines) + "\n")
        print(f"kvlint: wrote {len(keys)} entr"
              f"{'y' if len(keys) == 1 else 'ies'} to {bl_path}")
        return 0

    if args.format == "json":
        print(json.dumps([{
            "rule": f.rule, "path": f.path, "line": f.line,
            "col": f.col, "message": f.message, "qualname": f.qualname,
            "baselined": f in grandfathered,
        } for f in findings], indent=2))
    else:
        for f in live:
            print(f"{f.path}:{f.line}:{f.col + 1}: {f.rule} {f.message}")
        if grandfathered:
            print(f"kvlint: {len(grandfathered)} baselined finding(s) "
                  "suppressed")
        n = len(live)
        print(f"kvlint: {n} finding{'s' if n != 1 else ''} "
              f"({len(rules)} rules over {len(ctx_by_rel)} files)")
    return 1 if live else 0


if __name__ == "__main__":
    sys.exit(main())
