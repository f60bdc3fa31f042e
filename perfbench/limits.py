"""Readings that a cell's limits of `correct` are set from: the check's
numbers of sound runs over many seeds, and of the control (the configuration's
bf16 lowered to int8: kv8 pages and W8A8 2-D projections, the program's
own paths), in one process, one run after another.

    python3 perfbench/limits.py --workload <cell> --seeds 1,2,3 \
        --control-seeds 4,5,6 --seconds 30 --out <file.jsonl>

Each line of the output: the seed, whether it was the control, the
check's numbers (`check.compare`) and output_tok_s.  The benchmark's
own runs do not run this.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--out", required=True)
    args = ap.parse_args(argv)
    from perfbench import harness, spec
    cell = spec.resolve(args.workload)
    plan = [(int(s), False) for s in args.seeds.split(",") if s] + \
        [(int(s), True) for s in args.control_seeds.split(",") if s]
    with open(args.out, "a") as f:
        for seed, control in plan:
            out = harness.run_cell(cell, seed, args.seconds, False, "cuda",
                                   time.monotonic(), control=control)
            chk, run = out["check"], out["run"]
            rec = {"workload": args.workload, "seed": seed,
                   "control": control,
                   **{k: v for k, v in chk.items()
                      if k not in ("routed_pairs", "reference_s")},
                   "output_tok_s": sum(s.tokens for s in run.steps)
                   / run.window_s}
            f.write(json.dumps(rec) + "\n")
            f.flush()
            harness.log(json.dumps(rec))
    return 0


if __name__ == "__main__":
    sys.exit(main())
