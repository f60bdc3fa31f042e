"""Run one cell of the benchmark and print its result line.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

From the root of a checkout of the repository, on a machine with the
cards the cell asks for.  The last line of standard output is one JSON
object (correct, attempted, failed, metrics, device, and with --trace 1
breakdown, then checks); the numbers compared end standard error, each
beside its limit.  Exits non-zero, printing no result, where there is no
CUDA card or fewer than the cell asks for, where the program's package
is missing, or where a module of JAX or of the JAX package was loaded.
"""
from __future__ import annotations

import os
import time


def _since_process_start() -> float:
    """Seconds since this process began (Linux /proc), 0 elsewhere."""
    try:
        with open("/proc/self/stat") as f:
            start = float(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            up = float(f.read().split()[0])
        return max(0.0, up - start / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return 0.0


T_START = time.monotonic() - _since_process_start()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]
os.environ.setdefault("USE_FLAX", "0")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from perfbench import harness, spec
    if not (ROOT / "src" / "repro_torch").is_dir():
        harness.log("perfbench: the program's package src/repro_torch is "
                    "not in this checkout")
        return 2
    bench = spec.benchmark()
    cell = spec.resolve(args.workload, bench)
    import torch
    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if cards < cell["chips"]:
        harness.log(f"perfbench: {args.workload} needs {cell['chips']} "
                    f"CUDA card(s); found {cards}")
        return 2
    out = harness.run_cell(cell, args.seed, args.seconds, bool(args.trace),
                           "cuda", T_START)
    bad = harness.forbidden_modules()
    if bad:
        harness.log(f"perfbench: modules of JAX or the JAX package were "
                    f"loaded: {', '.join(bad)}")
        return 3
    line, checks = harness.result(out, bench, args.workload,
                                  bool(args.trace), "cuda")
    for name, c in checks.items():
        harness.log(f"{name} = {c['value']!r} (limit {c['limit']!r})")
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
