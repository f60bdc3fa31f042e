"""Render the dry-run's tables from artifacts/dryrun_torch/*.json (port
of `repro.launch.report`).

Usage:
  python -m repro_torch.launch.report                 # summary, 16x16
  python -m repro_torch.launch.report table           # 16x16 table
  python -m repro_torch.launch.report table multi     # 2x16x16 table
  python -m repro_torch.launch.report table chips1    # --chips 1 table
"""
from __future__ import annotations

import glob
import json
import os
import sys

ART = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                   "artifacts", "dryrun_torch")


def load(mesh="single"):
    """The records of one mesh: "single" (16x16), "multi" (2x16x16) or
    "chipsN" (`dryrun --chips N`)."""
    rows = []
    for path in sorted(glob.glob(os.path.join(ART, "*.json"))):
        with open(path) as f:
            r = json.load(f)
        if r.get("mesh") == mesh:
            rows.append(r)
    return rows


def fmt_ms(s):
    return "—" if s is None else f"{s * 1e3:.1f}"


def roofline_table(mesh="single") -> str:
    rows = load(mesh)
    order = {"train_4k": 0, "prefill_32k": 1, "decode_32k": 2,
             "long_500k": 3}
    rows.sort(key=lambda r: (r["arch"], order.get(r["shape"], 9)))
    out = ["| arch | shape | GiB/dev | fits | compute ms | memory ms (raw) "
           "| collective ms | bottleneck | useful |",
           "|---|---|---|---|---|---|---|---|---|"]
    for r in rows:
        if r["status"] == "skipped":
            out.append(f"| {r['arch']} | {r['shape']} | — | — | — | — | "
                       f"— | skipped: sub-quadratic-only shape | — |")
            continue
        if r["status"] != "ok":
            out.append(f"| {r['arch']} | {r['shape']} | — | — | — | — | "
                       f"— | ERROR {r.get('error', '')[:40]} | — |")
            continue
        roof = r["roofline"]
        mem = r.get("memory", {})
        out.append(
            f"| {r['arch']} | {r['shape']} | "
            f"{mem.get('total_bytes', 0) / 2**30:.1f} | "
            f"{'yes' if mem.get('fits') else 'no'} | "
            f"{fmt_ms(roof['compute_s'])} | {fmt_ms(roof['memory_s'])} "
            f"({fmt_ms(roof['memory_raw_s'])}) | "
            f"{fmt_ms(roof['collective_s'])} | {roof['bottleneck']} | "
            f"{roof['useful_ratio']:.2f} |")
    return "\n".join(out)


def summary_stats(mesh="single"):
    ok = [r for r in load(mesh) if r["status"] == "ok"]
    sk = [r for r in load(mesh) if r["status"] == "skipped"]
    err = [r for r in load(mesh) if r["status"] == "error"]
    fit = [r for r in ok if r["memory"].get("fits")]
    print(f"{mesh}: ok {len(ok)} (fit one card: {len(fit)})  "
          f"skipped {len(sk)}  errors {len(err)}")
    worst = sorted(
        ok, key=lambda r: -(r["roofline"]["memory_s"]
                            + (r["roofline"]["collective_s"] or 0.0))
        / max(r["roofline"]["compute_s"], 1e-9))[:5]
    print("\nworst roofline fraction (dominant/compute):")
    for r in worst:
        roof = r["roofline"]
        print(f"  {r['arch']} × {r['shape']}: compute "
              f"{fmt_ms(roof['compute_s'])} vs mem "
              f"{fmt_ms(roof['memory_s'])} coll "
              f"{fmt_ms(roof['collective_s'])}")
    collb = sorted((r for r in ok
                    if r["roofline"]["collective_s"] is not None),
                   key=lambda r: -r["roofline"]["collective_s"])[:5]
    print("\nmost collective-bound:")
    for r in collb:
        roof = r["roofline"]
        gib = {k: round(v / 2**30, 1)
               for k, v in roof["collectives"].items()}
        print(f"  {r['arch']} × {r['shape']}: coll "
              f"{fmt_ms(roof['collective_s'])} ({gib} GiB)")


if __name__ == "__main__":
    args = sys.argv[1:]
    if args[:1] == ["table"]:
        print(roofline_table(args[1] if len(args) > 1 else "single"))
    else:
        summary_stats(args[0] if args else "single")
