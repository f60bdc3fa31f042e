"""Finding a cell's files by the names in `BENCHMARK.json`.

A cell (an entry of `workloads`) names a configuration and a traffic
mix; its own settings are `workloads/<cell>.json`, the configuration's
`configs/<config>.json`, the mix's `traffic/<traffic>.json`, and each
metric's reader `metrics/<metric>.py`, or, for a metric `<base>.<group>`
that has no file of its own (the same quantity, reported in another
group of cells), `metrics/<base>.py`.  Adding a cell, a configuration,
a mix or a metric adds files and entries; no file here names one.
"""
from __future__ import annotations

import json
from pathlib import Path
from typing import Any, Dict, List

PERFBENCH = Path(__file__).resolve().parent
REPO = PERFBENCH.parent


def load(path: Path) -> Dict[str, Any]:
    with open(path) as f:
        return json.load(f)


def benchmark() -> Dict[str, Any]:
    return load(REPO / "BENCHMARK.json")


def resolve(name: str, bench: Dict[str, Any] = None) -> Dict[str, Any]:
    """The cell `name` with its configuration, mix and settings."""
    bench = bench or benchmark()
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    conf = load(PERFBENCH / "configs" / f"{entry['config']}.json")
    cell = load(PERFBENCH / "workloads" / f"{name}.json")
    return {"name": name, "chips": entry["chips"],
            "config_name": entry["config"], "model": conf["model"],
            "traffic": load(PERFBENCH / "traffic"
                            / f"{entry['traffic']}.json"),
            "server": cell["server"], "check": cell["check"],
            "trace_steps": cell["trace_steps"]}


def metrics_for(name: str, trace: bool,
                bench: Dict[str, Any] = None) -> List[Dict[str, Any]]:
    """The metric entries cell `name` reports: its end-to-end metrics in
    an untraced run, its per-layer metrics in a traced one."""
    bench = bench or benchmark()
    key = "per_layer" if trace else "end_to_end"
    return [m for m in bench[key]
            if "workloads" not in m or name in m["workloads"]]


def reader_path(name: str) -> Path:
    """The reader file of metric `name` (see the module's docstring)."""
    path = PERFBENCH / "metrics" / f"{name}.py"
    if not path.is_file() and "." in name:
        path = PERFBENCH / "metrics" / f"{name.split('.', 1)[0]}.py"
    return path
