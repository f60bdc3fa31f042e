"""Nothing on the benchmark's path loads JAX or the JAX package `repro`:
each module's top-level name (before the first dot) is compared whole,
since the port's name `repro_torch` begins with `repro`."""
import json
import os
import subprocess
import sys

from perfbench import harness, spec

FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}

DRY_RUN = """
import json, sys
sys.path[:0] = [{root!r}, {src!r}]
from perfbench import harness, testcells
out = harness.run_cell(testcells.cell(moe=True), 5, 0.0, False, "cpu", 0.0,
                       window_steps=10)
line, _ = harness.result(out, {{"end_to_end": [], "per_layer": []}},
                         "tiny", False, "cpu")
assert line["checks"]["tokens_compared"]["value"] > 0
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""

YARDSTICK = """
import json, sys
sys.path[:0] = [{root!r}]
from perfbench import check, cost, reference, spec, trace, traffic, weights
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def _modules(code):
    src = code.format(root=str(spec.REPO), src=str(spec.REPO / "src"))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", src], capture_output=True,
                         text=True, timeout=300, env=env)
    assert out.returncode == 0, out.stderr[-2000:]
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_cpu_dry_run_loads_no_jax():
    top = _modules(DRY_RUN)
    assert "repro_torch" in top and "perfbench" in top
    assert not top & FORBIDDEN, top & FORBIDDEN


def test_yardstick_imports_none_of_the_program():
    top = _modules(YARDSTICK)
    assert not top & (FORBIDDEN | {"repro_torch"})


def test_forbidden_names_compared_whole():
    sys.modules.setdefault("repro_torch_probe", sys)
    try:
        assert "repro_torch_probe" not in harness.forbidden_modules()
    finally:
        del sys.modules["repro_torch_probe"]


def test_no_card_no_result():
    """Without a CUDA card (as on this CPU) the command exits non-zero
    and prints no result line."""
    import torch
    if torch.cuda.is_available():
        return
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run(
        [sys.executable, "perfbench/run.py", "--workload",
         "mixtral-w4a16.chat", "--seed", "7", "--seconds", "1", "--trace",
         "0"], cwd=spec.REPO, capture_output=True, text=True, timeout=300,
        env=env)
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_benchmark_files_alone_give_no_result(tmp_path):
    """In a directory holding only BENCHMARK.json and perfbench/, the
    command exits non-zero and prints no result line."""
    import shutil
    shutil.copy(spec.REPO / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(spec.PERFBENCH, tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run(
        [sys.executable, "perfbench/run.py", "--workload",
         "pixtral-text-w4a16.chat", "--seed", "7", "--seconds", "1",
         "--trace", "0"], cwd=tmp_path, capture_output=True, text=True,
        timeout=300, env=env)
    assert out.returncode != 0 and out.stdout.strip() == ""
