"""Dry-run of every (arch × shape × mesh) cell on the meta device (port
of `repro.launch.dryrun`).

For each cell: build the step and its arguments as meta tensors
(`launch/steps.py`), run the step once under the op counter
(`launch/op_cost.py`) — no array is ever allocated and no kernel built —
and derive whether it fits one H100's 80 GB and the three roofline
terms of that eager program and the bound of the step's function
(`launch/roofline.py`), writing one JSON record per cell under
artifacts/dryrun_torch/.

Meshes: the reference's production meshes (16×16, and 2×16×16 with
`pod`) over meta devices, or `--chips N`, the (data, model) mesh that
`mesh_from_devices` factors N cards into.  Per-device argument bytes are
exact on every mesh.  On one device the FLOPs, bytes, fusible bytes and
temp are what the meta run counted; on a larger mesh (the port has no
SPMD partitioner, so the run is the single-device program) FLOPs and
bytes are that count divided by the devices, temp by the data-parallel
shards, the collective term is not counted (null), and the record says
"terms": "even_split".  A cell whose step reads a value to the host
(`.item()`, `.cpu()`, `nonzero()`, which raise on meta) is recorded as
an error with the reason.

Usage:
  python -m repro_torch.launch.dryrun --arch qwen1.5-0.5b --shape decode_32k --chips 1
  python -m repro_torch.launch.dryrun --all --chips 1
  python -m repro_torch.launch.dryrun --all [--multi-pod-only|--single-pod-only]
  python -m repro_torch.launch.dryrun --all --arch-filter moe
"""
from __future__ import annotations

import argparse
import json
import os
import signal
import time
import traceback

import torch

from repro_torch.configs import (ASSIGNED_ARCHS, SHAPES, get_config,
                                 shape_applicable)
from repro_torch.launch import op_cost
from repro_torch.launch import roofline as rl
from repro_torch.launch.mesh import make_production_mesh, mesh_from_devices
from repro_torch.launch.steps import build_cell, function_cost

ARTIFACT_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                            "artifacts", "dryrun_torch")

META = torch.device("meta")


def cell_mesh(multi_pod: bool, chips: int = 0):
    """(the cell's mesh of meta devices, its tag, the records' name for
    it: chipsN, single or multi)."""
    if chips:
        return (mesh_from_devices([META] * chips),
                f"{chips} chip" + ("s" if chips > 1 else ""),
                f"chips{chips}")
    n = 512 if multi_pod else 256
    return (make_production_mesh(multi_pod=multi_pod, devices=[META] * n),
            "2x16x16" if multi_pod else "16x16",
            "multi" if multi_pod else "single")


def count_cell(cell, cfg):
    """(memory summary, Roofline of the eager program, the function's
    Bound, terms, the count) of a built cell: its step run once on meta
    under the op counter."""
    cost = op_cost.count(cell.jitted, *cell.abstract_args,
                         fusible_last2=cell.fusible_last2)
    mf = rl.model_flops_estimate(cfg, cell.shape)
    split = cell.chips
    mem = rl.memory_summary(cost, cell.argument_bytes,
                            temp_split=cell.dp_shards if split > 1 else 1)
    roof = rl.analyze(cost, cell.chips, mf, split=split)
    bound = rl.function_bound(*function_cost(cell, cost), split=split)
    return (mem, roof, bound, ("exact" if split == 1 else "even_split"),
            cost)


def run_cell(arch: str, shape_name: str, multi_pod: bool = False,
             eng_overrides=None, verbose: bool = True,
             cell_timeout: int = 0, chips: int = 0):
    mesh, where, key = cell_mesh(multi_pod, chips)
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    ok, why = shape_applicable(cfg, shape)
    tag = f"{arch} × {shape_name} × {where}"
    record = {"arch": arch, "shape": shape_name, "multi_pod": multi_pod,
              "chips": mesh.size, "mesh": key}
    if not ok:
        if verbose:
            print(f"SKIP {tag}: {why}")
        return dict(record, status="skipped", reason=why)

    t0 = time.time()
    try:
        if cell_timeout:
            def _on_alarm(signum, frame):
                raise TimeoutError(f"cell exceeded {cell_timeout}s")
            signal.signal(signal.SIGALRM, _on_alarm)
            signal.alarm(cell_timeout)
        cell = build_cell(arch, shape_name, mesh, multi_pod=multi_pod,
                          eng_overrides=eng_overrides)
        t_build = time.time() - t0
        mem, roof, bound, terms, cost = count_cell(cell, cfg)
        t_count = time.time() - t0 - t_build
        record.update(
            status="ok", note=cell.note, terms=terms,
            lower_s=round(t_build, 1), compile_s=round(t_count, 1),
            memory=mem, roofline=roof.to_dict(), bound=bound.to_dict(),
            ops=cost.ops,
            bytes_per_device=mem.get("total_bytes"), fits=mem["fits"],
        )
        if verbose:
            coll = ("—" if roof.collective_s is None
                    else f"{roof.collective_s*1e3:.2f} ms")
            print(f"OK   {tag}  [{cell.note}] ({terms})")
            print(f"     mem/device: {mem['total_bytes']/2**30:.2f} "
                  f"GiB (args {mem['argument_bytes']/2**30:.2f} + "
                  f"temp {mem['temp_bytes']/2**30:.2f})"
                  f"{'' if mem['fits'] else ' DOES NOT FIT'}")
            print(f"     roofline: compute {roof.compute_s*1e3:.2f} ms | "
                  f"memory {roof.memory_s*1e3:.2f} ms (raw "
                  f"{roof.memory_raw_s*1e3:.2f}) | collective {coll} -> "
                  f"{roof.bottleneck} | useful {roof.useful_ratio:.2f}")
            print(f"     the function's bound: {bound.bound_s*1e3:.2f} ms "
                  f"(operations {bound.compute_s*1e3:.2f}, bytes "
                  f"{bound.memory_s*1e3:.2f}) -> {bound.bound_by}")
    except BaseException as e:  # noqa: BLE001  (incl. TimeoutError)
        record.update(status="error", error=f"{type(e).__name__}: {e}",
                      traceback=traceback.format_exc())
        if verbose:
            print(f"FAIL {tag}: {type(e).__name__}: {e}", flush=True)
        if isinstance(e, (KeyboardInterrupt, SystemExit)):
            raise
    finally:
        signal.alarm(0)
    return record


def save_record(record):
    os.makedirs(ARTIFACT_DIR, exist_ok=True)
    name = f"{record['arch']}__{record['shape']}__{record['mesh']}.json"
    with open(os.path.join(ARTIFACT_DIR, name), "w") as f:
        json.dump(record, f, indent=1, default=str)


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.dryrun")
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None, choices=list(SHAPES))
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--arch-filter", default=None,
                    help="substring or family filter")
    ap.add_argument("--multi-pod-only", action="store_true")
    ap.add_argument("--single-pod-only", action="store_true")
    ap.add_argument("--quant", default=None, choices=["w8a8", "w4a16"])
    ap.add_argument("--variant", default=None,
                    choices=["compact", "discrete"])
    ap.add_argument("--page-tokens", type=int, default=None)
    ap.add_argument("--cell-timeout", type=int, default=1800)
    ap.add_argument("--chips", type=int, default=0,
                    help="the mesh of N cards (mesh_from_devices) in place "
                    "of the production meshes")
    args = ap.parse_args(argv)

    overrides = {}
    if args.quant:
        overrides["quant"] = args.quant
    if args.variant:
        overrides["variant"] = args.variant
    if args.page_tokens:
        overrides["page_tokens"] = args.page_tokens

    archs = [args.arch] if args.arch else list(ASSIGNED_ARCHS)
    if args.arch_filter:
        archs = [a for a in archs
                 if args.arch_filter in a
                 or get_config(a).family == args.arch_filter]
    shapes = [args.shape] if args.shape else list(SHAPES)
    pods = []
    if args.chips:
        pods.append(False)
    else:
        if not args.multi_pod_only:
            pods.append(False)
        if not args.single_pod_only:
            pods.append(True)

    results = []
    for arch in archs:
        for shape_name in shapes:
            for mp in pods:
                rec = run_cell(arch, shape_name, mp,
                               eng_overrides=overrides or None,
                               cell_timeout=args.cell_timeout,
                               chips=args.chips)
                save_record(rec)
                results.append(rec)

    n_ok = sum(r["status"] == "ok" for r in results)
    n_skip = sum(r["status"] == "skipped" for r in results)
    n_err = sum(r["status"] == "error" for r in results)
    print(f"\n=== dry-run summary: {n_ok} ok, {n_skip} skipped "
          f"(documented), {n_err} errors ===")
    raise SystemExit(1 if n_err else 0)


if __name__ == "__main__":
    main()
