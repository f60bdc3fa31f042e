"""Fault-tolerant training driver (port of `repro.launch.train`).

Checkpoint/restart, async saves, straggler detection, deterministic resume
(index-based data cursor), optional failure injection for testing the
recovery path.  Every attention forward runs kernel B4 on the card, under
autograd (`kernels/flash_attention/autograd.py`); RWKV6 trains on the CPU
only (ROADMAP A18b).

  PYTHONPATH=src python -m repro_torch.launch.train --reduced --steps 20 \\
      --device cpu
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen1.5-0.5b \\
      --steps 200 --ckpt-dir CKPT [--simulate-failure 57]

Takes every flag of the reference's `launch/train.py` and prints its
`[train]` lines; `--device` (default cuda) says where the weights, the
optimizer state and the kernels live.  As the reference does, it derives
the elastic mesh from the live devices (`launch.mesh.mesh_from_devices`:
every visible card, or the CPU under `--device cpu`) and prints its
shape; it trains on the mesh's first device.  Weights are drawn from a
seeded torch generator, so they are the reference's in shape and scale,
not in value (`bridge.train_state_from_numpy` carries a reference state
over).

A checkpoint's step is the number of updates applied to it, the step the
loop resumes at.  The reference labels its periodic saves with the step
just completed, one update behind the state they hold, so a resume from
one reruns that step's index on the next batch and the run ends one
update past `--steps` (ROADMAP §C); the final saves agree in both
packages.  A SIGTERM takes effect at the end of the step in flight (the
step updates the state in place, so a save in its middle would hold half
an update): the state is saved and the process exits 0.  The previous
SIGTERM handler is back in place when `train` returns.
"""
from __future__ import annotations

import argparse
import os
import signal
import sys
import time

import torch

from repro_torch.checkpoint import checkpoint as ck
from repro_torch.configs import EngineConfig, get_config
from repro_torch.data.pipeline import DataConfig, DataIterator, make_source
from repro_torch.kernels import _build
from repro_torch.launch.mesh import mesh_from_devices
from repro_torch.models.registry import Model
from repro_torch.models.transformer import Runtime
from repro_torch.training.optimizer import AdamWConfig
from repro_torch.training.train_step import init_train_state, make_train_step


class StragglerMonitor:
    """EMA step-time monitor: flags slow steps (at fleet scale this signal
    feeds re-meshing / hot-spare swap; here it logs)."""

    def __init__(self, factor: float = 2.0, alpha: float = 0.1):
        self.ema = None
        self.factor = factor
        self.alpha = alpha
        self.flagged = 0

    def observe(self, dt: float) -> bool:
        slow = self.ema is not None and dt > self.factor * self.ema
        self.ema = dt if self.ema is None else \
            (1 - self.alpha) * self.ema + self.alpha * dt
        if slow:
            self.flagged += 1
        return slow


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.train")
    ap.add_argument("--arch", default="qwen1.5-0.5b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--seq-len", type=int, default=256)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--remat", default="none",
                    choices=["none", "block", "full"])
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--simulate-failure", type=int, default=0,
                    help="crash (exit 17) once at this step, pre-restore")
    ap.add_argument("--data-seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="where the weights, the optimizer state and the "
                    "kernels live (cpu runs the kernels' plain versions)")
    return ap


def train(argv=None, rt=None):
    """Run the flags in `argv`; returns the losses.  `rt` is the forward's
    `Runtime` (default `Runtime()`: B4 on the card); an in-process caller
    may pass `Runtime(attn_impl="ref")` to train through the plain
    attention instead."""
    args = _parser().parse_args(argv)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    device = torch.device(args.device)
    rt = Runtime() if rt is None else rt
    model = Model(cfg, rt)
    acfg = AdamWConfig(lr=args.lr, warmup_steps=max(args.steps // 20, 2),
                       total_steps=args.steps)
    eng = EngineConfig(remat=args.remat, microbatches=args.microbatches)

    mesh = mesh_from_devices(None if args.device == "cuda" else [device])
    device = mesh.first_device
    print(f"[train] {cfg.name}: {cfg.param_count()/1e6:.1f}M params, "
          f"mesh {dict(mesh.shape)}")

    params = model.init(torch.Generator(device=device).manual_seed(0))
    state = init_train_state(params, acfg)
    dcfg = DataConfig(seq_len=args.seq_len, global_batch=args.global_batch,
                      vocab_size=cfg.vocab_size, seed=args.data_seed)
    it = DataIterator(make_source(dcfg))
    start_step = 0

    ckpt = None
    if args.ckpt_dir:
        ckpt = ck.AsyncCheckpointer(args.ckpt_dir, keep=3)
        latest = ck.latest_step(args.ckpt_dir)
        if latest is not None:
            state, extra = ck.restore_checkpoint(args.ckpt_dir, latest,
                                                 state)
            it.restore(extra.get("data_index", latest))
            start_step = latest
            print(f"[train] restored step {latest} "
                  f"(data cursor {it.state()})")

    step_fn = make_train_step(cfg, rt, acfg, eng)
    monitor = StragglerMonitor()
    if device.type == "cuda":
        _build.build()      # else the first step times nvcc
    step = start_step
    done = start_step       # updates applied to `state`
    preempted = []

    def on_sigterm(signum, frame):      # graceful preemption
        preempted.append(signum)

    def save_and_exit():
        if ckpt:
            ckpt.save(done, state, extra={"data_index": it.state()})
            ckpt.wait()
        print(f"[train] preempted at step {step}; checkpoint saved")
        sys.exit(0)

    previous = signal.signal(signal.SIGTERM, on_sigterm)
    losses = []
    try:
        for step in range(start_step, args.steps):
            if preempted:
                save_and_exit()
            if args.simulate_failure and step == args.simulate_failure \
                    and start_step < args.simulate_failure:
                print(f"[train] SIMULATED FAILURE at step {step}",
                      flush=True)
                os._exit(17)
            t0 = time.time()
            batch = {k: torch.from_numpy(v).to(device)
                     for k, v in next(it).items()}
            state, metrics = step_fn(state, batch)
            done = step + 1
            loss = float(metrics["loss"])
            losses.append(loss)
            dt = time.time() - t0
            if monitor.observe(dt):
                print(f"[train] straggler: step {step} took {dt:.2f}s "
                      f"(ema {monitor.ema:.2f}s)")
            if step % args.log_every == 0:
                print(f"[train] step {step:5d} loss {loss:.4f} "
                      f"gnorm {float(metrics['grad_norm']):.2f} "
                      f"lr {float(metrics['lr']):.2e} {dt*1e3:.0f}ms",
                      flush=True)
            if ckpt and step and step % args.ckpt_every == 0:
                ckpt.save(done, state, extra={"data_index": it.state()})
        if preempted:
            save_and_exit()
        if ckpt:
            ckpt.save(args.steps, state, extra={"data_index": it.state()})
            ckpt.wait()
    finally:
        signal.signal(signal.SIGTERM, previous)
    print(f"[train] done: loss {losses[0]:.3f} -> {losses[-1]:.3f} "
          f"({monitor.flagged} straggler steps)")
    return losses


if __name__ == "__main__":
    train()
