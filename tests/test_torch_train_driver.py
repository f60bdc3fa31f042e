"""PyTorch port: `launch.train`, the training driver, on the CPU at
reduced size.

  * It prints the reference driver's `[train]` lines (the same lines in
    the same order, the mesh replaced by the device), its loss falls,
    and it leaves the caller's SIGTERM handler in place.
  * A resume from a periodic checkpoint equals the run that wrote it:
    the losses of the steps after it and the final state, bit for bit
    (the port labels a checkpoint with the updates it holds; the
    reference's periodic label is one behind, ROADMAP §C).
  * `--simulate-failure` exits 17 (in a subprocess, with a timeout) and a
    rerun resumes from the newest checkpoint and finishes; a SIGTERM
    saves at the end of the step in flight and exits 0."""
import os
import re
import shutil
import signal
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import torch

from repro.launch import train as jtrain
from repro_torch.checkpoint import checkpoint as ck
from repro_torch.launch import train as train_mod
from repro_torch.launch.train import StragglerMonitor, train

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
ARGS = ["--reduced", "--seq-len", "32", "--global-batch", "4",
        "--device", "cpu"]
TIMEOUT = 120


def _shape(line: str) -> str:
    """A [train] line with its numbers and the mesh / device masked."""
    line = re.sub(r"mesh \{.*\}|device \S+", "<where>", line)
    return re.sub(r"-?\d+(\.\d+)?(e[-+]\d+)?", "#", line)


def _train_lines(out: str):
    """The masked [train] lines of a run's output, without the straggler
    lines: those report the host's wall time of a step, which neither
    training driver fixes (a loaded host flags a step in either)."""
    return [_shape(x) for x in out.splitlines()
            if x.startswith("[train]")
            and not x.startswith("[train] straggler:")]


LINES_ARGV = ["--reduced", "--steps", "6", "--seq-len", "32",
              "--global-batch", "4", "--log-every", "2"]


def _reference_lines(capsys):
    before = signal.getsignal(signal.SIGTERM)
    try:
        jtrain.train(LINES_ARGV)
    finally:   # the reference leaves its handler installed
        signal.signal(signal.SIGTERM, before)
    return _train_lines(capsys.readouterr().out), before


def test_prints_the_reference_lines_and_the_loss_falls(capsys):
    want, before = _reference_lines(capsys)
    losses = train(LINES_ARGV + ["--device", "cpu"])
    got = _train_lines(capsys.readouterr().out)
    assert got == want and len(got) == 5, (got, want)
    assert signal.getsignal(signal.SIGTERM) is before
    # the README's command: the reference driver's default batch
    losses = train(["--reduced", "--steps", "20", "--device", "cpu"])
    assert all(np.isfinite(losses))
    assert np.mean(losses[-5:]) < np.mean(losses[:5]) - 1.0, losses


class _SlowStepClock:
    """A `time` stand-in whose fourth step takes 10 s (`launch.train` reads
    the clock twice a step)."""

    def __init__(self):
        self.t, self.calls = 0.0, 0

    def time(self):
        self.calls += 1
        self.t += 10.0 if self.calls == 8 else 0.01
        return self.t


def test_a_slow_port_step_keeps_the_reference_lines(capsys, monkeypatch):
    want, _ = _reference_lines(capsys)
    monkeypatch.setattr(train_mod, "time", _SlowStepClock())
    train(LINES_ARGV + ["--device", "cpu"])
    out = capsys.readouterr().out
    assert "[train] straggler: step 3 took 10.00s" in out, out
    assert _train_lines(out) == want and len(want) == 5, (out, want)


def test_resume_from_a_periodic_checkpoint_equals_the_straight_run(tmp_path):
    a, b = tmp_path / "a", tmp_path / "b"
    straight = train(ARGS + ["--steps", "8", "--ckpt-dir", str(a),
                             "--ckpt-every", "3"])
    assert ck.list_steps(str(a)) == [4, 7, 8]
    shutil.copytree(a, b)
    for s in (7, 8):
        shutil.rmtree(b / f"step_{s:08d}")
    resumed = train(ARGS + ["--steps", "8", "--ckpt-dir", str(b)])
    assert resumed == straight[4:]
    want = np.load(a / "step_00000008" / "arrays.npz")
    got = np.load(b / "step_00000008" / "arrays.npz")
    assert sorted(got) == sorted(want)
    for k in want:
        assert np.array_equal(got[k], want[k]), k
    assert int(got["opt/step"]) == 8


def _run(argv, **kw):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               OMP_NUM_THREADS="2")
    return subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.train", *argv],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True, **kw)


def test_simulated_failure_exits_17_and_a_rerun_resumes(tmp_path):
    argv = ARGS + ["--steps", "8", "--ckpt-dir", str(tmp_path),
                   "--ckpt-every", "2", "--log-every", "1"]
    proc = _run(argv + ["--simulate-failure", "6"])
    out, _ = proc.communicate(timeout=TIMEOUT)
    assert proc.returncode == 17, out
    assert "[train] SIMULATED FAILURE at step 6" in out
    assert "step     5" in out and "step     6" not in out
    proc = _run(argv)
    out, _ = proc.communicate(timeout=TIMEOUT)
    assert proc.returncode == 0, out
    # the save after step 4 (5 updates) is written by a thread the exit
    # may cut short; the one after step 2 (3 updates) is then the newest
    m = re.search(r"restored step (\d+) \(data cursor (\d+)\)", out)
    restored = int(m.group(1))
    assert restored in (3, 5) and int(m.group(2)) == restored
    assert f"step {restored:5d}" in out and "SIMULATED" not in out
    assert "[train] done" in out
    assert ck.latest_step(str(tmp_path)) == 8


def test_sigterm_saves_at_the_end_of_the_step_and_exits_0(tmp_path):
    proc = _run(ARGS + ["--steps", "10000", "--ckpt-dir", str(tmp_path),
                        "--log-every", "1"])
    try:
        for line in proc.stdout:
            if line.startswith("[train] step"):
                break
        proc.send_signal(signal.SIGTERM)
        out, _ = proc.communicate(timeout=TIMEOUT)
    finally:
        proc.kill()
    assert proc.returncode == 0, out
    step = int(re.search(r"preempted at step (\d+)", out).group(1))
    saved = ck.latest_step(str(tmp_path))
    assert saved == step >= 1
    data = np.load(tmp_path / f"step_{saved:08d}" / "arrays.npz")
    assert int(data["opt/step"]) == saved


def test_straggler_monitor_flags_slow_steps():
    m, jm = StragglerMonitor(), jtrain.StragglerMonitor()
    for dt in (1.0, 1.1, 0.9, 5.0, 1.0, 3.0):
        assert m.observe(dt) == jm.observe(dt)
    assert m.flagged == jm.flagged == 2 and m.ema == jm.ema
    assert jax.devices()[0].platform == "cpu"
