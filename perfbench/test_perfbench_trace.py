"""The trace reduction on hand-made Chrome traces: the busy phase's
window between its markers and its busy time, the ranges phase's device
time attributed by launch and its idle gaps named by the host."""
import pytest

from perfbench import trace


def _x(cat, name, ts, dur, corr=None):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


BUSY = [
    _x("kernel", "at::spin_kernel(long)", 0, 1),
    _x("kernel", "gemv_kernel<0>", 10, 20),
    _x("kernel", "elementwise", 20, 25),
    _x("gpu_memcpy", "Memcpy DtoH", 70, 10),
    _x("kernel", "at::spin_kernel(long)", 99, 1),
]

RANGES = [
    _x("user_annotation", "perfbench.step", 0, 100),
    _x("user_annotation", "perfbench.moe", 10, 30),
    _x("cpu_op", "aten::mm", 12, 5),
    _x("cuda_runtime", "cudaLaunchKernel", 13, 1, corr=1),
    _x("cuda_runtime", "cudaLaunchKernel", 50, 1, corr=2),
    _x("cpu_op", "aten::item", 60, 20),
    _x("kernel", "gemv_kernel<0>", 20, 10, corr=1),
    _x("kernel", "elementwise", 55, 5, corr=2),
    _x("gpu_memcpy", "Memcpy DtoH", 90, 10),
]


def test_busy_phase_by_hand():
    tr = trace.reduce_busy(BUSY)
    assert tr.window_s == pytest.approx(100e-6)
    # 10-45 and 70-80; the markers are left out
    assert tr.busy_s == pytest.approx(45e-6)
    assert [n for n, _ in tr.top_ops()] == ["elementwise", "gemv_kernel<0>",
                                             "Memcpy DtoH"]


def test_ranges_phase_by_hand():
    tr = trace.reduce_ranges(RANGES, trace.Trace(1.0, 0.5, []))
    assert tr.ranges_busy_s == pytest.approx(25e-6)
    assert tr.time_in("moe") == pytest.approx(10e-6)
    assert tr.time_in("moe", "gemv") == pytest.approx(10e-6)
    assert tr.time_in("b1") == 0
    gaps = dict(tr.top_gaps())
    # 0-20 inside the step only; 30-55 in moe's range; 60-90 aten::item
    assert gaps["perfbench.step"] == pytest.approx(20e-6)
    assert gaps["perfbench.moe"] == pytest.approx(25e-6)
    assert gaps["aten::item"] == pytest.approx(30e-6)


def test_no_steps_no_reading():
    assert trace.reduce_busy([]).busy_s == 0
    tr = trace.reduce_ranges([_x("kernel", "k", 0, 1, corr=1)],
                             trace.Trace(0.0, 0.0, []))
    assert tr.ops == [] and tr.gaps == []
