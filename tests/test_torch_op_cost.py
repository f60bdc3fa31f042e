"""PyTorch port: the dry-run's op counter (`launch/op_cost.py`) on meta
tensors, and its FLOP parity with the reference's HLO counter.

  * The torch forms of `tests/test_hlo_cost.py`'s four cases: a loop of 8
    matmuls counts 8·2·M·D·D and a nested 4 × 3 loop 12·2·M·D·D (eager
    code dispatches every iteration, so the loop count is the trip
    count); the score hint moves bytes into `fusible_bytes` and keeps
    their sum; bytes scale with the loop count.
  * A packed W4A16 dequant counts as its packed read (the codes, not the
    bf16 weight the plain version unpacks), and the peak follows the
    storages alive at once.
  * FLOP parity: reduced qwen1.5-0.5b's train, prefill and decode cells,
    built by both packages' `steps.build_cell` on one device (the
    reference's lowered and compiled on the CPU, read by
    `hlo_cost.analyze_compiled`; the port's counted on meta), agree
    within 5%: the measured gap is 0 on all three.  The reference's
    decode cell does not trace with bf16 activations (its layer scan's
    carry comes back f32; ROADMAP §C), so the decode pair runs f32
    activations on both sides.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JaxMesh

from repro.configs.base import ShapeConfig as JShape
from repro.configs.base import get_config as jget
from repro.launch import hlo_cost
from repro.launch import steps as jsteps
from repro.models.transformer import Runtime as JRuntime
from repro_torch.configs.base import ShapeConfig as TShape
from repro_torch.configs.base import get_config as tget
from repro_torch.core.quant import quantize_weight
from repro_torch.distributed import sharding as shd
from repro_torch.kernels.quant_gemv import quant_gemv
from repro_torch.launch import op_cost
from repro_torch.launch import steps as tsteps
from repro_torch.models.transformer import Runtime as TRuntime

META = torch.device("meta")


def _m(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device=META)


def _count(fn, *args, hints=frozenset()):
    return op_cost.count(fn, *args, fusible_last2=hints)


def test_loop_of_matmuls_counts_every_iteration():
    D, M = 128, 4
    w, x = _m(8, D, D), _m(M, D)

    def f(w, x):
        y = x
        for i in range(8):
            y = torch.tanh(y @ w[i])
        return y

    assert _count(f, w, x).flops == 8 * 2 * M * D * D


def test_nested_loops_multiply():
    D, M = 64, 2
    w, x = _m(4, 3, D, D), _m(M, D)

    def f(w, x):
        y = x
        for i in range(4):
            for j in range(3):
                y = torch.tanh(y @ w[i, j])
        return y

    assert _count(f, w, x).flops == 12 * 2 * M * D * D


def test_fusible_hint_separates_score_traffic():
    S, dh = 64, 32

    def attn(q, k):
        return torch.softmax(q @ k.T, -1)        # [S, S] scores

    q, k = _m(S, dh), _m(S, dh)
    plain = _count(attn, q, k)
    hinted = _count(attn, q, k, hints={(S, S)})
    assert hinted.fusible_bytes > 0 and plain.fusible_bytes == 0
    assert hinted.bytes_accessed < plain.bytes_accessed
    assert (hinted.bytes_accessed + hinted.fusible_bytes
            == plain.bytes_accessed + plain.fusible_bytes)


def test_bytes_scale_with_loop_count():
    D = 128

    def f(w, x):
        y = x
        for i in range(w.shape[0]):
            y = torch.tanh(y @ w[i])
        return y

    b8 = _count(f, _m(8, D, D), _m(4, D)).bytes_accessed
    b16 = _count(f, _m(16, D, D), _m(4, D)).bytes_accessed
    assert b16 == 2 * b8 > 0
    # one iteration: y and w[i] in, the product out; then tanh in and out
    assert b8 == 8 * (4 * (4 * D + D * D + 4 * D) + 4 * 2 * 4 * D)


def test_packed_w4a16_dequant_counts_its_packed_read():
    D, F, M = 256, 128, 4
    qw = quantize_weight(_m(D, F), "w4a16")
    assert qw.q.shape == (D // 2, F) and qw.q.dtype == torch.uint8
    x = _m(M, D, dtype=torch.bfloat16)
    s = _count(lambda x, qw: quant_gemv(x, qw), x, qw)
    # the product reads x and the packed codes (D/2 bytes a column, not
    # the 2·D of the bf16 weight the plain version unpacks), writes y;
    # then the scale: y to f32, times the f32 scale, back to bf16
    mm = 2 * M * D + D // 2 * F + 2 * M * F
    scale = (2 + 4) * M * F + (4 * M * F + 4 * F + 4 * M * F) \
        + (4 + 2) * M * F
    assert s.flops == 2 * M * F * D
    assert s.bytes_accessed == mm + scale


def test_peak_follows_the_storages_alive_at_once():
    def f(x):
        a = x * 2            # 4 KiB
        b = a + 1            # 4 KiB, a still alive
        del a
        return b.sum()       # a freed: the peak stays at two buffers

    s = _count(f, _m(1024))
    assert s.peak_bytes == 2 * 4096 and s.output_bytes == 4
    x = _m(1024)
    assert _count(lambda x: x.add_(1), x).alias_bytes == 4096


# ---------------------------------------------------------------------------
# FLOP parity with the reference's HLO counter
# ---------------------------------------------------------------------------

SMALL = {"train_4k": ("train", 64, 2), "prefill_32k": ("prefill", 64, 2),
         "decode_32k": ("decode", 64, 2)}
PARITY_TOL = 0.05


@pytest.fixture()
def reduced_cells(monkeypatch):
    """Both packages' `steps` modules building reduced qwen1.5-0.5b at
    small shapes (their module objects patched, the files untouched)."""
    for mod, get, shape in ((jsteps, jget, JShape), (tsteps, tget, TShape)):
        monkeypatch.setattr(mod, "get_config",
                            lambda a, get=get: get(a).reduced())
        monkeypatch.setattr(mod, "SHAPES", {
            k: shape(k, s, b, kind) for k, (kind, s, b) in SMALL.items()})


@pytest.mark.parametrize("shape", list(SMALL))
def test_flops_match_the_reference_hlo_count(reduced_cells, monkeypatch,
                                             shape):
    rt = None
    if shape == "decode_32k":
        monkeypatch.setattr(jsteps, "runtime_for", lambda cfg, kind="serve":
                            JRuntime(activ_dtype=jnp.float32,
                                     attn_impl="ref"))
        rt = TRuntime(activ_dtype=torch.float32, attn_impl="ref")
    jmesh = JaxMesh(np.array(jax.devices()[:1]).reshape(1, 1),
                    ("data", "model"))
    with jmesh:
        jc = jsteps.build_cell("qwen1.5-0.5b", shape, jmesh,
                               multi_pod=False)
        compiled = jc.jitted.lower(*jc.abstract_args).compile()
    want = hlo_cost.analyze_compiled(compiled, jc.fusible_last2)
    tmesh = shd.Mesh([META], ("data", "model"), shape=(1, 1))
    tc = tsteps.build_cell("qwen1.5-0.5b", shape, tmesh, multi_pod=False,
                           rt=rt)
    got = _count(tc.jitted, *tc.abstract_args, hints=tc.fusible_last2)
    gap = abs(got.flops / want.flops - 1)
    assert gap <= PARITY_TOL, (got.flops, want.flops)
    assert got.flops == want.flops            # the gap measured: 0
    assert (tc.argument_bytes
            == compiled.memory_analysis().argument_size_in_bytes)
