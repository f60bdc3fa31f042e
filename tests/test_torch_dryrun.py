"""PyTorch port: the dry-run's cells and CLI (`launch/steps.py`,
`launch/dryrun.py`, `launch/report.py`) on the CPU, on meta tensors.

  * `batch_shardings` and `cache_shardings` (stripe and shared pools)
    against the reference's specs on the 16×16 and 2×16×16 meshes, every
    arch (the port's mesh of meta devices, the reference's an
    `AbstractMesh`).
  * The fusible hints of every (arch, shape) cell equal the reference's.
  * Per-device argument bytes of every applicable cell on the 16×16 mesh
    equal the reference's own shard arithmetic: its `build_cell`'s
    in_shardings (captured from its `jax.jit` call) and
    `NamedSharding.shard_shape` over the abstract mesh.
  * On meta, every kernel wrapper takes its plain version and builds
    nothing.
  * The CLI: `run_cell` for full-width qwen1.5-0.5b × the four shapes at
    `--chips 1` returns the reference's record keys and statuses, and
    `report.roofline_table` renders them; `main` prints the summary; a
    step that reads a value to the host is recorded as an error with the
    reason; a production-mesh cell is an even split with no collective
    term.
  * The bound of a step's function (`steps.function_cost`): a decode
    cell's bytes are the weights, the pages live at its context (stripe
    and shared pools) and one new token's K/V, from the config's widths;
    a train cell's FLOPs are 3x its forward's (causal attention, the LM
    head on every position); a window caps the pairs a local layer
    scores; on every qwen cell the function's bound lies under the eager
    program's count, and on a decode and a train cell of every family
    (reduced) the function's FLOPs and bytes lie under the count's.
"""
import dataclasses
import json
import math

import jax
import pytest
import torch
from jax.sharding import AbstractMesh

from repro.configs import ASSIGNED_ARCHS, SHAPES
from repro.configs import get_config as jget
from repro.configs import shape_applicable
from repro.core.engine import plan_sharding as jplan
from repro.distributed import sharding as jshd
from repro.launch import roofline as jrl
from repro.launch import steps as jsteps
from repro_torch.configs.base import EngineConfig as TEng
from repro_torch.configs.base import ShapeConfig as TShape
from repro_torch.configs import get_config as tget
from repro_torch.core.engine import plan_sharding as tplan
from repro_torch.distributed import sharding as tshd
from repro_torch.launch import dryrun, op_cost, report
from repro_torch.launch import steps as tsteps
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import transformer as ttf

META = torch.device("meta")


def _meshes(multi_pod):
    if multi_pod:
        return (AbstractMesh((2, 16, 16), ("pod", "data", "model")),
                make_production_mesh(multi_pod=True, devices=[META] * 512))
    return (AbstractMesh((16, 16), ("data", "model")),
            make_production_mesh(devices=[META] * 256))


def _specs(tree):
    """name -> spec tuple of a dict or dataclass of shardings."""
    items = (tree.items() if isinstance(tree, dict)
             else vars(tree).items())
    return {k: None if v is None else tuple(v.spec) for k, v in items}


@pytest.mark.parametrize("multi_pod", [False, True])
@pytest.mark.parametrize("arch", ASSIGNED_ARCHS)
def test_shardings_match_the_reference(arch, multi_pod):
    jm, tm = _meshes(multi_pod)
    jcfg, tcfg = jget(arch), tget(arch)
    for name in SHAPES:
        jr = jshd.make_rules(multi_pod=multi_pod)
        tr = tshd.make_rules(multi_pod=multi_pod)
        assert (_specs(tsteps.batch_shardings(tcfg, tsteps.SHAPES[name], tm,
                                              tr))
                == _specs(jsteps.batch_shardings(jcfg, SHAPES[name], jm,
                                                 jr))), name
    for shared in (False, True):
        kw = dict(page_tokens=64, shared_pool=shared)
        from repro.configs.base import EngineConfig as JEng
        from repro.core.engine import KVNANDEngine as JEngine
        from repro_torch.core.engine import KVNANDEngine as TEngine
        je = JEngine(jcfg, JEng(**kw), jsteps.runtime_for(jcfg), jm)
        te = TEngine(tcfg, TEng(**kw), tsteps.runtime_for(tcfg), tm)
        B, ctx = 128, 32776
        enc = 8192 if jcfg.is_encoder_decoder else 0
        jc, tc = (je.abstract_cache(B, ctx, enc_len=enc),
                  te.abstract_cache(B, ctx, enc_len=enc))
        npg = jc.k_pages_g.shape[3] if jc.k_pages_g is not None else 1
        jp, tp = jplan(jm, B, npg), tplan(tm, B, npg)
        assert tp == tsteps.ShardPlan(*jp.__dict__.values())
        assert te.plan(B, ctx) == tsteps.ShardPlan(
            *je.plan(B, ctx).__dict__.values())
        assert (_specs(tsteps.cache_shardings(tc, tm, tp))
                == _specs(jsteps.cache_shardings(jc, jm, jp))), shared


class _Captured:
    def __init__(self, fn, kw):
        self.fn, self.kw = fn, kw


class _JitCapture:
    """Stands in for the `jax` module inside the reference's steps: its
    `jit` keeps the shardings it is given."""

    def __getattr__(self, name):
        return getattr(jax, name)

    @staticmethod
    def jit(fn, **kw):
        return _Captured(fn, kw)


@pytest.mark.parametrize("arch", ASSIGNED_ARCHS)
def test_argument_bytes_and_hints_match_the_reference(arch, monkeypatch):
    monkeypatch.setattr(jsteps, "jax", _JitCapture())
    jm, tm = _meshes(False)
    for name in SHAPES:
        if not shape_applicable(jget(arch), SHAPES[name])[0]:
            assert tsteps.build_cell(arch, name, tm, multi_pod=False) is None
            continue
        jc = jsteps.build_cell(arch, name, jm, multi_pod=False)
        leaves = jax.tree.leaves(jc.abstract_args)
        shs = jax.tree.leaves(jc.jitted.kw["in_shardings"])
        want = sum(math.prod(s.shard_shape(x.shape)) * x.dtype.itemsize
                   for x, s in zip(leaves, shs))
        tc = tsteps.build_cell(arch, name, tm, multi_pod=False)
        assert tc.argument_bytes == want, name
        assert tc.fusible_last2 == jc.fusible_last2, name
        assert (tc.kind, tc.chips, tc.note.split()[0]) == (
            jc.kind, jc.chips, jc.note.split()[0]), name


def test_meta_tensors_take_the_plain_versions(monkeypatch):
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.paged_attention.ops import \
        paged_attention_partial
    from repro_torch.kernels.quant_gemv import quant_gemv
    from repro_torch.kernels.wkv6.ops import wkv6
    from repro_torch.core.quant import quantize_weight

    def no_build(*a, **k):
        raise AssertionError("a meta call started a kernel build")
    monkeypatch.setattr(_build, "build", no_build)
    m = lambda *s, dt=torch.float32: torch.empty(s, dtype=dt, device=META)
    assert flash_attention(m(2, 8, 4, 32), m(2, 8, 2, 32),
                           m(2, 8, 2, 32)).device == META
    qw = quantize_weight(m(64, 16), "w4a16")
    assert quant_gemv(m(3, 64), qw).shape == (3, 16)
    o, mx, l = paged_attention_partial(
        m(2, 4, 32), m(2, 2, 3, 16, 32), m(2, 2, 3, 16, 32),
        m(2, 3, dt=torch.int32), m(2, dt=torch.int32))
    assert o.shape == (2, 4, 32) and o.device == META
    out, st = wkv6(*(m(1, 40, 2, 8) for _ in range(4)), m(2, 8),
                   m(1, 2, 8, 8))
    assert out.shape == (1, 40, 2, 8) and st.device == META


# reference record keys (`src/repro/launch/dryrun.py::run_cell`)
REF_OK_KEYS = {"arch", "shape", "multi_pod", "chips", "status", "note",
               "lower_s", "compile_s", "memory", "roofline",
               "bytes_per_device"}
REF_SKIP_KEYS = {"arch", "shape", "multi_pod", "status", "reason"}


def test_run_cell_at_one_chip_and_the_report(tmp_path, monkeypatch):
    monkeypatch.setattr(dryrun, "ARTIFACT_DIR", str(tmp_path))
    monkeypatch.setattr(report, "ART", str(tmp_path))
    for name in SHAPES:
        rec = dryrun.run_cell("qwen1.5-0.5b", name, chips=1, verbose=False)
        ok = shape_applicable(jget("qwen1.5-0.5b"), SHAPES[name])[0]
        assert rec["status"] == ("ok" if ok else "skipped"), rec
        assert set(rec) >= (REF_OK_KEYS if ok else REF_SKIP_KEYS), name
        if ok:
            assert rec["terms"] == "exact" and rec["chips"] == 1
            assert set(rec["roofline"]) == {
                f.name for f in dataclasses.fields(jrl.Roofline)}
            assert rec["memory"]["argument_bytes"] > 0
            assert rec["roofline"]["flops"] > 0
            assert rec["roofline"]["collective_s"] == 0.0
            b, r = rec["bound"], rec["roofline"]
            assert 0 < b["flops"] <= r["flops"]
            assert 0 < b["bytes"] <= r["bytes_accessed"]
            assert b["bound_s"] == max(b["compute_s"], b["memory_s"])
        dryrun.save_record(rec)
    table = report.roofline_table("chips1").splitlines()
    assert len(table) == 2 + 4
    assert "| qwen1.5-0.5b | decode_32k |" in table[4]
    assert "skipped" in table[5]
    saved = json.loads((tmp_path /
                        "qwen1.5-0.5b__decode_32k__chips1.json").read_text())
    assert saved["mesh"] == "chips1" and saved["status"] == "ok"


def test_main_summary_and_exit_code(tmp_path, monkeypatch, capsys):
    monkeypatch.setattr(dryrun, "ARTIFACT_DIR", str(tmp_path))
    with pytest.raises(SystemExit) as e:
        dryrun.main(["--arch", "qwen1.5-0.5b", "--shape", "decode_32k",
                     "--chips", "1"])
    assert e.value.code == 0
    out = capsys.readouterr().out
    assert "=== dry-run summary: 1 ok, 0 skipped (documented), 0 errors" \
        in out


def test_a_host_read_is_an_error_with_its_reason(monkeypatch):
    cell = tsteps.build_cell("qwen1.5-0.5b", "decode_32k",
                             make_production_mesh(devices=[META] * 256),
                             multi_pod=False)

    def reads_the_host(params, cache, tokens):
        return int(cache.lengths.max())

    monkeypatch.setattr(dryrun, "build_cell", lambda *a, **k: type(cell)(
        **dict(vars(cell), jitted=reads_the_host)))
    rec = dryrun.run_cell("qwen1.5-0.5b", "decode_32k", verbose=False)
    assert rec["status"] == "error" and "meta" in rec["error"].lower()


def test_a_production_mesh_cell_is_an_even_split(monkeypatch):
    seen = []
    monkeypatch.setattr(dryrun, "build_cell", lambda *a, **k: seen.append(
        tsteps.build_cell(*a, **k)) or seen[-1])
    count = dryrun.op_cost.count
    monkeypatch.setattr(dryrun.op_cost, "count", lambda *a, **k: seen.append(
        count(*a, **k)) or seen[-1])
    rec = dryrun.run_cell("qwen1.5-0.5b", "decode_32k", verbose=False)
    assert rec["status"] == "ok" and rec["terms"] == "even_split"
    assert rec["chips"] == 256 and rec["mesh"] == "single"
    cell, cost = seen              # the cell and the count run_cell made
    r, mem = rec["roofline"], rec["memory"]
    assert r["collective_bytes"] is None and r["collective_s"] is None
    assert r["flops"] == cost.flops / 256
    assert r["bytes_accessed"] == cost.bytes_accessed / 256
    assert cell.dp_shards == 16       # the batch over `data`
    assert mem["temp_bytes"] == cost.peak_bytes / 16
    assert mem["argument_bytes"] == cell.argument_bytes
    assert mem["total_bytes"] == mem["argument_bytes"] + mem["temp_bytes"]


def _reduced_cell(monkeypatch, shape, overrides=None):
    monkeypatch.setattr(tsteps, "get_config",
                        lambda a: tget(a).reduced())
    mesh = tshd.Mesh([META], ("data", "model"), shape=(1, 1))
    cell = tsteps.build_cell("qwen1.5-0.5b", shape, mesh, multi_pod=False,
                             eng_overrides=overrides)
    cost = op_cost.count(cell.jitted, *cell.abstract_args,
                         fusible_last2=cell.fusible_last2)
    return cell, cost, tsteps.function_cost(cell, cost)


def _nbytes(tree):
    return sum(t.numel() * t.element_size()
               for t in op_cost.tensor_leaves(tree))


def _matrices(cfg):
    """A dense tied model's products a token: its layers' projections and
    the LM head (norms and biases are no products)."""
    d = cfg.d_model
    return (cfg.n_layers * (d * (cfg.q_dim + 2 * cfg.kv_dim)
                            + cfg.q_dim * d + 3 * d * cfg.d_ff)
            + cfg.padded_vocab * d)


@pytest.mark.parametrize("shared", [False, True])
def test_the_function_bound_of_a_decode_cell(monkeypatch, shared):
    B, S, T = 3, 40, 16
    over = dict(page_tokens=T)
    if shared:
        over.update(shared_pool=True, total_pages=64)
    cell, cost, (flops, nbytes) = _reduced_cell(
        monkeypatch, TShape("d", S, B, "decode"), over)
    cfg = tget("qwen1.5-0.5b").reduced()
    params, cache, toks = cell.abstract_args
    if shared:
        assert cache.k_pages_g.shape[2] == 64     # P physical pages
    need = -(-(S + 1) // T)                       # pages the step reads
    per_token = cfg.n_layers * B * cfg.n_kv_heads * cfg.d_head * 2  # bf16
    pools = 2 * per_token * (need * T + 1)        # K and V: read, append
    tables = _nbytes([cache.page_table_g]) + 2 * _nbytes([cache.lengths])
    assert cost.output_bytes in (B * cfg.padded_vocab * e for e in (2, 4))
    L, H, dh = cfg.n_layers, cfg.n_heads, cfg.d_head
    assert flops == (2 * _matrices(cfg) * B
                     + 4 * H * dh * L * B * (S + 1)) <= cost.flops
    assert nbytes == (_nbytes(params) + B * 4 + pools + tables
                      + cost.output_bytes)


def test_the_function_bound_of_a_train_cell(monkeypatch):
    B, S = 2, 32
    cell, cost, (flops, nbytes) = _reduced_cell(
        monkeypatch, TShape("t", S, B, "train"))
    cfg = tget("qwen1.5-0.5b").reduced()
    state, batch = cell.abstract_args
    L, H, dh = cfg.n_layers, cfg.n_heads, cfg.d_head
    assert flops == 3 * (2 * _matrices(cfg) * B * S
                         + 4 * H * dh * L * B * S * (S + 1) / 2)
    saved = cfg.n_layers * B * S * cfg.d_model * 2
    assert cell.saved_bytes == saved
    assert cost.alias_bytes + cost.output_bytes >= _nbytes(state)
    assert nbytes == (_nbytes(cell.abstract_args) + cost.alias_bytes
                      + cost.output_bytes + saved)


def test_a_window_caps_the_function_flops():
    cfg = tget("gemma3-12b").reduced()
    S, w = 4 * cfg.window, cfg.window
    local = sum(ttf.layer_window(cfg, i) is not None
                for i in range(cfg.n_layers))
    assert 0 < local < cfg.n_layers
    per_pair = 4 * cfg.n_heads * cfg.d_head
    for kind, full, capped in (
            ("decode", S + 1, w),
            ("prefill", S * (S + 1) / 2, w * (w + 1) / 2 + (S - w) * w)):
        f = tsteps.function_flops(cfg, TShape("s", S, 2, kind))
        no_window = tsteps.function_flops(
            dataclasses.replace(cfg, window=None), TShape("s", S, 2, kind))
        assert no_window - f == per_pair * 2 * local * (full - capped)


@pytest.mark.parametrize("arch", ["gemma3-12b", "mixtral-8x7b", "rwkv6-3b",
                                  "hymba-1.5b", "whisper-base",
                                  "pixtral-12b"])
def test_the_function_needs_no_more_than_the_program_does(monkeypatch,
                                                          arch):
    monkeypatch.setattr(tsteps, "get_config", lambda a: tget(a).reduced())
    mesh = tshd.Mesh([META], ("data", "model"), shape=(1, 1))
    for shape in (TShape("d", 256, 2, "decode"),
                  TShape("t", 320, 1, "train")):   # > 256 patches
        cell = tsteps.build_cell(arch, shape, mesh, multi_pod=False)
        cost = op_cost.count(cell.jitted, *cell.abstract_args,
                             fusible_last2=cell.fusible_last2)
        flops, nbytes = tsteps.function_cost(cell, cost)
        assert 0 < flops <= cost.flops, (shape.kind, flops, cost.flops)
        assert 0 < nbytes <= cost.bytes_accessed + cost.fusible_bytes
