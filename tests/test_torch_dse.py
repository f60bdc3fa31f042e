"""PyTorch port: the design-space search (`core/dse.py`) and the flash
simulator it runs on (`core/flashsim.py`), copies of the reference's
jax-free modules, against the reference.

Every registered arch x context in {64, 128, 256, 1024, 10240, 102400}:
`recommend_engine_config`, `heatmap`, `sweep_speculation`,
`recommend_hot_pages` and `recommend_overlap` must give exactly the
reference's answers (floats compared for equality: the code is the same
and runs on the same Python floats).  The paper-figure checks of
tests/test_flashsim.py run again on the port's simulator and configs."""
import dataclasses
import math

import pytest

import test_flashsim
from repro.configs import get_config
from repro.core import dse as jdse
from repro.core import flashsim as jfs
from repro_torch.configs import get_config as tget
from repro_torch.configs import list_configs
from repro_torch.core import dse
from repro_torch.core import flashsim as fs
from repro_torch.launch.serve import serve

CONTEXTS = (64, 128, 256, 1024, 10240, 102400)
ARCHS = sorted(list_configs())


def _same(a, b):
    """Equality that takes NaN as equal to NaN."""
    if isinstance(a, float) and isinstance(b, float):
        return a == b or (math.isnan(a) and math.isnan(b))
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_same(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    return a == b


def _outcome(fn):
    """fn()'s value, or the type of what it raised."""
    try:
        return fn()
    except Exception as e:       # noqa: BLE001 - compared, not hidden
        return type(e).__name__


def test_registry_matches_reference():
    from repro.configs.base import list_configs as jlist
    assert ARCHS == sorted(jlist()) and len(ARCHS) == 15


@pytest.mark.parametrize("ctx", CONTEXTS)
@pytest.mark.parametrize("arch", ARCHS)
def test_dse_matches_reference(arch, ctx):
    cfg, jcfg = tget(arch), get_config(arch)
    got = _outcome(lambda: dataclasses.asdict(
        dse.recommend_engine_config(arch, ctx)))
    want = _outcome(lambda: dataclasses.asdict(
        jdse.recommend_engine_config(arch, ctx)))
    assert _same(got, want)
    assert _same(dse.heatmap(cfg, [ctx]), jdse.heatmap(jcfg, [ctx]))
    assert _same([dataclasses.asdict(p)
                  for p in dse.sweep_speculation(cfg, [ctx])],
                 [dataclasses.asdict(p)
                  for p in jdse.sweep_speculation(jcfg, [ctx])])
    sys_t = fs.kvnand_d(8, 8, 4, 16, kv_bits=8)
    sys_j = jfs.kvnand_d(8, 8, 4, 16, kv_bits=8)
    for slots in (1, 4):
        assert _same(
            _outcome(lambda: dse.recommend_hot_pages(sys_t, cfg, ctx,
                                                     slots=slots)),
            _outcome(lambda: jdse.recommend_hot_pages(sys_j, jcfg, ctx,
                                                      slots=slots)))
    dev_t = _outcome(lambda: fs.serving_step_time(sys_t, cfg, ctx, 0.0,
                                                  overlap=False))
    dev_j = _outcome(lambda: jfs.serving_step_time(sys_j, jcfg, ctx, 0.0,
                                                   overlap=False))
    assert _same(dev_t, dev_j)
    if isinstance(dev_t, float):
        for host in (0.0, 1e-3 * dev_t, dev_t):
            assert _same(
                _outcome(lambda: dse.recommend_overlap(sys_t, cfg, ctx,
                                                       host)),
                _outcome(lambda: jdse.recommend_overlap(sys_j, jcfg, ctx,
                                                        host)))


def test_dse_picks_discrete_kv8_for_llama2_7b_at_128():
    """The deployment the port's full-width card phase serves."""
    eng = dse.recommend_engine_config("llama2-7b", 128)
    assert (eng.variant, eng.hg_pipeline, eng.kv_quant, eng.quant,
            eng.attn_partitions, eng.speculation_k) == (
        "discrete", True, "kv8", "w4a16", 1, 0)


@pytest.mark.parametrize("name", sorted(
    n for n in dir(test_flashsim) if n.startswith("test_")))
def test_flashsim_paper_checks_on_the_port(name, monkeypatch):
    """tests/test_flashsim.py's checks with the port's simulator and
    configs in place of the reference's."""
    monkeypatch.setattr(test_flashsim, "fs", fs)
    monkeypatch.setattr(test_flashsim, "get_config", tget)
    getattr(test_flashsim, name)()


def test_takeaways_and_oom_blanks_on_the_port():
    """tests/test_dse.py's paper takeaways on the port's DSE."""
    assert all(dse.takeaways(tget("opt-30b"), tget("llama3.1-70b")).values())
    grid = dse.heatmap(tget("opt-30b"), [1_000, 50_000, 100_000],
                       total_dies=8, wbits=8, abits=8)
    assert len(grid) == 8
    assert any(math.isinf(row[100_000]) for row in grid.values())
    b_short = dse.best_discrete(tget("llama3.1-70b"), 1_000, 8, 4, 16)
    b_long = dse.best_discrete(tget("llama3.1-70b"), 100_000, 8, 4, 16)
    assert b_long.g2 > b_short.g2


def test_launch_serve_use_dse_serves_the_discrete_pick(capsys):
    outs = serve(["--arch", "llama2-7b", "--use-dse", "--max-context",
                  "128", "--reduced", "--device", "cpu", "--requests", "3",
                  "--max-new", "4", "--slots", "2"])
    assert sorted(outs) == [0, 1, 2]
    assert all(len(o.token_ids) == 4 and o.finish_reason == "length"
               for o in outs.values())
    text = capsys.readouterr().out
    assert "[serve] DSE picked variant=discrete kv_quant=kv8" in text
    assert "3 requests, 12 tokens" in text


@pytest.mark.parametrize("ctx,kv_quant", [(256, "none"), (2048, "kv8")])
@pytest.mark.parametrize("pool", [[], ["--shared-pool"]],
                         ids=["stripe", "shared"])
def test_launch_serve_use_dse_serves_gemma3(ctx, kv_quant, pool, capsys):
    """gemma3-12b's pick: compact, with kv8 pages from 2048 tokens of
    context (twice its window of 1024), served over window rings."""
    outs = serve(["--arch", "gemma3-12b", "--use-dse", "--max-context",
                  str(ctx), "--reduced", "--device", "cpu", "--requests",
                  "3", "--max-new", "4", "--slots", "2"] + pool)
    assert sorted(outs) == [0, 1, 2]
    assert all(len(o.token_ids) == 4 and o.finish_reason == "length"
               for o in outs.values())
    text = capsys.readouterr().out
    assert (f"[serve] DSE picked variant=compact kv_quant={kv_quant}"
            in text)
    assert "3 requests, 12 tokens" in text


def test_launch_serve_use_dse_refuses_partitions_over_a_ring(capsys):
    """From 8192 tokens of context the pick splits the page walk 4 ways,
    which does not divide gemma3-12b's ring (5 pages reduced, 65 at full
    width): exit 2 naming the item, where the reference raises at its
    first decode step."""
    assert dse.recommend_engine_config(
        "gemma3-12b", 8192).attn_partitions == 4
    with pytest.raises(SystemExit) as exc:
        serve(["--arch", "gemma3-12b", "--use-dse", "--max-context", "8192",
               "--reduced", "--device", "cpu"])
    assert exc.value.code == 2
    assert "ROADMAP A24" in capsys.readouterr().err


def test_launch_serve_use_dse_refuses_a_pick_it_cannot_serve(capsys):
    """hymba-1.5b's pick needs the hybrid family: exit 2 naming the item
    that ports it."""
    with pytest.raises(SystemExit) as exc:
        serve(["--arch", "hymba-1.5b", "--use-dse", "--reduced", "--device",
               "cpu"])
    assert exc.value.code == 2
    assert "ROADMAP A15" in capsys.readouterr().err
