"""The benchmark's files: every name in BENCHMARK.json finds its file,
the files parse, and BENCHMARK.json keeps to the benchmark's contract."""
import json
import re

import pytest

from perfbench import cost, spec

BENCH = spec.benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["perfbench"]
    assert BENCH["command"] == ["python3", "perfbench/run.py"]
    assert 1 <= BENCH["run_seconds"] <= 51
    n = len(BENCH["workloads"])
    runs = 2 + 14 * 24
    assert runs * (BENCH["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200
    assert 1 <= n <= 24


@pytest.mark.parametrize("w", BENCH["workloads"], ids=lambda w: w["name"])
def test_workload_files(w):
    cell = spec.resolve(w["name"], BENCH)
    assert w["chips"] in (1, 4)
    assert len(w["why"]) <= 200 and NAME.match(w["name"])
    for key in ("batch_slots", "max_context", "prefill_chunk_tokens",
                "page_tokens", "kv_dtype", "shared_pool", "arch"):
        assert key in cell["server"]
    limits = cell["check"]["limits"]
    assert limits and set(limits) <= {"logit_gap", "logprob_err_median",
                                      "logprob_err_req_max"}
    assert all(v > 0 for v in limits.values())
    assert cell["server"]["prefill_chunk_tokens"] % \
        cell["server"]["page_tokens"] == 0
    e2e = [m["name"] for m in spec.metrics_for(w["name"], False, BENCH)]
    assert "setup_s" in e2e and len(e2e) >= 2
    assert spec.metrics_for(w["name"], True, BENCH)


@pytest.mark.parametrize("c", BENCH["configs"], ids=lambda c: c["name"])
def test_config_files(c):
    conf = spec.load(spec.REPO / c["file"])
    assert c["file"].startswith("perfbench/configs/")
    assert conf["source"] == c["source"] and conf["name"] == c["name"]
    assert conf["reduced"] == c["reduced"]
    assert any(w["config"] == c["name"] for w in BENCH["workloads"])


@pytest.mark.parametrize("m", BENCH["end_to_end"] + BENCH["per_layer"],
                         ids=lambda m: m["name"])
def test_metric_entries(m):
    assert NAME.match(m["name"]) and UNIT.match(m["unit"])
    assert m["better"] in ("lower", "higher")
    assert spec.reader_path(m["name"]).is_file()
    if "bound" in m:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    else:
        e2e = {e["name"]: e for e in BENCH["end_to_end"]}
        assert m["moves"] in e2e and m["moves"] != "setup_s"
        moved = e2e[m["moves"]].get("workloads")
        # every cell that reports it also reports the metric it moves
        assert moved is None or set(m.get("workloads", moved)) <= set(moved)
    if "_roofline" in m["name"] or "mfu" in m["name"]:
        assert m["unit"] == "%"
    for w in m.get("workloads", []):
        assert any(x["name"] == w for x in BENCH["workloads"])


def test_traffic_files_parse():
    for w in BENCH["workloads"]:
        mix = spec.load(spec.PERFBENCH / "traffic" / f"{w['traffic']}.json")
        for key in ("prompt_tokens", "output_tokens"):
            d = mix[key]
            assert d["dist"] == "lognormal" and d["min"] <= d["median"] <= \
                d["max"]


def test_parameter_counts():
    conf = {c["name"]: spec.load(spec.REPO / c["file"])["model"]
            for c in BENCH["configs"]}
    assert round(cost.param_count(conf["mixtral-8x7b-w4a16"]) / 1e9, 2) \
        == 46.70
    assert round(cost.param_count(conf["pixtral-12b-text-w4a16"]) / 1e9,
                 3) == 12.248


def test_file_size_and_json():
    raw = (spec.REPO / "BENCHMARK.json").read_text()
    assert len(raw.encode()) <= 64 * 1024
    json.loads(raw)
