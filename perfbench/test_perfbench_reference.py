"""The plain reference against the program (`repro_torch`) at a tiny
size on the CPU, through the harness's whole run: a sound run is correct,
and the comparison fails the faults the timed path can have.  The
reference's own modules import nothing of the program (see
test_perfbench_nojax.py)."""
import math

import pytest
import torch

from perfbench import harness, reference, testcells

SEED = 2 ** 31 + 4099


NO_METRICS = {"end_to_end": [], "per_layer": []}


def _out(cell, **kw):
    return harness.run_cell(cell, kw.pop("seed", SEED), 0.0, False, "cpu",
                            0.0, window_steps=40, **kw)


def _run(cell, **kw):
    return _out(cell, **kw)["check"]


def _correct(cell, **kw):
    """The whole run's verdict, as the result line gives it."""
    line, _ = harness.result(_out(cell, **kw), NO_METRICS, "tiny", False,
                             "cpu")
    return line["correct"]


@pytest.mark.parametrize("moe,docs", [(True, False), (False, True)],
                         ids=["moe-chat", "dense-docqa"])
def test_sound_run_is_correct(moe, docs):
    cell = testcells.cell(moe=moe, docs=docs)
    out = _out(cell)
    chk = out["check"]
    assert chk["tokens"] >= 20
    for name, limit in cell["check"]["limits"].items():
        assert chk[name] <= limit, name
    line, _ = harness.result(out, NO_METRICS, "tiny", False, "cpu")
    assert line["correct"]
    if moe:
        assert chk["dropped_pairs"] > 0     # chunks that drop pairs
        assert chk["requests"] >= 4


def test_moe_plan_matches_the_programs_route():
    """Capacity drops: the reference's plan of a 64-row chunk keeps the
    pairs the port's `moe_route` keeps, at a capacity that drops many."""
    from repro_torch.models.layers import moe_route
    g = torch.Generator().manual_seed(3)
    D, E, S = 32, 4, 64
    x = torch.randn(S, D, generator=g)
    router = torch.randn(D, E, generator=g)
    m = {"n_experts": E, "top_k": 2, "capacity_factor": 0.5}
    ref = reference.Reference(m, {}, chunk=S)
    seq = reference.Seq(torch.zeros(S, dtype=torch.long), 0, S)
    idx, vals, kept = ref._moe_plan(x, router, seq)
    r = moe_route({"router_w": router}, x[None], top_k=2,
                  capacity_factor=0.5)
    assert r.capacity == math.ceil(0.5 * 2 * S / E)
    assert torch.equal(idx, r.top_idx[0])
    assert torch.equal(kept.reshape(-1), r.keep[0])
    assert torch.allclose(vals, r.top_vals[0])
    assert ref.dropped_pairs > 0


def _stale_state(srv):
    """A decode step that leaves the cache's lengths as they were."""
    eng = srv.engine
    fn = eng.decode_step

    def step(params, cache, tokens, active=None):
        keep = cache.lengths.clone()
        out = fn(params, cache, tokens, active=active)
        cache.lengths.copy_(keep)
        return out

    eng.decode_step = step


def _half_batch(srv):
    """The second half of the decode batch left out: its rows get the
    mean of the first half's logits."""
    eng = srv.engine
    fn = eng.decode_step

    def step(*a, **k):
        logits, cache = fn(*a, **k)
        B = logits.shape[0]
        logits = logits.clone()
        logits[B // 2:] = logits[:B // 2].mean(0)
        return logits, cache

    eng.decode_step = step


def _altered_token(monkeypatch, every: int):
    """A token altered where it is produced: the first row's token of
    every `every`-th sampling call."""
    from repro_torch.serving import scheduler
    orig = scheduler.sample_with_logprobs
    n = [0]

    def sample(*a, **k):
        toks, lps = orig(*a, **k)
        n[0] += 1
        if n[0] % every == 0:
            toks = toks.clone()
            toks[0] = (toks[0] + 1) % 512
        return toks, lps

    monkeypatch.setattr(scheduler, "sample_with_logprobs", sample)


# The MoE cell compares medians (its widest gap is a routing property:
# PERF.md), so the token it catches altered is one row's on every call;
# the dense cell's widest gap catches one call in five.
@pytest.mark.parametrize("moe,fault", [
    (True, "stale_state"), (True, "half_batch"), (True, "altered_token"),
    (False, "stale_state"), (False, "half_batch"), (False, "altered_token"),
], ids=["moe-stale_state", "moe-half_batch", "moe-altered_token",
        "dense-stale_state", "dense-half_batch", "dense-altered_token"])
def test_faults_are_not_correct(moe, fault, monkeypatch):
    faults = {"stale_state": _stale_state, "half_batch": _half_batch}
    if fault == "altered_token":
        _altered_token(monkeypatch, every=1 if moe else 5)
    cell = testcells.cell(moe=moe, docs=not moe)
    assert not _correct(cell, fault=faults.get(fault))


@pytest.mark.parametrize("moe", [True, False], ids=["moe", "dense"])
def test_control_reads_above_the_sound_run(moe):
    """The control (kv8 pages, W8A8 2-D projections: the configuration's
    bf16 lowered to int8) on a vocabulary of 8192, where margins are
    small enough for its noise to move a greedy token:
    reads a wider gap and a larger median logprob error than the sound
    run.  (At the cells' own size the chip holds it to the cell's limits:
    PERF.md.)"""
    cell = testcells.cell(moe=moe, docs=not moe)
    cell["model"]["vocab_size"] = 8192
    cell["check"]["sample_tokens"] = 120
    sound = _run(cell, seed=11)
    control = _run(cell, seed=11, control=True)
    assert control["logit_gap"] > sound["logit_gap"]
    assert control["logprob_err_median"] > sound["logprob_err_median"]
    assert control["logprob_err_req_max"] > sound["logprob_err_req_max"]
