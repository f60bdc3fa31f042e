"""PyTorch port: the tiered flash KV hierarchy (hot / capacity page tiers
with queue-ahead prefetch) against the JAX reference on the CPU.

  * `HotTier`, the residency map, op for op against the reference's under
    a random bind / pin / unpin / touch / release sequence: the same
    slots, victims and refusals;
  * `paged_kv.stage_hot_slot` and `read_hot_slot` against the reference's
    staging writer and its scheduler's hot-slot read, over f32, bf16, kv8
    and kv4 pool leaves;
  * a tiered server against the reference's tiered server on the same
    weights and against the port's flat pool, prefetch on and off: a
    two-wave trace (the second wave re-maps pages the first demoted, and
    its exact repeats copy their partial page on write) serves the same
    tokens with the same `tier_*` stats; also at kv8 and under
    speculative decoding (whose rollback unpins span pages);
  * the guards: the submit guard, one-shot prefill's refusal, the window
    arch's refusal; and `launch.serve --hot-pages` on the CPU.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import EngineConfig, get_config
from repro.core import page_alloc as jalloc
from repro.core import paged_kv as jkv
from repro.core.engine import KVNANDEngine as JEngine
from repro.models.registry import Model
from repro.serving.scheduler import ContinuousBatcher as JBatcher
from repro.serving.scheduler import Request as JRequest
from repro_torch import bridge
from repro_torch.configs import EngineConfig as TEngineConfig
from repro_torch.configs import get_config as tget
from repro_torch.core import page_alloc as talloc
from repro_torch.core import paged_kv as tkv
from repro_torch.core.engine import KVNANDEngine
from repro_torch.launch.serve import serve
from repro_torch.serving.api import KVNANDServer, SamplingParams, ServerConfig
from repro_torch.serving.scheduler import ContinuousBatcher, Request

torch.set_num_threads(2)

ARCH = "qwen1.5-0.5b"
N_UNIQ = 6
TOTAL_PAGES = 64
HOT_PAGES = 12
TIER_STATS = ("tier_hot_slots", "tier_hit_pages", "tier_miss_pages",
              "tier_stall_tokens", "tier_promotes", "tier_demotes",
              "tier_prefetch_pages", "tier_peak_hot")
POOL_STATS = ("prefix_hit_pages", "cow_copies", "prompt_pages",
              "pool_peak_pages", "pool_total_pages", "admits",
              "prefill_chunks", "spec_steps", "spec_drafted",
              "spec_accepted")

_CACHE = {}


def _model():
    """(reference cfg, reference params, port cfg, port params): the same
    weights in both frameworks."""
    if "m" not in _CACHE:
        cfg = get_config(ARCH).reduced()
        params = Model(cfg).init(jax.random.PRNGKey(0))
        _CACHE["m"] = (cfg, params, tget(ARCH).reduced(),
                       bridge.params_from_numpy(
                           jax.tree.map(np.asarray, params), "cpu"))
    return _CACHE["m"]


def _trace(vocab):
    """A shared 32-token system prompt + unique 9-token tails: the flash
    pages outgrow HOT_PAGES, so the second wave re-maps demoted pages."""
    rng = np.random.default_rng(23)
    sysp = rng.integers(1, vocab, 32).tolist()
    return [sysp + rng.integers(1, vocab, 9).tolist()
            for _ in range(N_UNIQ)]


def _eng_kw(hot_pages=0, **kw):
    return dict(page_tokens=16, uniform_lengths=False, shared_pool=True,
                total_pages=TOTAL_PAGES, hot_pages=hot_pages,
                kv_dtype="float32", **kw)


def _two_waves(b, req_cls, prompts, max_new=8):
    """Two submission waves of the SAME prompts on one batcher: wave 1
    fills the prefix cache, its pages demote under slot pressure, wave
    2's cached map-ins promote them back."""
    outs = {}
    for wave in range(2):
        for i, p in enumerate(prompts):
            b.submit(req_cls(wave * len(prompts) + i, list(p),
                             max_new=max_new))
        done = b.run_to_completion()
        outs.update({u: (list(r.output), list(r.logprobs))
                     for u, r in done.items()})
    return outs


def _port_batcher(hot_pages=0, prefetch=True, spec_k=0, **eng):
    _, _, tcfg, tparams = _model()
    return ContinuousBatcher(
        tcfg, tparams, batch_slots=3, max_context=64,
        eng=TEngineConfig(**_eng_kw(hot_pages, **eng)),
        prefill_chunk_tokens=16, tier_prefetch=prefetch,
        speculation_k=spec_k, device="cpu")


def _ref_batcher(hot_pages=0, prefetch=True, spec_k=0, **eng):
    cfg, params, _, _ = _model()
    return JBatcher(cfg, params, batch_slots=3, max_context=64,
                    temperature=0.0, eng=EngineConfig(**_eng_kw(hot_pages,
                                                                **eng)),
                    prefill_chunk_tokens=16, tier_prefetch=prefetch,
                    speculation_k=spec_k)


def _tokens(outs):
    return {u: toks for u, (toks, _) in outs.items()}


def _assert_tier_clean(b):
    b.alloc.check()
    b.tier.check()
    # at drain no slot maps pages: every resident must be demotable
    assert b.tier.pinned_count == 0
    assert b.tier.resident_count <= b.tier.hot_slots
    assert int(b._resv.sum()) == 0 and b._outstanding == 0
    assert b._hot_out == 0


# ---------------------------------------------------------------------------
# HotTier: op for op against the reference
# ---------------------------------------------------------------------------

def _tier_state(t):
    return (dict(t._slot_of), list(t._lru), list(t._free_slots),
            t._pins.tolist(), t.promotes, t.demotes)


def _tier_op(t, op, page, avoid):
    try:
        if op == "bind":
            return t.bind(page, avoid=avoid)
        if op == "pin":
            return t.pin(page)
        if op == "unpin":
            return t.unpin(page)
        if op == "touch":
            return t.touch(page)
        return t.release(page)
    except (ValueError, talloc.OutOfHotSlots, jalloc.OutOfHotSlots) as e:
        return type(e).__name__


@pytest.mark.parametrize("seed", range(8))
def test_hot_tier_matches_reference_op_for_op(seed):
    rng = np.random.default_rng(seed)
    hot, total = int(rng.integers(2, 7)), 16
    ref, port = jalloc.HotTier(hot, total), talloc.HotTier(hot, total)
    for _ in range(300):
        resident = sorted(ref._slot_of)
        pinned = [p for p in resident if ref._pins[p] > 0]
        op = rng.choice(["bind", "bind", "pin", "unpin", "unpin", "touch",
                         "release"])
        if op == "pin" and resident:
            page = int(rng.choice(resident))
        elif op == "release":
            unpinned = [p for p in range(total) if ref._pins[p] == 0]
            page = int(rng.choice(unpinned))
        elif op == "unpin" and pinned and rng.random() < 0.8:
            page = int(rng.choice(pinned))
        elif op == "pin":
            continue                  # pin asserts residency
        else:
            page = int(rng.integers(0, total))
        avoid = frozenset(int(p) for p in rng.choice(
            total, int(rng.integers(0, 3)), replace=False))
        got = _tier_op(port, op, page, avoid)
        want = _tier_op(ref, op, page, avoid)
        assert got == want, (op, page, got, want)
        assert _tier_state(port) == _tier_state(ref)
        port.check()
        assert (port.resident_count, port.free_slot_count,
                port.demotable_count, port.pinned_count) == (
            ref.resident_count, ref.free_slot_count, ref.demotable_count,
            ref.pinned_count)
        assert [port.entry(p) for p in range(total)] == \
            [ref.entry(p) for p in range(total)]


def test_hot_tier_refuses_bad_sizes():
    for mod in (jalloc, talloc):
        with pytest.raises(ValueError, match="at least one slot"):
            mod.HotTier(0, 8)
        with pytest.raises(ValueError, match="exceeds"):
            mod.HotTier(9, 8)


# ---------------------------------------------------------------------------
# staging writer and hot-slot read against the reference
# ---------------------------------------------------------------------------

FORMATS = {"f32": dict(kv_dtype="float32"), "bf16": dict(kv_dtype="bfloat16"),
           "kv8": dict(kv_quant="kv8"), "kv4": dict(kv_quant="kv4")}


def _random_leaf(rng, shape, dtype_name):
    if dtype_name == "int8":
        return rng.integers(-127, 128, shape).astype(np.int8)
    if dtype_name == "uint8":
        return rng.integers(0, 256, shape).astype(np.uint8)
    return rng.standard_normal(shape).astype(np.float32)


def _as_np(x):
    """A leaf of either framework as numpy (bf16 upcast exactly)."""
    if isinstance(x, torch.Tensor):
        return (x.float() if x.dtype == torch.bfloat16 else x).numpy()
    x = np.asarray(x)
    return x.astype(np.float32) if x.dtype.name == "bfloat16" else x


@pytest.mark.parametrize("fmt", sorted(FORMATS))
def test_stage_and_read_hot_slot_match_reference(fmt):
    cfg, _, tcfg, _ = _model()
    kw = dict(_eng_kw(HOT_PAGES), **FORMATS[fmt])
    jc = JEngine(cfg, EngineConfig(**kw)).init_cache(3, 64)
    tc = KVNANDEngine(tcfg, TEngineConfig(**kw), device="cpu").init_cache(
        3, 64)
    rng = np.random.default_rng(5)
    names = [n for n in tkv.POOL_LEAVES_G if getattr(tc, n) is not None]
    assert names == [n for n in tkv.POOL_LEAVES_G
                     if getattr(jc, n) is not None]
    assert tc.k_pages_g.shape[2] == jc.k_pages_g.shape[2] == HOT_PAGES
    upd = {}
    for n in names:                      # the same random pool in both
        leaf = getattr(tc, n)
        dname = str(leaf.dtype).split(".")[-1]
        vals = _random_leaf(rng, tuple(leaf.shape), dname)
        leaf.copy_(torch.from_numpy(vals))
        upd[n] = jnp.asarray(vals).astype(getattr(jc, n).dtype)
    jc = dataclasses.replace(jc, **upd)
    for n in names:
        np.testing.assert_array_equal(_as_np(getattr(tc, n)),
                                      _as_np(getattr(jc, n)))
    # a page's bytes into hot slot 7 (every leaf at page axis 2)
    page = {}
    for n in names:
        leaf = getattr(tc, n)
        dname = str(leaf.dtype).split(".")[-1]
        page[n] = _random_leaf(rng, tuple(leaf[:, :, 0].shape), dname)
    tkv.stage_hot_slot(tc, 7, {n: torch.from_numpy(v).to(getattr(tc, n).dtype)
                               for n, v in page.items()})
    jc = jax.jit(jkv.stage_hot_slot)(
        jc, jnp.asarray(7, jnp.int32), {n: jnp.asarray(v)
                                        for n, v in page.items()})
    for n in names:
        np.testing.assert_array_equal(_as_np(getattr(tc, n)),
                                      _as_np(getattr(jc, n)), err_msg=n)
    # the read: the reference scheduler's `_read_hot`
    for slot in (0, 7, HOT_PAGES - 1):
        got = tkv.read_hot_slot(tc, slot)
        assert sorted(got) == sorted(names)
        for n in names:
            np.testing.assert_array_equal(
                _as_np(got[n]), _as_np(getattr(jc, n)[:, :, slot]))
    # a read is a copy: staging it elsewhere round-trips the bytes
    tkv.stage_hot_slot(tc, 2, tkv.read_hot_slot(tc, 7))
    for n in names:
        assert torch.equal(getattr(tc, n)[:, :, 2], getattr(tc, n)[:, :, 7])


# ---------------------------------------------------------------------------
# the tiered server against the reference's and against the flat pool
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("prefetch", [True, False],
                         ids=["prefetch", "noprefetch"])
def test_tiered_server_matches_reference_and_flat_pool(prefetch):
    cfg = _model()[0]
    prompts = _trace(cfg.vocab_size)
    port = _port_batcher(HOT_PAGES, prefetch)
    got = _two_waves(port, Request, prompts)
    ref = _ref_batcher(HOT_PAGES, prefetch)
    want = _two_waves(ref, JRequest, prompts)
    assert _tokens(got) == _tokens(want)
    for key in TIER_STATS + POOL_STATS:
        assert port.stats[key] == ref.stats[key], key
    flat = _port_batcher()
    assert _tokens(_two_waves(flat, Request, prompts)) == _tokens(got)
    st = port.stats
    assert st["tier_demotes"] > 0, "the trace never pressured the hot tier"
    assert st["tier_promotes"] > 0
    assert st["tier_hit_pages"] + st["tier_miss_pages"] > 0
    assert st["cow_copies"] > 0            # the exact repeats' partial pages
    assert (st["tier_prefetch_pages"] > 0) == prefetch
    _assert_tier_clean(port)


def test_prefetch_reduces_stall_tokens():
    """The same tokens, strictly fewer demand faults with prefetch on."""
    prompts = _trace(_model()[0].vocab_size)
    on, off = _port_batcher(HOT_PAGES), _port_batcher(HOT_PAGES,
                                                      prefetch=False)
    assert _tokens(_two_waves(on, Request, prompts)) == \
        _tokens(_two_waves(off, Request, prompts))
    assert on.stats["tier_prefetch_pages"] > 0
    assert on.stats["tier_stall_tokens"] < off.stats["tier_stall_tokens"]
    assert off.stats["tier_prefetch_pages"] == 0


def test_tiered_kv8_server_matches_reference():
    """kv8 pages carry their scales through demotion and promotion."""
    prompts = _trace(_model()[0].vocab_size)
    port = _port_batcher(HOT_PAGES, kv_quant="kv8")
    got = _two_waves(port, Request, prompts)
    ref = _ref_batcher(HOT_PAGES, kv_quant="kv8")
    want = _two_waves(ref, JRequest, prompts)
    assert _tokens(got) == _tokens(want)
    for key in TIER_STATS + POOL_STATS:
        assert port.stats[key] == ref.stats[key], key
    assert port.stats["tier_demotes"] > 0
    flat = _port_batcher(kv_quant="kv8")
    assert _tokens(_two_waves(flat, Request, prompts)) == _tokens(got)
    _assert_tier_clean(port)


def test_speculative_rollback_under_the_tier():
    """Verify steps back span pages hot and the rollback unpins those no
    kept token reached: tokens, tier and speculation counters equal the
    reference's, and the tier drains clean."""
    cfg = _model()[0]
    rng = np.random.default_rng(3)
    # repeated segments, so prompt-lookup drafts are accepted
    seg = rng.integers(1, cfg.vocab_size, 6).tolist()
    prompts = [seg * 5 + rng.integers(1, cfg.vocab_size, 3).tolist()
               for _ in range(4)]
    port = _port_batcher(HOT_PAGES, spec_k=4)
    got = _two_waves(port, Request, prompts, max_new=12)
    ref = _ref_batcher(HOT_PAGES, spec_k=4)
    want = _two_waves(ref, JRequest, prompts, max_new=12)
    assert _tokens(got) == _tokens(want)
    for key in TIER_STATS + POOL_STATS:
        assert port.stats[key] == ref.stats[key], key
    assert port.stats["spec_steps"] > 0
    seq = _port_batcher(HOT_PAGES)
    assert _tokens(_two_waves(seq, Request, prompts, max_new=12)) == \
        _tokens(got)
    _assert_tier_clean(port)


def test_tiered_per_request_stats_through_server():
    """RequestOutput carries each request's hot-tier hits and stalls, and
    they add up to the server's counters."""
    _, _, tcfg, tparams = _model()
    prompts = _trace(tcfg.vocab_size)
    server = KVNANDServer(
        ServerConfig(engine=TEngineConfig(**_eng_kw(HOT_PAGES)),
                     batch_slots=3, max_context=64, prefill_chunk_tokens=16,
                     device="cpu"),
        cfg=tcfg, params=tparams)
    sp = SamplingParams(max_new_tokens=4)
    totals = [0, 0]
    for _ in range(2):
        uids = [server.submit(p, sp) for p in prompts]
        server.run()
        for u in uids:
            o = server.output(u)
            totals[0] += o.tier_hit_pages
            totals[1] += o.tier_stall_tokens
            server.release(u)
    st = server.stats
    assert totals == [st["tier_hit_pages"], st["tier_stall_tokens"]]
    assert st["tier_hit_pages"] + st["tier_miss_pages"] > 0


# ---------------------------------------------------------------------------
# guards
# ---------------------------------------------------------------------------

def test_submit_rejects_footprint_over_hot_tier():
    """A request whose pinned pages can never fit the hot tier is refused
    at submit, as the reference refuses it, not left to wedge the admit
    loop."""
    cfg, params, tcfg, tparams = _model()
    kw = dict(batch_slots=1, max_context=128, prefill_chunk_tokens=16)
    port = ContinuousBatcher(tcfg, tparams, eng=TEngineConfig(**_eng_kw(2)),
                             device="cpu", **kw)
    ref = JBatcher(cfg, params, eng=EngineConfig(**_eng_kw(2)), **kw)
    for b, req in ((port, Request), (ref, JRequest)):
        with pytest.raises(ValueError, match="hot tier"):
            b.submit(req(0, list(range(1, 100)), max_new=4))
    assert not port.queue


def test_oneshot_prefill_refuses_tiered_pool():
    cfg, params, tcfg, tparams = _model()
    toks = np.arange(1, 22, dtype=np.int32)[None, :]
    with pytest.raises(ValueError, match="TIERED"):
        JEngine(cfg, EngineConfig(**_eng_kw(HOT_PAGES))).prefill(
            params, {"tokens": toks}, 64)
    with pytest.raises(ValueError, match="TIERED"):
        KVNANDEngine(tcfg, TEngineConfig(**_eng_kw(HOT_PAGES)),
                     device="cpu").prefill(
            tparams, {"tokens": torch.from_numpy(toks).long()}, 64)


def test_window_arch_refuses_tiered_pool():
    """Window rings recycle their pages in place: both packages refuse a
    tiered pool on a sliding-window arch at construction."""
    arch = "gemma3-12b"
    eng = dict(page_tokens=16, uniform_lengths=False, shared_pool=True,
               hot_pages=4)
    with pytest.raises(ValueError, match="GLOBAL"):
        JBatcher(get_config(arch).reduced(), None, batch_slots=2,
                 max_context=64, eng=EngineConfig(**eng),
                 prefill_chunk_tokens=16)
    with pytest.raises(ValueError, match="GLOBAL"):
        ContinuousBatcher(tget(arch).reduced(), None, batch_slots=2,
                          max_context=64, eng=TEngineConfig(**eng),
                          prefill_chunk_tokens=16, device="cpu")


def test_hot_tier_larger_than_flash_pool_is_refused():
    _, _, tcfg, tparams = _model()
    eng = TEngineConfig(page_tokens=16, uniform_lengths=False,
                        shared_pool=True, hot_pages=20)
    with pytest.raises(ValueError, match="exceeds the flash pool"):
        ContinuousBatcher(tcfg, tparams, batch_slots=1, max_context=64,
                          eng=eng, prefill_chunk_tokens=16, device="cpu")


def test_launch_serve_hot_pages_on_cpu(capsys):
    outs = serve(["--reduced", "--device", "cpu", "--shared-pool",
                  "--total-pages", "64", "--hot-pages", "12", "--requests",
                  "6", "--max-new", "4", "--slots", "2"])
    assert sorted(outs) == list(range(6))
    assert all(len(o.token_ids) == 4 for o in outs.values())
    text = capsys.readouterr().out
    assert "[serve] tiered pool: 12 hot slots" in text
    flat = serve(["--reduced", "--device", "cpu", "--shared-pool",
                  "--total-pages", "64", "--no-tier-prefetch", "--requests",
                  "6", "--max-new", "4", "--slots", "2"])
    assert [o.token_ids for o in flat.values()] == \
        [o.token_ids for o in outs.values()]
