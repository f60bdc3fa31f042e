"""PyTorch port: `KVNANDServer` on the shared page pool, end to end on the
CPU, against the JAX `KVNANDServer` built from the same weights at a
float32 pool.

The prompts share a 2-page (32-token) system prefix and one is an exact
repeat, so the prefix cache hits and pages are copied on write; greedy
tokens must be identical, logprobs within 1e-4, and the scheduler's
counters (prefix hits, copies, chunks, admissions) equal to the
reference's.  Under a small `total_pages` requests wait for pages, and
must be admitted in the reference's order, step for step."""
import jax
import numpy as np
import pytest
import torch

from repro.configs import EngineConfig, get_config
from repro.models.registry import Model
from repro.serving.api import KVNANDServer as JServer
from repro.serving.api import SamplingParams as JParams
from repro.serving.api import ServerConfig as JConfig
from repro_torch import bridge
from repro_torch.configs import EngineConfig as TEngineConfig
from repro_torch.configs import get_config as tget
from repro_torch.serving.api import KVNANDServer, SamplingParams, ServerConfig

torch.set_num_threads(2)

SERVE = dict(batch_slots=2, max_context=96, prefill_chunk_tokens=16)
COUNTERS = ("prefix_hit_pages", "cow_copies", "prefill_chunks", "admits",
            "prompt_pages")


def _prompts(vocab, seed=0):
    r = np.random.default_rng(seed)
    system = r.integers(1, vocab, 32).tolist()          # 2 full pages
    prompts = [system + r.integers(1, vocab, n).tolist() for n in (9, 21, 4)]
    prompts.insert(2, r.integers(1, vocab, 17).tolist())  # no shared prefix
    prompts.append(list(prompts[0]))                     # exact repeat
    return prompts


def _pair(arch, serve=SERVE, with_ref=True, **eng_kw):
    """(cfg, JAX server, port server) on the same weights."""
    cfg = get_config(arch).reduced()
    params = Model(cfg).init(jax.random.PRNGKey(0))
    kw = dict(page_tokens=16, uniform_lengths=False, kv_dtype="float32",
              shared_pool=True, **eng_kw)
    ref = (JServer(JConfig(engine=EngineConfig(**kw), **serve), cfg=cfg,
                   params=params) if with_ref else None)
    port = KVNANDServer(
        ServerConfig(engine=TEngineConfig(**kw), device="cpu", **serve),
        cfg=tget(arch).reduced(),
        params=bridge.params_from_numpy(jax.tree.map(np.asarray, params),
                                        "cpu"))
    return cfg, ref, port


@pytest.mark.parametrize("arch", ["qwen1.5-0.5b", "llama3.1-8b"])
def test_shared_pool_server_matches_reference(arch):
    cfg, ref, port = _pair(arch)
    prompts = _prompts(cfg.vocab_size)
    want = ref.generate(prompts, JParams(max_new_tokens=12, logprobs=True))
    got = port.generate(prompts, SamplingParams(max_new_tokens=12,
                                                logprobs=True))
    for w, g in zip(want, got):
        assert g.token_ids == w.token_ids
        assert g.finish_reason == w.finish_reason == "length"
        np.testing.assert_allclose(g.logprobs, w.logprobs, atol=1e-4)
    for key in COUNTERS:
        assert port.stats[key] == ref.stats[key], key
    assert port.stats["prefix_hit_pages"] > 0
    assert port.stats["cow_copies"] > 0
    b = port._batcher
    b.alloc.check()
    # at drain only the prefix cache holds pages, all of them reclaimable
    assert b.alloc.live_count == b.prefix_cache.evictable_pages() > 0


def test_exact_repeat_skips_prefill_and_samples_cached_logits():
    cfg, _, port = _pair("qwen1.5-0.5b", with_ref=False)
    p = _prompts(cfg.vocab_size)[0]                      # 41 tokens
    first = port.generate([p], SamplingParams(max_new_tokens=4))[0]
    chunks = port.stats["prefill_chunks"]
    again = port.generate([p], SamplingParams(max_new_tokens=4))[0]
    assert again.token_ids == first.token_ids
    assert port.stats["prefill_chunks"] == chunks        # no recompute
    assert port.stats["cow_copies"] >= 2     # own partial page + the fork's


def _occupancy(b):
    return ([None if r is None else r.uid for r in b.slots],
            sorted(r.uid for r in b.queue))


def test_admission_waits_for_pages_in_reference_order():
    """A 7-page pool under 3 slots: requests wait for pages; at every step
    the port's slots and queue hold the reference's requests."""
    cfg, ref, port = _pair("qwen1.5-0.5b", serve=dict(SERVE, batch_slots=3),
                           total_pages=7)
    r = np.random.default_rng(3)
    prompts = [r.integers(1, cfg.vocab_size, n).tolist()
               for n in (30, 17, 40, 5, 24)]
    for i, p in enumerate(prompts):
        ref.submit(p, JParams(max_new_tokens=10), uid=i)
        port.submit(p, SamplingParams(max_new_tokens=10), uid=i)
    waited = False
    while ref._busy() or port._busy():
        ref.step()
        port.step()
        occ = _occupancy(port._batcher)
        assert occ == _occupancy(ref._batcher)
        waited |= bool(occ[1]) and None in occ[0]
    assert waited                        # a free slot, yet a request queued
    assert port.stats["pool_peak_pages"] == ref.stats["pool_peak_pages"] <= 7
    for i in range(len(prompts)):
        assert port.output(i).token_ids == ref.output(i).token_ids
    port._batcher.alloc.check()


def test_abort_releases_shared_pages():
    cfg, _, port = _pair("qwen1.5-0.5b", with_ref=False)
    prompts = _prompts(cfg.vocab_size)
    a = port.submit(prompts[1], SamplingParams(max_new_tokens=30))
    port.step()
    port.step()
    assert port._batcher._slot_pages[0]
    assert port.abort(a)
    assert port.output(a).finish_reason == "aborted"
    b = port._batcher
    b.alloc.check()
    assert b._outstanding == 0 and not b._slot_pages[0]
    assert b.alloc.live_count == b.prefix_cache.evictable_pages()
