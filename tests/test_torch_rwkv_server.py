"""PyTorch port: RWKV6 (`rwkv6-3b` reduced) served end to end on the CPU.

`KVNANDServer(ServerConfig(arch="rwkv6-3b"))` must serve the JAX
server's greedy tokens from the same weights, with logprobs within 1e-4,
on the interleaved scheduler (every prompt prefilled as one exact-length
chunk, whatever the chunk size: the recurrent state must not see
padding), on the interleaved scheduler with `shared_pool=True` (no page
pool, so no allocator and no prefix cache, as in the reference) and on
the splice scheduler (exact-length one-shot prefills), with the same
admit, chunk and decode-stall counters — for 5 prompts on 2 slots, one
of them a single token (its admit runs the recurrence, not the chunked
wkv).  The port's two schedulers serve the same tokens; the entry point
`python -m repro_torch.launch.serve --arch rwkv6-3b` serves under both."""
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
from repro_torch.launch.serve import serve
from repro_torch.serving.api import KVNANDServer, SamplingParams, ServerConfig

torch.set_num_threads(2)

ARCH = "rwkv6-3b"
SERVE = dict(batch_slots=2, max_context=96, prefill_chunk_tokens=16)
PROMPT_LENS = (5, 40, 1, 33, 3)       # 40 and 33 exceed a 16-token chunk
MAX_NEW = 20
F32 = dict(page_tokens=16, uniform_lengths=False, kv_dtype="float32")
COUNTERS = ("steps", "admits", "prefill_chunks", "decode_tokens",
            "decode_stall_tokens", "prompt_pages", "pool_total_pages")
_CACHE = {}


def _weights():
    if not _CACHE:
        cfg = get_config(ARCH).reduced()
        params = Model(cfg).init(jax.random.PRNGKey(0))
        _CACHE["w"] = (cfg, params, bridge.params_from_numpy(
            jax.tree.map(np.asarray, params), "cpu"))
    return _CACHE["w"]


def _prompts(vocab):
    r = np.random.default_rng(0)
    return [r.integers(1, vocab, n).tolist() for n in PROMPT_LENS]


def _port(scheduler, **eng_kw):
    _, _, tparams = _weights()
    return KVNANDServer(ServerConfig(
        arch=ARCH, engine=TEngineConfig(**F32, **eng_kw),
        scheduler=scheduler, device="cpu", **SERVE),
        cfg=tget(ARCH).reduced(), params=tparams)


@pytest.mark.parametrize("scheduler,shared", [("interleaved", False),
                                              ("interleaved", True),
                                              ("splice", False)])
def test_server_matches_reference(scheduler, shared):
    cfg, params, _ = _weights()
    prompts = _prompts(cfg.vocab_size)
    sp = dict(max_new_tokens=MAX_NEW, logprobs=True)
    ref = JServer(JConfig(engine=EngineConfig(**F32, shared_pool=shared),
                          scheduler=scheduler, **SERVE),
                  cfg=cfg, params=params)
    want = ref.generate(prompts, JParams(**sp))
    srv = _port(scheduler, shared_pool=shared)
    got = srv.generate(prompts, SamplingParams(**sp))
    for g, w in zip(got, want):
        assert g.token_ids == w.token_ids
        assert g.finish_reason == w.finish_reason == "length"
        np.testing.assert_allclose(g.logprobs, w.logprobs, atol=1e-4)
    assert {k: srv.stats[k] for k in COUNTERS} == \
        {k: ref.stats[k] for k in COUNTERS}
    b = srv._batcher
    assert not b.bucket_prompts and b._whole_prompt
    assert b.alloc is None and b.prefix_cache is None
    assert b.cache.k_pages_g is None
    if scheduler == "interleaved":           # one exact chunk per prompt
        assert srv.stats["prefill_chunks"] == len(prompts)


def test_splice_and_interleaved_serve_the_same_tokens():
    """bf16 shifts, the serving default."""
    cfg, _, _ = _weights()
    prompts = _prompts(cfg.vocab_size)
    sp = SamplingParams(max_new_tokens=8)
    outs = {}
    for scheduler in ("interleaved", "splice"):
        srv = KVNANDServer(ServerConfig(arch=ARCH, reduced=True,
                                        scheduler=scheduler, device="cpu",
                                        **SERVE))
        outs[scheduler] = [o.token_ids for o in srv.generate(prompts, sp)]
    assert outs["interleaved"] == outs["splice"]


@pytest.mark.parametrize("scheduler", ["interleaved", "splice"])
def test_launch_serve_rwkv6_in_process(scheduler, capsys):
    outs = serve(["--arch", ARCH, "--reduced", "--device", "cpu",
                  "--scheduler", scheduler, "--requests", "3", "--max-new",
                  "4", "--slots", "2"])
    assert sorted(outs) == [0, 1, 2]
    assert all(len(o.token_ids) == 4 and o.finish_reason == "length"
               for o in outs.values())
    text = capsys.readouterr().out
    assert "3 requests, 12 tokens" in text and "on CPU" in text
    assert f"scheduler={scheduler}: " in text and "3 admits" in text
