"""PyTorch port: the splice scheduler end to end on the CPU, and the
port's entry point `python -m repro_torch.launch.serve`.

`KVNANDServer(ServerConfig(scheduler="splice"))` must serve the JAX
splice server's greedy tokens from the same weights at a float32 pool,
for an MHA (qwen1.5-0.5b) and a GQA (llama3.1-8b) reduced config, with
logprobs within 1e-4 and the same `admits` / `decode_stall_tokens`; and
the port's splice and interleaved schedulers must serve identical tokens
(f32 and kv8), as the reference's `test_interleave.py` holds its own."""
import inspect
import re

import jax
import numpy as np
import pytest
import torch

from repro.configs import EngineConfig, get_config
from repro.launch import serve as jserve
from repro.models.registry import Model
from repro.serving import scheduler as jsched
from repro.serving.api import KVNANDServer as JServer
from repro.serving.api import SamplingParams as JParams
from repro.serving.api import ServerConfig as JConfig
from repro_torch import bridge
from repro_torch.configs import EngineConfig as TEngineConfig
from repro_torch.configs import get_config as tget
from repro_torch.launch.serve import _parser, serve
from repro_torch.models.registry import Model as TModel
from repro_torch.serving import scheduler as tsched
from repro_torch.serving.api import KVNANDServer, SamplingParams, ServerConfig

torch.set_num_threads(2)

SERVE = dict(batch_slots=2, max_context=96, prefill_chunk_tokens=16)
PROMPT_LENS = (5, 40, 17, 33, 3)      # buckets 16, 64, 32, 64, 16
MAX_NEW = 20
F32 = dict(page_tokens=16, uniform_lengths=False, kv_dtype="float32")
KV8 = dict(page_tokens=16, uniform_lengths=False, kv_quant="kv8")


def _prompts(vocab):
    r = np.random.default_rng(0)
    return [r.integers(1, vocab, n).tolist() for n in PROMPT_LENS]


def _port(arch, scheduler, params=None, **eng_kw):
    return KVNANDServer(ServerConfig(
        engine=TEngineConfig(**eng_kw), scheduler=scheduler, device="cpu",
        **SERVE), cfg=tget(arch).reduced(), params=params)


@pytest.mark.parametrize("arch", ["qwen1.5-0.5b", "llama3.1-8b"])
def test_splice_server_matches_reference(arch):
    cfg = get_config(arch).reduced()
    params = Model(cfg).init(jax.random.PRNGKey(0))
    prompts = _prompts(cfg.vocab_size)
    sp = dict(max_new_tokens=MAX_NEW, logprobs=True)
    ref = JServer(JConfig(engine=EngineConfig(**F32), scheduler="splice",
                          **SERVE), cfg=cfg, params=params)
    want = ref.generate(prompts, JParams(**sp))
    srv = _port(arch, "splice", bridge.params_from_numpy(
        jax.tree.map(np.asarray, params), "cpu"), **F32)
    got = srv.generate(prompts, SamplingParams(**sp))
    for w, g in zip(want, got):
        assert g.token_ids == w.token_ids
        assert g.finish_reason == w.finish_reason == "length"
        np.testing.assert_allclose(g.logprobs, w.logprobs, atol=1e-4)
    for key in ("admits", "decode_stall_tokens", "steps"):
        assert srv.stats[key] == ref.stats[key], key
    assert srv.stats["decode_stall_tokens"] > 0
    assert srv.stats["prefill_chunks"] == 0


@pytest.mark.parametrize("eng_kw", [F32, KV8], ids=["f32", "kv8"])
def test_splice_matches_interleaved(eng_kw):
    """Port of test_interleave.py::test_interleaved_matches_splice: the
    one-shot bucketed prefill and the chunked prefill serve the same
    greedy tokens; only the splice baseline stalls decoders."""
    prompts = _prompts(512)
    outs = {}
    for name in ("interleaved", "splice"):
        srv = _port("qwen1.5-0.5b", name, **eng_kw)
        outs[name] = ([o.token_ids for o in srv.generate(
            prompts, SamplingParams(max_new_tokens=8))], srv.stats)
    assert outs["interleaved"][0] == outs["splice"][0]
    assert outs["interleaved"][1]["decode_stall_tokens"] == 0
    assert outs["splice"][1]["decode_stall_tokens"] > 0
    assert outs["interleaved"][1]["prefill_chunks"] > len(prompts)


def test_exact_length_splice_serves_the_bucketed_tokens():
    """`bucket_prompts=False` prefills each prompt at its own length (no
    padding, no `prompt_len`): the same greedy tokens, a smaller stall."""
    cfg = tget("qwen1.5-0.5b").reduced()
    params = TModel(cfg).init(torch.Generator().manual_seed(0))
    prompts = _prompts(512)
    got = {}
    for bucket in (True, False):
        b = tsched.SpliceBatcher(cfg, params, eng=TEngineConfig(**F32),
                                 device="cpu", bucket_prompts=bucket,
                                 **SERVE)
        for uid, p in enumerate(prompts):
            b.submit(tsched.Request(uid, list(p), max_new=6))
        done = b.run_to_completion()
        got[bucket] = ([done[u].output for u in range(len(prompts))],
                       b.stats["decode_stall_tokens"])
    assert got[True][0] == got[False][0]
    assert 0 < got[False][1] < got[True][1]


def test_splice_refuses_a_shared_pool():
    with pytest.raises(ValueError, match="stripe-layout baseline"):
        _port("qwen1.5-0.5b", "splice", **F32, shared_pool=True)


@pytest.mark.parametrize("n", [1, 15, 16, 17, 33, 64, 95, 200, 511])
def test_bucket_length_matches_reference(n):
    assert tsched.MIN_PROMPT_BUCKET == jsched.MIN_PROMPT_BUCKET
    for hi in (None, 95, 511):
        assert tsched.bucket_length(n, hi=hi) == jsched.bucket_length(
            n, hi=hi)


@pytest.mark.parametrize("scheduler", ["splice", "interleaved"])
def test_launch_serve_runs_in_process(scheduler, capsys):
    outs = serve(["--reduced", "--device", "cpu", "--scheduler", scheduler,
                  "--requests", "3", "--max-new", "4", "--slots", "2"])
    assert sorted(outs) == [0, 1, 2]
    assert all(len(o.token_ids) == 4 and o.finish_reason == "length"
               for o in outs.values())
    text = capsys.readouterr().out
    assert "3 requests, 12 tokens" in text and "on CPU" in text
    assert f"scheduler={scheduler}" in text


def test_launch_serve_takes_every_reference_flag():
    """The port's CLI parses every flag of the reference's
    `launch/serve.py` (and adds `--device`)."""
    want = set(re.findall(r'add_argument\("(--[a-z-]+)"',
                          inspect.getsource(jserve.serve)))
    got = {f for f in _parser()._option_string_actions if f.startswith("--")}
    assert want and want <= got
    assert got - want == {"--device", "--help"}


def test_launch_serve_overlap_runs_in_process(capsys):
    argv = ["--reduced", "--device", "cpu", "--requests", "4", "--max-new",
            "5", "--slots", "2", "--temperature", "0.8", "--seed", "3"]
    sync = serve(argv)
    over = serve(argv + ["--overlap"])
    assert [o.token_ids for o in over.values()] == \
        [o.token_ids for o in sync.values()]
    assert "4 requests, 20 tokens" in capsys.readouterr().out
