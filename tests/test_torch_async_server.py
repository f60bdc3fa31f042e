"""PyTorch port: the asyncio HTTP front end (`serving/async_server.py`) and
its Prometheus metrics (`serving/metrics.py`), on the CPU (the
reference's `tests/test_async_server.py`, on the port).

End to end over a real socket through `BackgroundServer`: one-shot and
SSE ``POST /v1/completions`` (the tokens `KVNANDServer.generate` serves
for the same prompt), request validation, ``GET /healthz`` and ``GET
/metrics``, admission backpressure at ``max_queue`` (HTTP 429 and
Retry-After), priority / deadline pass-through, and both engine loops
(overlapped and synchronous).  `ServingMetrics` renders exactly the
reference's text for the same observations.  Every request, join and
server start here has its own timeout.
"""
import http.client
import json
import threading
import time

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config
from repro.models.registry import Model
from repro.serving.metrics import ServingMetrics as JMetrics
from repro_torch import bridge
from repro_torch.configs import EngineConfig
from repro_torch.configs import get_config as tget
from repro_torch.serving.api import (KVNANDServer, RequestOutput,
                                     SamplingParams, ServerConfig)
from repro_torch.serving.async_server import (AsyncServerConfig,
                                              BackgroundServer)
from repro_torch.serving.metrics import ServingMetrics

torch.set_num_threads(2)

ARCH = "qwen1.5-0.5b"
PROMPT = list(range(1, 12))
JOIN_S = 120

_CACHE = {}


def _model():
    if "m" not in _CACHE:
        params = Model(get_config(ARCH).reduced()).init(
            jax.random.PRNGKey(0))
        _CACHE["m"] = (tget(ARCH).reduced(), bridge.params_from_numpy(
            jax.tree.map(np.asarray, params), "cpu"))
    return _CACHE["m"]


def _configs(slots=2, max_queue=32, overlap=True):
    cfg, params = _model()
    return dict(
        config=ServerConfig(
            engine=EngineConfig(page_tokens=16, uniform_lengths=False,
                                shared_pool=True, total_pages=64),
            batch_slots=slots, max_context=96, prefill_chunk_tokens=16,
            device="cpu"),
        async_config=AsyncServerConfig(max_queue=max_queue,
                                       overlap=overlap),
        cfg=cfg, params=params)


def _post(addr, payload, timeout=60):
    conn = http.client.HTTPConnection(*addr, timeout=timeout)
    try:
        conn.request("POST", "/v1/completions", json.dumps(payload),
                     {"Content-Type": "application/json"})
        r = conn.getresponse()
        return r.status, dict(r.getheaders()), r.read()
    finally:
        conn.close()


def _get(addr, path, timeout=30):
    conn = http.client.HTTPConnection(*addr, timeout=timeout)
    try:
        conn.request("GET", path)
        r = conn.getresponse()
        return r.status, r.read()
    finally:
        conn.close()


def _facade(prompt, sp):
    cfg, params = _model()
    return KVNANDServer(_configs()["config"], cfg=cfg,
                        params=params).generate([prompt], sp)[0]


@pytest.fixture(scope="module", params=[True, False],
                ids=["overlap", "sync"])
def srv(request):
    with BackgroundServer(**_configs(overlap=request.param)) as s:
        yield s
    assert not s._thread.is_alive()


# ---------------------------------------------------------------------------
# completions: one-shot and SSE, the facade's tokens
# ---------------------------------------------------------------------------

def test_oneshot_completion_matches_facade(srv):
    ref = _facade(PROMPT, SamplingParams(max_new_tokens=6))
    status, _, body = _post(srv.address,
                            {"prompt": PROMPT, "max_tokens": 6})
    assert status == 200
    out = json.loads(body)
    assert out["object"] == "text_completion"
    choice = out["choices"][0]
    assert choice["token_ids"] == ref.token_ids
    assert choice["finish_reason"] == "length"
    assert out["usage"] == {"prompt_tokens": len(PROMPT),
                            "completion_tokens": 6,
                            "total_tokens": len(PROMPT) + 6}


def test_sse_stream_concatenates_to_oneshot(srv):
    status, _, body = _post(srv.address,
                            {"prompt": PROMPT, "max_tokens": 5})
    oneshot = json.loads(body)["choices"][0]["token_ids"]
    conn = http.client.HTTPConnection(*srv.address, timeout=60)
    try:
        conn.request("POST", "/v1/completions",
                     json.dumps({"prompt": PROMPT, "max_tokens": 5,
                                 "stream": True}),
                     {"Content-Type": "application/json"})
        r = conn.getresponse()
        assert r.status == 200
        assert r.getheader("Content-Type") == "text/event-stream"
        raw = r.read().decode()
    finally:
        conn.close()
    frames = [f for f in raw.split("\n\n") if f.startswith("data: ")]
    assert frames[-1] == "data: [DONE]"
    chunks = [json.loads(f[len("data: "):])["choices"][0]
              for f in frames[:-1]]
    assert [c["token"] for c in chunks] == oneshot
    assert [c["position"] for c in chunks] == list(range(5))
    assert [c["finish_reason"] for c in chunks] == \
        [None] * 4 + ["length"]


def test_sampling_params_pass_through(srv):
    sp = dict(temperature=0.8, top_k=5, seed=7)
    status, _, body = _post(srv.address, {
        "prompt": PROMPT, "max_tokens": 4, "logprobs": True, **sp})
    assert status == 200
    choice = json.loads(body)["choices"][0]
    ref = _facade(PROMPT, SamplingParams(max_new_tokens=4, logprobs=True,
                                         **sp))
    assert choice["token_ids"] == ref.token_ids
    assert len(choice["logprobs"]) == 4
    np.testing.assert_allclose(choice["logprobs"], ref.logprobs, atol=1e-6)
    assert all(lp <= 0.0 for lp in choice["logprobs"])


def test_stop_token_finish_over_http(srv):
    """A stop token finishes the request the step it is first sampled,
    and is the last token served.  The reference's test stops on
    toks[1] and expects toks[:2]; on this random model toks[0] ==
    toks[1], so the stop fires at index 0: the test's premise, not the
    server, is at fault.  Here the stop token is one that first occurs
    at the index the test names, and stopping on toks[1] is held to its
    first occurrence."""
    status, _, body = _post(srv.address,
                            {"prompt": PROMPT, "max_tokens": 8})
    toks = json.loads(body)["choices"][0]["token_ids"]
    j = next(j for j in range(1, len(toks)) if toks[j] not in toks[:j])
    status, _, body = _post(srv.address, {
        "prompt": PROMPT, "max_tokens": 8, "stop_token_ids": [toks[j]]})
    choice = json.loads(body)["choices"][0]
    assert choice["finish_reason"] == "stop"
    assert choice["token_ids"] == toks[:j + 1]
    _, _, body = _post(srv.address, {
        "prompt": PROMPT, "max_tokens": 8, "stop_token_ids": [toks[1]]})
    first = toks.index(toks[1])
    assert json.loads(body)["choices"][0]["token_ids"] == toks[:first + 1]


# ---------------------------------------------------------------------------
# validation and routing
# ---------------------------------------------------------------------------

def test_bad_requests(srv):
    status, _, body = _post(srv.address, {"prompt": "not tokens"})
    assert status == 400 and b"token ids" in body
    status, _, body = _post(srv.address, {"prompt": [1, True, 3]})
    assert status == 400
    status, _, body = _post(srv.address, {"prompt": []})
    assert status == 400                  # the facade refuses empty prompts
    conn = http.client.HTTPConnection(*srv.address, timeout=30)
    try:
        conn.request("POST", "/v1/completions", b"{nope",
                     {"Content-Type": "application/json"})
        assert conn.getresponse().status == 400
    finally:
        conn.close()


def test_healthz_and_unknown_route(srv):
    status, body = _get(srv.address, "/healthz")
    assert (status, body) == (200, b"ok\n")
    status, _ = _get(srv.address, "/nope")
    assert status == 404


def test_bad_deadline_is_400(srv):
    status, _, _ = _post(srv.address, {
        "prompt": PROMPT, "max_tokens": 2, "deadline_s": -1})
    assert status == 400


# ---------------------------------------------------------------------------
# metrics: live Prometheus text after real traffic
# ---------------------------------------------------------------------------

def _counts(text):
    return {line.split()[0]: float(line.split()[1])
            for line in text.splitlines()
            if line and not line.startswith("#")}


def test_metrics_exposition(srv):
    before = _counts(_get(srv.address, "/metrics")[1].decode())
    _post(srv.address, {"prompt": PROMPT, "max_tokens": 3})
    status, body = _get(srv.address, "/metrics")
    assert status == 200
    text = body.decode()
    for name in ("kvnand_ttft_seconds", "kvnand_tpot_seconds",
                 "kvnand_requests_finished_total",
                 "kvnand_rejected_total",
                 "kvnand_scheduler_steps_total",
                 "kvnand_decode_tokens_total",
                 "kvnand_phantom_tokens_total",
                 "kvnand_device_idle_fraction",
                 "kvnand_queue_depth", "kvnand_pending_steps",
                 "kvnand_pool_util", "kvnand_pool_live_pages"):
        assert name in text, name
    after = _counts(text)
    key = 'kvnand_requests_finished_total{reason="length"}'
    # the served count: one more finished request, its 3 tokens counted
    assert after[key] == before.get(key, 0) + 1
    assert after["kvnand_ttft_seconds_count"] == \
        before.get("kvnand_ttft_seconds_count", 0) + 1
    assert after["kvnand_decode_tokens_total"] >= \
        before.get("kvnand_decode_tokens_total", 0) + 2
    assert 0.0 <= after["kvnand_device_idle_fraction"] <= 1.0
    assert after["kvnand_pending_steps"] == 0


def test_final_response_arrives_after_it_is_counted(srv):
    """A client holding its final response finds its request counted.
    The engine thread's `metrics.observe` is held for a window; a server
    that posted the terminal event before counting it would deliver the
    response inside that window, before the count."""
    metrics = srv.server.metrics
    observe = metrics.observe
    entered, release = threading.Event(), threading.Event()
    counted, seen = [], []

    def held_observe(out):
        entered.set()
        release.wait(timeout=30)
        observe(out)
        counted.append(out.uid)

    def client():
        status, _, _ = _post(srv.address, {"prompt": PROMPT,
                                           "max_tokens": 2})
        seen.append((status, len(counted)))

    metrics.observe = held_observe
    try:
        t = threading.Thread(target=client, daemon=True)
        t.start()
        assert entered.wait(timeout=60), "the request was never counted"
        t.join(timeout=1.5)          # the window the count is held for
        release.set()
        t.join(timeout=60)
        assert not t.is_alive()
    finally:
        release.set()
        del metrics.observe
    assert seen == [(200, 1)], seen


def test_metrics_render_matches_reference():
    """The copied ServingMetrics renders the reference's text, byte for
    byte, for the same finished requests, rejections, stats and gauges."""
    outs = [RequestOutput(uid=u, prompt=[1], token_ids=[2] * n,
                          logprobs=None, finish_reason=r,
                          submit_time=0.0, first_token_time=ft,
                          finish_time=ft + 0.5 if ft is not None else 1.0)
            for u, (n, r, ft) in enumerate([(4, "length", 0.25),
                                            (1, "stop", 0.125),
                                            (0, "aborted", None),
                                            (7, "capacity", 0.0625)])]
    stats = {"steps": 12, "decode_tokens": 30, "admits": 4,
             "prefill_chunks": 5, "cow_copies": 2, "tier_promotes": 3,
             "tier_demotes": 1, "phantom_tokens": 2, "prompt_pages": 8,
             "prefix_hit_pages": 3, "spec_drafted": 0}
    gauges = {"kvnand_queue_depth": 2.0, "kvnand_pool_util": 0.375}
    port, ref = ServingMetrics(window=3), JMetrics(window=3)
    for m in (port, ref):
        for o in outs:
            m.observe(o)
        m.observe_rejected()
    text = port.render(stats, gauges)
    assert text == ref.render(stats, gauges)
    assert 'kvnand_requests_finished_total{reason="stop"} 1' in text
    assert "kvnand_prefix_hit_rate 0.375" in text
    assert "kvnand_rejected_total 1" in text


# ---------------------------------------------------------------------------
# backpressure: saturation answers 429, never queues unboundedly
# ---------------------------------------------------------------------------

def test_zero_queue_rejects_everything():
    with BackgroundServer(**_configs(max_queue=0)) as s:
        status, headers, body = _post(s.address,
                                      {"prompt": PROMPT, "max_tokens": 2})
        assert status == 429
        assert headers.get("Retry-After") == "1"
        assert b"retry" in body.lower()
        _, text = _get(s.address, "/metrics")
        assert b"kvnand_rejected_total 1" in text
    assert not s._thread.is_alive()


def test_saturation_mixes_429_and_service():
    """A burst far past slots + max_queue: some requests are served, the
    overflow is refused with 429 — nothing hangs or errors out."""
    with BackgroundServer(**_configs(slots=1, max_queue=2)) as s:
        results = []
        lock = threading.Lock()

        def fire():
            st, _, _ = _post(s.address,
                             {"prompt": PROMPT, "max_tokens": 24})
            with lock:
                results.append(st)

        threads = [threading.Thread(target=fire) for _ in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=JOIN_S)
            assert not t.is_alive()
        assert len(results) == 8
        assert set(results) <= {200, 429}
        assert 200 in results
        assert 429 in results
    assert not s._thread.is_alive()


# ---------------------------------------------------------------------------
# priority / deadline pass-through
# ---------------------------------------------------------------------------

def test_deadline_expires_queued_request_over_http():
    with BackgroundServer(**_configs(slots=1)) as s:
        done = threading.Event()

        def long_one():
            _post(s.address, {"prompt": PROMPT, "max_tokens": 80})
            done.set()

        t = threading.Thread(target=long_one)
        t.start()
        # wait until it occupies the only slot (a step of the reduced
        # model takes milliseconds here, so a fixed sleep could outlast
        # the whole request)
        t_end = time.monotonic() + 30
        while _counts(_get(s.address, "/metrics")[1].decode()).get(
                "kvnand_running_requests") != 1:
            assert time.monotonic() < t_end and not done.is_set()
            time.sleep(0.002)
        status, _, body = _post(s.address, {
            "prompt": list(range(2, 9)), "max_tokens": 8,
            "deadline_s": 0.001})
        assert status == 200
        choice = json.loads(body)["choices"][0]
        assert choice["finish_reason"] == "deadline"
        assert choice["token_ids"] == []
        assert done.wait(timeout=JOIN_S)
        t.join(timeout=5)
        assert not t.is_alive()
        _, text = _get(s.address, "/metrics")
        assert b'kvnand_requests_finished_total{reason="deadline"} 1' \
            in text
    assert not s._thread.is_alive()


def test_concurrent_mixed_requests_match_facade():
    """Six concurrent completions, three one-shot and three SSE, on the
    overlapped engine loop: each equals the facade's tokens for its own
    prompt (the card phase H1 runs the same traffic at full width)."""
    rng = np.random.default_rng(4)
    prompts = [rng.integers(1, 500, int(n)).tolist()
               for n in (5, 23, 40, 9, 31, 17)]
    want = [_facade(p, SamplingParams(max_new_tokens=6)).token_ids
            for p in prompts]
    got = [None] * 6

    def fire(k):
        payload = {"prompt": prompts[k], "max_tokens": 6,
                   "stream": k % 2 == 1}
        conn = http.client.HTTPConnection(*s.address, timeout=60)
        try:
            conn.request("POST", "/v1/completions", json.dumps(payload))
            raw = conn.getresponse().read().decode()
        finally:
            conn.close()
        if payload["stream"]:
            got[k] = [json.loads(f[6:])["choices"][0]["token"]
                      for f in raw.split("\n\n")
                      if f.startswith("data: {")]
        else:
            got[k] = json.loads(raw)["choices"][0]["token_ids"]

    with BackgroundServer(**_configs()) as s:
        threads = [threading.Thread(target=fire, args=(k,))
                   for k in range(6)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=JOIN_S)
            assert not t.is_alive()
    assert got == want
    assert not s._thread.is_alive()


def test_launch_serve_http_on_cpu():
    """`python -m repro_torch.launch.serve --http --port 0 --reduced
    --device cpu` binds an ephemeral port, answers a completion and
    stops on SIGINT."""
    import os
    import queue
    import signal
    import subprocess
    import sys
    from pathlib import Path
    env = dict(os.environ,
               PYTHONPATH=str(Path(__file__).resolve().parents[1] / "src"))
    proc = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.serve", "--http",
         "--port", "0", "--reduced", "--device", "cpu", "--overlap"],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
    lines = queue.Queue()
    reader = threading.Thread(target=lambda: lines.put(
        proc.stdout.readline()), daemon=True)
    reader.start()
    try:
        line = lines.get(timeout=JOIN_S)
        assert "listening on http://" in line and "overlap=on" in line
        host, port = line.split("http://")[1].split()[0].rsplit(":", 1)
        status, _, body = _post((host, int(port)),
                                {"prompt": PROMPT, "max_tokens": 3})
        assert status == 200
        assert len(json.loads(body)["choices"][0]["token_ids"]) == 3
        proc.send_signal(signal.SIGINT)
        assert proc.wait(timeout=JOIN_S) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=JOIN_S)
        proc.stdout.close()
        proc.stderr.close()
