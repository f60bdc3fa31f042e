"""Asyncio HTTP front end over `KVNANDServer` (port of
`repro.serving.async_server`).

  * an ENGINE THREAD runs the overlapped scheduler loop — dispatch step
    N+1, collect step N — so the card stays busy while the host emits
    tokens, routes stream events and admits new arrivals.  It owns every
    tensor: the asyncio thread reads host bookkeeping only (queue depth,
    slots, allocator counts, the stats dict).  On a card it sets its
    device first, since a thread starts on the default one;
  * the ASYNCIO THREAD runs a hand-rolled HTTP/1.1 server
    (`asyncio.start_server`): OpenAI-style ``POST /v1/completions``
    (JSON in; one-shot JSON or SSE ``data:`` chunks out),
    ``GET /metrics`` (Prometheus text, serving/metrics.py), and
    ``GET /healthz``;
  * the two sides meet at a thread-safe command queue (submissions and
    aborts hop onto the engine thread — the scheduler is single-
    threaded by design) and per-request `asyncio.Queue`s fed via
    `loop.call_soon_threadsafe` (stream events hop back);
  * ADMISSION BACKPRESSURE: when the scheduler's waiting queue plus
    unprocessed submissions reach ``max_queue``, new completions get
    HTTP 429 with a Retry-After instead of queuing unboundedly —
    deadlines and the page-count admission gate handle the rest;
  * per-request ``priority`` / ``deadline_s`` fields pass straight into
    the scheduler's admission order (`KVNANDServer.submit`).

Every wait has a bound: a client's request line, headers and body are
read within `READ_TIMEOUT_S`, the engine thread is joined within
`JOIN_TIMEOUT_S`, and a start that does not come up within
`START_TIMEOUT_S` raises.

Prompts are token-id lists (this repo serves token-level models; there
is no tokenizer dependency to bake in).  `BackgroundServer` runs the
whole stack on a side thread for tests and notebook use:

    with BackgroundServer(ServerConfig(reduced=True, device="cpu")) as srv:
        host, port = srv.address
        ... http.client against (host, port) ...
"""
from __future__ import annotations

import argparse
import asyncio
import contextlib
import dataclasses
import json
import queue
import threading
import traceback
from typing import Dict, List, Optional, Tuple

import torch

from repro_torch.serving.api import (KVNANDServer, SamplingParams,
                                     ServerConfig, StreamEvent)
from repro_torch.serving.metrics import ServingMetrics

__all__ = ["AsyncServerConfig", "AsyncKVNANDServer", "BackgroundServer",
           "main"]

READ_TIMEOUT_S = 30.0       # a client's request line, headers and body
JOIN_TIMEOUT_S = 30.0       # the engine thread and the HTTP thread
START_TIMEOUT_S = 600.0     # building the model (and, on a card, its
                            # kernels at the first step) is not in it


@dataclasses.dataclass(frozen=True)
class AsyncServerConfig:
    """Front-door knobs (the model/scheduler side lives in
    `ServerConfig`).  ``max_queue`` bounds requests accepted but not yet
    admitted to a slot — beyond it the server answers 429.  ``overlap``
    selects the pipelined engine loop; off is the synchronous
    schedule."""
    host: str = "127.0.0.1"
    port: int = 0                   # 0 = ephemeral (CI-friendly)
    max_queue: int = 32
    overlap: bool = True
    default_max_tokens: int = 16
    metrics_window: int = 1024
    idle_poll_s: float = 0.02       # engine-thread block while fully idle


@dataclasses.dataclass
class _Submission:
    """One completion hopping from the asyncio thread to the engine."""
    prompt: List[int]
    params: SamplingParams
    priority: int
    deadline: Optional[float]
    future: "asyncio.Future[int]"           # resolves to the uid
    events: "asyncio.Queue[StreamEvent]"


class AsyncKVNANDServer:
    """The asyncio front door.  Owns the engine thread for its
    `KVNANDServer`; start with `await start()`, stop with `await
    aclose()` (or use `BackgroundServer` from synchronous code)."""

    def __init__(self, server: KVNANDServer,
                 config: Optional[AsyncServerConfig] = None):
        self._server = server
        self._acfg = config or AsyncServerConfig()
        self.metrics = ServingMetrics(window=self._acfg.metrics_window)
        self._cmd: "queue.Queue[Tuple[str, object]]" = queue.Queue()
        self._subs: Dict[int, "asyncio.Queue[StreamEvent]"] = {}
        self._stop = threading.Event()
        self._engine_exc: Optional[BaseException] = None
        self._loop: Optional[asyncio.AbstractEventLoop] = None
        self._http: Optional[asyncio.base_events.Server] = None
        self._engine: Optional[threading.Thread] = None
        self.address: Optional[Tuple[str, int]] = None
        # the card the server's tensors live on ("cuda" alone names the
        # constructing thread's current device)
        dev = server.engine.device
        self._cuda_index: Optional[int] = None
        if dev.type == "cuda":
            self._cuda_index = (dev.index if dev.index is not None
                                else torch.cuda.current_device())

    # -- lifecycle ------------------------------------------------------
    async def start(self):
        self._loop = asyncio.get_running_loop()
        self._engine = threading.Thread(target=self._engine_loop,
                                        name="kvnand-engine", daemon=True)
        self._engine.start()
        self._http = await asyncio.start_server(
            self._handle, self._acfg.host, self._acfg.port)
        self.address = self._http.sockets[0].getsockname()[:2]
        return self

    async def serve_forever(self):
        async with self._http:
            await self._http.serve_forever()

    async def aclose(self):
        if self._http is not None:
            self._http.close()
            await self._http.wait_closed()
        self._stop.set()
        if self._engine is not None:
            await self._loop.run_in_executor(None, self._engine.join,
                                             JOIN_TIMEOUT_S)
            if self._engine.is_alive():
                raise RuntimeError(
                    f"engine thread still running {JOIN_TIMEOUT_S} s "
                    "after stop")

    # -- engine thread: the overlapped scheduler loop -------------------
    def _engine_loop(self):
        srv, overlap = self._server, self._acfg.overlap
        try:
            if self._cuda_index is not None:
                torch.cuda.set_device(self._cuda_index)
            while not self._stop.is_set():
                worked = self._drain_commands()
                if not (srv._busy() or srv.pending_steps()):
                    if not worked:
                        self._apply_blocking()      # park until a command
                    continue
                if overlap:
                    # keep one step in flight ahead of the collect: the
                    # host side below (event routing, metrics, admits)
                    # then runs entirely under device compute
                    if srv.pending_steps() == 0 and srv._busy():
                        srv.dispatch()
                    if srv._busy():
                        srv.dispatch()
                    events = srv.collect()
                else:
                    events = srv.step()
                self._route_events(events)
        except BaseException as e:           # noqa: BLE001 — fail loud,
            self._engine_exc = e             # unblock every waiter
            traceback.print_exc()
            self._stop.set()
            self._drain_commands()

    def _apply_blocking(self):
        try:
            kind, payload = self._cmd.get(timeout=self._acfg.idle_poll_s)
        except queue.Empty:
            return
        self._apply(kind, payload)

    def _drain_commands(self) -> bool:
        worked = False
        while True:
            try:
                kind, payload = self._cmd.get_nowait()
            except queue.Empty:
                return worked
            self._apply(kind, payload)
            worked = True

    def _apply(self, kind: str, payload):
        if kind == "abort":
            self._server.abort(payload)
            # the abort's terminal marker event surfaces at the next
            # collect/step via _drain_events; route it even when the
            # scheduler goes idle
            self._route_events(self._server._drain_events())
            return
        sub: _Submission = payload
        if self._engine_exc is not None:
            self._resolve(sub.future,
                          RuntimeError("engine loop died"), exc=True)
            return
        try:
            uid = self._server.submit(sub.prompt, sub.params,
                                      priority=sub.priority,
                                      deadline=sub.deadline)
        except ValueError as e:
            self._resolve(sub.future, e, exc=True)
            return
        self._subs[uid] = sub.events
        self._resolve(sub.future, uid)

    def _resolve(self, fut, value, exc: bool = False):
        setter = fut.set_exception if exc else fut.set_result
        self._loop.call_soon_threadsafe(
            lambda: None if fut.cancelled() else setter(value))

    def _route_events(self, events: List[StreamEvent]):
        """Hand each event to its client's queue.  A terminal event is
        counted in the metrics (and its request released) BEFORE it is
        posted: a client that holds its final response, and scrapes
        `/metrics` next, must find the request counted.  (The
        reference posts first and counts after.)"""
        for ev in events:
            if ev.finish_reason is not None:
                q = self._subs.pop(ev.uid, None)
                try:
                    self.metrics.observe(self._server.output(ev.uid))
                    self._server.release(ev.uid)
                except (KeyError, ValueError):
                    pass                     # already released (abort race)
            else:
                q = self._subs.get(ev.uid)
            if q is not None:
                self._loop.call_soon_threadsafe(q.put_nowait, ev)

    # -- asyncio thread: HTTP ------------------------------------------
    def _overloaded(self) -> bool:
        return (len(self._server._batcher.queue) + self._cmd.qsize()
                >= self._acfg.max_queue)

    def _gauges(self) -> Dict[str, float]:
        b = self._server._batcher
        g = {"kvnand_queue_depth": float(len(b.queue)),
             "kvnand_running_requests":
                 float(sum(r is not None for r in b.slots)),
             "kvnand_pending_steps": float(b.pending_steps)}
        if b.alloc is not None:
            g["kvnand_pool_live_pages"] = float(b.alloc.live_count)
            g["kvnand_pool_util"] = (b.alloc.live_count
                                     / max(b.alloc.total, 1))
        if b.tier is not None:
            g["kvnand_tier_resident_pages"] = float(b.tier.resident_count)
        return g

    async def _handle(self, reader: asyncio.StreamReader,
                      writer: asyncio.StreamWriter):
        try:
            line = await asyncio.wait_for(reader.readline(),
                                          READ_TIMEOUT_S)
            if not line:
                return
            try:
                method, path, _ = line.decode("latin1").split(None, 2)
            except ValueError:
                return
            headers = {}
            while True:
                h = await asyncio.wait_for(reader.readline(),
                                           READ_TIMEOUT_S)
                if h in (b"\r\n", b"\n", b""):
                    break
                k, _, v = h.decode("latin1").partition(":")
                headers[k.strip().lower()] = v.strip()
            body = b""
            n = int(headers.get("content-length") or 0)
            if n:
                body = await asyncio.wait_for(reader.readexactly(n),
                                              READ_TIMEOUT_S)
            await self._route(method, path.split("?")[0], body, writer)
            await writer.drain()
        except (ConnectionError, asyncio.IncompleteReadError,
                asyncio.TimeoutError):
            pass
        finally:
            with contextlib.suppress(Exception):
                writer.close()

    @staticmethod
    def _respond(writer, status: str, payload: bytes,
                 ctype: str = "application/json",
                 extra: Tuple[str, ...] = ()):
        head = [f"HTTP/1.1 {status}", f"Content-Type: {ctype}",
                f"Content-Length: {len(payload)}", "Connection: close",
                *extra, "", ""]
        writer.write("\r\n".join(head).encode("latin1") + payload)

    def _error(self, writer, status: str, message: str,
               extra: Tuple[str, ...] = ()):
        self._respond(writer, status, json.dumps(
            {"error": {"message": message}}).encode(), extra=extra)

    async def _route(self, method: str, path: str, body: bytes, writer):
        if (method, path) == ("GET", "/healthz"):
            self._respond(writer, "200 OK",
                          b"ok\n" if self._engine_exc is None
                          else b"engine dead\n", ctype="text/plain")
        elif (method, path) == ("GET", "/metrics"):
            text = self.metrics.render(self._server.stats, self._gauges())
            self._respond(writer, "200 OK", text.encode(),
                          ctype="text/plain; version=0.0.4")
        elif (method, path) == ("POST", "/v1/completions"):
            await self._completions(body, writer)
        else:
            self._error(writer, "404 Not Found", f"no route {path}")

    async def _completions(self, body: bytes, writer):
        if self._stop.is_set() or self._engine_exc is not None:
            return self._error(writer, "503 Service Unavailable",
                               "engine loop is not running")
        try:
            payload = json.loads(body or b"{}")
        except json.JSONDecodeError as e:
            return self._error(writer, "400 Bad Request",
                               f"invalid JSON body: {e}")
        prompt = payload.get("prompt")
        if (not isinstance(prompt, list)
                or not all(isinstance(t, int) and not isinstance(t, bool)
                           for t in prompt)):
            return self._error(writer, "400 Bad Request",
                               "prompt must be a list of token ids")
        if self._overloaded():
            self.metrics.observe_rejected()
            return self._error(writer, "429 Too Many Requests",
                               "admission queue is full; retry later",
                               extra=("Retry-After: 1",))
        try:
            params = SamplingParams(
                max_new_tokens=int(payload.get(
                    "max_tokens", self._acfg.default_max_tokens)),
                temperature=float(payload.get("temperature", 0.0)),
                top_k=int(payload.get("top_k", 0)),
                top_p=float(payload.get("top_p", 1.0)),
                seed=payload.get("seed"),
                stop_token_ids=tuple(payload.get("stop_token_ids", ())),
                logprobs=bool(payload.get("logprobs", False)))
            priority = int(payload.get("priority", 0))
            deadline = payload.get("deadline_s")
            deadline = None if deadline is None else float(deadline)
        except (TypeError, ValueError) as e:
            return self._error(writer, "400 Bad Request", str(e))
        sub = _Submission(prompt=prompt, params=params, priority=priority,
                          deadline=deadline,
                          future=self._loop.create_future(),
                          events=asyncio.Queue())
        self._cmd.put(("submit", sub))
        try:
            uid = await sub.future
        except (ValueError, RuntimeError) as e:
            return self._error(writer, "400 Bad Request", str(e))
        if payload.get("stream"):
            await self._stream_response(writer, uid, sub.events)
        else:
            await self._oneshot_response(writer, uid, sub.events,
                                         len(prompt))

    async def _next_event(self, events) -> Optional[StreamEvent]:
        """Wait for the request's next event, giving up if the engine
        thread dies underneath the wait."""
        while True:
            try:
                return await asyncio.wait_for(events.get(), timeout=1.0)
            except asyncio.TimeoutError:
                if self._stop.is_set() or self._engine_exc is not None:
                    return None

    async def _oneshot_response(self, writer, uid: int, events,
                                n_prompt: int):
        token_ids, logprobs, reason = [], [], None
        while reason is None:
            ev = await self._next_event(events)
            if ev is None:
                return self._error(writer, "503 Service Unavailable",
                                   "engine loop died mid-request")
            if ev.token is not None:
                token_ids.append(ev.token)
                if ev.logprob is not None:
                    logprobs.append(ev.logprob)
            reason = ev.finish_reason
        self._respond(writer, "200 OK", json.dumps({
            "id": f"cmpl-{uid}", "object": "text_completion",
            "model": self._server.cfg.name,
            "choices": [{"index": 0, "token_ids": token_ids,
                         "logprobs": logprobs or None,
                         "finish_reason": reason}],
            "usage": {"prompt_tokens": n_prompt,
                      "completion_tokens": len(token_ids),
                      "total_tokens": n_prompt + len(token_ids)}
        }).encode())

    async def _stream_response(self, writer, uid: int, events):
        writer.write(b"HTTP/1.1 200 OK\r\n"
                     b"Content-Type: text/event-stream\r\n"
                     b"Cache-Control: no-cache\r\n"
                     b"Connection: close\r\n\r\n")
        try:
            reason = None
            while reason is None:
                ev = await self._next_event(events)
                if ev is None:
                    break
                chunk = {"id": f"cmpl-{uid}",
                         "object": "text_completion.chunk",
                         "choices": [{"index": 0, "token": ev.token,
                                      "position": ev.index,
                                      "logprob": ev.logprob,
                                      "finish_reason": ev.finish_reason}]}
                writer.write(f"data: {json.dumps(chunk)}\n\n".encode())
                await writer.drain()
                reason = ev.finish_reason
            writer.write(b"data: [DONE]\n\n")
            await writer.drain()
        except ConnectionError:
            # client went away mid-stream: reclaim the slot and pages
            self._cmd.put(("abort", uid))


class BackgroundServer:
    """Run the whole async stack (model + engine thread + HTTP) on a
    side thread — the synchronous-code entry point used by tests and
    the README.  Context-manager protocol; `address` is the bound (host,
    port)."""

    def __init__(self, config: Optional[ServerConfig] = None,
                 async_config: Optional[AsyncServerConfig] = None, *,
                 cfg=None, params=None):
        self._config, self._acfg = config, async_config
        self._cfg, self._params = cfg, params
        self._ready = threading.Event()
        self._startup_exc: Optional[BaseException] = None
        self._aloop: Optional[asyncio.AbstractEventLoop] = None
        self._astop: Optional[asyncio.Event] = None
        self._thread: Optional[threading.Thread] = None
        self.address: Optional[Tuple[str, int]] = None
        self.server: Optional[AsyncKVNANDServer] = None

    async def _amain(self):
        self._aloop = asyncio.get_running_loop()
        self._astop = asyncio.Event()
        try:
            inner = KVNANDServer(self._config, cfg=self._cfg,
                                 params=self._params)
            self.server = AsyncKVNANDServer(inner, self._acfg)
            await self.server.start()
            self.address = self.server.address
        except BaseException as e:           # noqa: BLE001
            self._startup_exc = e
            self._ready.set()
            raise
        self._ready.set()
        await self._astop.wait()
        await self.server.aclose()

    def __enter__(self) -> "BackgroundServer":
        self._thread = threading.Thread(
            target=lambda: asyncio.run(self._amain()),
            name="kvnand-http", daemon=True)
        self._thread.start()
        if not self._ready.wait(timeout=START_TIMEOUT_S):
            raise RuntimeError(
                f"async server did not start within {START_TIMEOUT_S} s")
        if self._startup_exc is not None:
            raise RuntimeError("async server failed to start") \
                from self._startup_exc
        return self

    def __exit__(self, *exc):
        if self._aloop is not None and self._astop is not None:
            self._aloop.call_soon_threadsafe(self._astop.set)
        if self._thread is not None:
            self._thread.join(timeout=JOIN_TIMEOUT_S)
        return False


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.serving.async_server",
        description="KVNAND async HTTP serving front door")
    ap.add_argument("--arch", default="qwen1.5-0.5b")
    ap.add_argument("--reduced", action="store_true",
                    help="CI-scale model dims")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8777)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-context", type=int, default=256)
    ap.add_argument("--max-queue", type=int, default=32)
    ap.add_argument("--no-overlap", action="store_true",
                    help="synchronous engine loop (ablation)")
    ap.add_argument("--device", default="cuda",
                    help="where the weights, the KV pool and the kernels "
                    "live (cpu runs the kernels' plain versions)")
    args = ap.parse_args(argv)

    async def _run():
        inner = KVNANDServer(ServerConfig(
            arch=args.arch, reduced=args.reduced,
            batch_slots=args.slots, max_context=args.max_context,
            device=args.device))
        srv = AsyncKVNANDServer(inner, AsyncServerConfig(
            host=args.host, port=args.port, max_queue=args.max_queue,
            overlap=not args.no_overlap))
        await srv.start()
        host, port = srv.address
        print(f"[async_server] listening on http://{host}:{port} "
              f"(overlap={'off' if args.no_overlap else 'on'})",
              flush=True)
        try:
            await srv.serve_forever()
        except asyncio.CancelledError:
            pass
        finally:
            await srv.aclose()

    try:
        asyncio.run(_run())
    except KeyboardInterrupt:
        pass
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
