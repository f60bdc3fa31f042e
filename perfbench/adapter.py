"""The benchmark's one point of contact with the program, `repro_torch`:
its configuration, its parameter tree, its server, the engine calls it
makes and the kernel entry points it launches.  Everything else under
`perfbench/` is the yardstick and imports none of the program.

Instrumentation is installed from here at run time and never edits a
program file: `record_chunks` wraps the engine's `prefill_chunk` on the
server's own engine object to note each chunk's start and valid length
(host arguments, no device read), and `trace_ranges` wraps the entry
points of the MoE layer and of kernels B1, B2 and B3 in named profiler
ranges for the traced steps only, noting each B1 / B2 / B3 launch's
host-side shapes.
"""
from __future__ import annotations

import contextlib
import functools
import inspect
from typing import Any, Callable, Dict, List

import torch

from perfbench.weights import Packed

def model_config(name: str, model: Dict[str, Any]):
    """The port's `ModelConfig` of a configuration's "model" block."""
    from repro_torch.configs.base import ModelConfig
    keys = {f for f in inspect.signature(ModelConfig).parameters}
    return ModelConfig(name=name, **{k: v for k, v in model.items()
                                     if k in keys})


def _qw(p: Packed):
    """The port's W4A16 leaf over the same code and scale tensors."""
    from repro_torch.core.quant import QuantizedWeight
    shape = tuple(p.codes.shape[:-2]) + (2 * p.codes.shape[-2],
                                         p.codes.shape[-1])
    return QuantizedWeight(p.codes, p.scale, "w4a16", shape)


def _w8a8(p: Packed):
    """The same weight values as int8 codes (the program's W8A8 path)."""
    from repro_torch.core.quant import QuantizedWeight, unpack_int4
    codes = unpack_int4(p.codes)
    return QuantizedWeight(codes.contiguous(), p.scale, "w8a8",
                           tuple(codes.shape))


def params(w: Dict[str, Any], w8a8_2d: bool = False) -> Dict[str, Any]:
    """The port's parameter tree over the benchmark's weights (no copy).
    `w8a8_2d` serves the 2-D projections (those the program sends
    through its quantized GEMV) on its W8A8 path instead, with the same
    weight values: the control of lower activation precision."""
    lw = w["layers"]

    def two_d(p: Packed):
        return _w8a8(p) if w8a8_2d else _qw(p)

    attn = {n + "_w": _qw(lw[n]) for n in ("wq", "wk", "wv")}
    attn["wo_w"] = two_d(lw["wo"])
    layers = {"ln1": lw["ln1"], "ln2": lw["ln2"], "attn": attn}
    if "router" in lw:
        layers["moe"] = {"router_w": lw["router"],
                         **{n: _qw(lw[n]) for n in ("w_gate", "w_up",
                                                    "w_down")}}
    else:
        layers["mlp"] = {n + "_w": two_d(lw[n])
                         for n in ("gate", "up", "down")}
    return {"embedding": w["embedding"], "lm_head": w["lm_head"],
            "final_norm": w["final_norm"], "layers": layers}


def server(cfg, tree, srv: Dict[str, Any], device: str, kv_quant: str):
    """A `KVNANDServer` for a cell's "server" block."""
    from repro_torch.configs.base import EngineConfig
    from repro_torch.models.transformer import Runtime
    from repro_torch.serving.api import KVNANDServer, ServerConfig
    eng = EngineConfig(page_tokens=srv["page_tokens"], uniform_lengths=False,
                       quant="w4a16", kv_dtype=srv["kv_dtype"],
                       kv_quant=kv_quant, shared_pool=srv["shared_pool"],
                       total_pages=srv.get("total_pages", 0))
    conf = ServerConfig(arch=srv["arch"], engine=eng, scheduler="interleaved",
                        batch_slots=srv["batch_slots"],
                        max_context=srv["max_context"],
                        prefill_chunk_tokens=srv["prefill_chunk_tokens"],
                        overlap=False, device=device)
    rt = Runtime(moe_capacity=cfg.capacity_factor)
    return KVNANDServer(conf, cfg=cfg, params=tree, rt=rt)


def sampling(max_new: int):
    from repro_torch.serving.api import SamplingParams
    return SamplingParams(temperature=0.0, max_new_tokens=max_new,
                          logprobs=True)


def record_chunks(srv, sink: List[tuple]) -> None:
    """Note (start, valid tokens) of every prefill chunk the server's
    engine runs, in order."""
    eng = srv.engine
    fn = eng.prefill_chunk
    sig = inspect.signature(fn)

    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        b = sig.bind(*args, **kwargs)
        sink.append((int(b.arguments["start"]),
                     int(b.arguments["chunk_len"])))
        return fn(*args, **kwargs)

    eng.prefill_chunk = wrapped


@contextlib.contextmanager
def trace_ranges(srv, launches: List[tuple]):
    """Inside: `moe` and the B1 / B2 / B3 launchers run in profiler
    ranges "perfbench.<name>", each launch appending (name, shape info);
    so do the scheduler's dispatch and collect and the engine's
    decode_step and prefill_chunk on `srv`'s own objects, which name the
    host's work in the idle gaps; the two engine calls append (name,
    None), marking where each pass's launches begin."""
    from repro_torch.kernels.paged_attention import ops as pa
    from repro_torch.kernels.quant_gemv import ops as qg
    from repro_torch.models import transformer as tr

    def ranged(name: str, fn: Callable, info: Callable = None):
        @functools.wraps(fn)
        def wrapped(*args, **kwargs):
            if info is not None:
                launches.append((name, info(*args, **kwargs)))
            with torch.profiler.record_function(f"perfbench.{name}"):
                return fn(*args, **kwargs)
        return wrapped

    def attn_info(q, kp, *a, **k):          # q4 [B, K, G, dh]
        return tuple(q.shape)

    def gemv_info(x, q, scale, scheme, *a, **k):
        return (int(x.shape[0]), int(x.shape[1]), int(q.shape[1]), scheme)

    saved = [(tr, "moe", tr.moe),
             (pa, "paged_attention_cuda", pa.paged_attention_cuda),
             (pa, "paged_attention_shared_cuda",
              pa.paged_attention_shared_cuda),
             (qg, "quant_gemv_cuda", qg.quant_gemv_cuda)]
    def marker(*a, **k):
        return None

    batcher = getattr(srv, "_batcher", None)
    objs = [(o, n, info) for o, n, info in (
        (batcher, "dispatch", None), (batcher, "collect", None),
        (srv.engine, "decode_step", marker),
        (srv.engine, "prefill_chunk", marker)) if hasattr(o, n)]
    for obj, name, info in objs:
        setattr(obj, name, ranged(name, getattr(obj, name), info))
    tr.moe = ranged("moe", tr.moe)
    pa.paged_attention_cuda = ranged("b1", pa.paged_attention_cuda,
                                     attn_info)
    pa.paged_attention_shared_cuda = ranged(
        "b2", pa.paged_attention_shared_cuda, attn_info)
    qg.quant_gemv_cuda = ranged("b3", qg.quant_gemv_cuda, gemv_info)
    try:
        yield
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)
        for obj, name, _ in objs:
            setattr(obj, name, getattr(obj, name).__wrapped__)
