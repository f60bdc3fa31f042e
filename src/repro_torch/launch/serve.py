"""Serving entry point of the port (port of `repro.launch.serve`): batched
requests through `KVNANDServer` on the card — per-request SamplingParams,
TTFT/TPOT reporting.

  PYTHONPATH=src python -m repro_torch.launch.serve --reduced --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen1.5-0.5b \\
      --requests 8 --max-new 16 --scheduler splice
  PYTHONPATH=src python -m repro_torch.launch.serve --arch rwkv6-3b
  PYTHONPATH=src python -m repro_torch.launch.serve --arch llama2-7b \
      --use-dse --max-context 128
  PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma3-12b \
      --use-dse --max-context 2048
  PYTHONPATH=src python -m repro_torch.launch.serve --arch hymba-1.5b \
      --use-dse --max-context 2048
  PYTHONPATH=src python -m repro_torch.launch.serve --arch mixtral-8x7b \
      --reduced --use-dse --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve --arch pixtral-12b \
      --reduced --use-dse --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve --speculation-k 2
  PYTHONPATH=src python -m repro_torch.launch.serve --shared-pool \
      --total-pages 64 --hot-pages 12
  PYTHONPATH=src python -m repro_torch.launch.serve --overlap
  PYTHONPATH=src python -m repro_torch.launch.serve --http --port 8777

Takes every flag of the reference's `launch/serve.py`, and `--device`.
`--use-dse` takes the variant, kv_quant and speculation_k from the
design-space search (`core/dse.recommend_engine_config`) and serves float
weights, as the reference does.  pixtral-12b serves as text (the
schedulers feed no patch embeddings, in either package); whisper-base's
first step raises the reference's ValueError (chunked prefill) or
KeyError (`--scheduler splice`: no frames), as the reference's
`launch.serve` ends.  `--http` serves over HTTP instead of
running the batch trace (`serving/async_server.py`; as in the reference
it takes --arch, --reduced, --slots, --max-context, --port and
--overlap, and here --device).  A configuration the port does not serve
yet exits with an error naming its ROADMAP item.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import EngineConfig
from repro_torch.core.dse import recommend_engine_config
from repro_torch.kernels import _build
from repro_torch.serving.api import (KVNANDServer, SamplingParams,
                                     ServerConfig, accepted_tokens_per_step,
                                     latency_percentile)

def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.serve")
    ap.add_argument("--arch", default="qwen1.5-0.5b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-context", type=int, default=256)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--top-k", type=int, default=0)
    ap.add_argument("--top-p", type=float, default=1.0)
    ap.add_argument("--seed", type=int, default=None,
                    help="per-request sampling seed (bit-reproducible "
                    "output regardless of batch composition)")
    ap.add_argument("--scheduler", choices=("interleaved", "splice"),
                    default="interleaved",
                    help="interleaved: chunked prefill shares each step "
                    "with the decode batch; splice: admit-time full "
                    "prefill (baseline)")
    ap.add_argument("--chunk-tokens", type=int, default=64,
                    help="prefill chunk size (multiple of page_tokens)")
    ap.add_argument("--shared-pool", action="store_true",
                    help="shared-pool paged KV: one physical page pool, "
                    "admission by free pages, prefix-cache sharing with "
                    "COW")
    ap.add_argument("--total-pages", type=int, default=0,
                    help="shared-pool size in pages (0: slots x pages per "
                    "max_context)")
    ap.add_argument("--device", default="cuda",
                    help="where the weights, the KV pool and the kernels "
                    "live (cpu runs the kernels' plain versions)")
    ap.add_argument("--use-dse", action="store_true",
                    help="pick the variant, kv_quant and speculation_k from "
                    "the design-space search (float weights)")
    ap.add_argument("--hot-pages", type=int, default=0,
                    help="tiered pool: keep only this many pages on the "
                    "device (the hot tier) and stage the rest from the "
                    "capacity tier; 0 = single tier.  Requires "
                    "--shared-pool; repro_torch.core.dse."
                    "recommend_hot_pages derives a value from the flash "
                    "model")
    ap.add_argument("--no-tier-prefetch", action="store_true",
                    help="disable the queue-ahead hot-tier prefetch (every "
                    "capacity-tier map-in stalls)")
    ap.add_argument("--speculation-k", type=int, default=None,
                    help="draft tokens verified per decode step (prompt "
                    "lookup); 0 decodes sequentially, unset takes the "
                    "EngineConfig's (e.g. a --use-dse pick)")
    ap.add_argument("--overlap", action="store_true",
                    help="pipelined stepping: dispatch step N+1 before "
                    "collecting step N, so host bookkeeping runs while "
                    "the card computes; the same tokens as the "
                    "synchronous loop")
    ap.add_argument("--http", action="store_true",
                    help="serve over HTTP instead of running the batch "
                    "trace: POST /v1/completions (one-shot and SSE), GET "
                    "/metrics (repro_torch.serving.async_server)")
    ap.add_argument("--port", type=int, default=8777,
                    help="HTTP port for --http (0 = ephemeral)")
    return ap


def _device_name(device: torch.device) -> str:
    if device.type == "cuda":
        return torch.cuda.get_device_name(device)
    return device.type.upper()


def serve(argv=None):
    ap = _parser()
    args = ap.parse_args(argv)

    if args.http:
        from repro_torch.serving.async_server import main as http_main
        http_argv = ["--arch", args.arch, "--port", str(args.port),
                     "--slots", str(args.slots),
                     "--max-context", str(args.max_context),
                     "--device", args.device]
        if args.reduced:
            http_argv.append("--reduced")
        if not args.overlap:
            http_argv.append("--no-overlap")
        return http_main(http_argv)

    pool_kw = dict(shared_pool=args.shared_pool,
                   total_pages=args.total_pages, hot_pages=args.hot_pages)
    if args.use_dse:
        eng = recommend_engine_config(args.arch, args.max_context)
        eng = EngineConfig(**{**eng.__dict__, "page_tokens": 16,
                              "uniform_lengths": False, "quant": "none",
                              **pool_kw})
        print(f"[serve] DSE picked variant={eng.variant} "
              f"kv_quant={eng.kv_quant}")
    else:
        eng = EngineConfig(page_tokens=16, uniform_lengths=False, **pool_kw)
    spec_k = (args.speculation_k if args.speculation_k is not None
              else eng.speculation_k)
    try:
        server = KVNANDServer(ServerConfig(
            arch=args.arch, reduced=args.reduced, engine=eng,
            scheduler=args.scheduler, batch_slots=args.slots,
            max_context=args.max_context,
            prefill_chunk_tokens=args.chunk_tokens,
            speculation_k=args.speculation_k,
            tier_prefetch=not args.no_tier_prefetch, overlap=args.overlap,
            device=args.device))
    except NotImplementedError as e:
        ap.error(str(e))
    cfg = server.cfg
    where = _device_name(torch.device(args.device))
    sp = SamplingParams(temperature=args.temperature, top_k=args.top_k,
                        top_p=args.top_p, seed=args.seed,
                        max_new_tokens=args.max_new)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size,
                            int(rng.integers(4, 24))).tolist()
               for _ in range(args.requests)]
    if server.engine.device.type == "cuda":
        _build.build()      # else the first launch's nvcc lands in TTFT
    t0 = time.time()
    outs = server.generate(prompts, sp)
    dt = time.time() - t0
    total_tokens = sum(len(o.token_ids) for o in outs)
    st = server.stats
    print(f"[serve] {len(outs)} requests, {total_tokens} tokens in "
          f"{dt:.1f}s ({total_tokens / dt:.1f} tok/s on {where})")
    print(f"[serve] scheduler={args.scheduler}: {st['steps']} steps, "
          f"{st['prefill_chunks']} prefill chunks, "
          f"{st['decode_stall_tokens']} decode-stall tokens over "
          f"{st['admits']} admits")
    ttfts = [o.ttft for o in outs]
    tpots = [o.tpot for o in outs]
    print(f"[serve] TTFT p50/p95 {latency_percentile(ttfts, 50) * 1e3:.0f}/"
          f"{latency_percentile(ttfts, 95) * 1e3:.0f} ms, "
          f"TPOT p50/p95 {latency_percentile(tpots, 50) * 1e3:.0f}/"
          f"{latency_percentile(tpots, 95) * 1e3:.0f} ms (on {where})")
    if spec_k > 0 and st["spec_steps"]:
        per_step = accepted_tokens_per_step(st["spec_accepted"],
                                            st["spec_steps"])
        print(f"[serve] speculation k={spec_k}: "
              f"{per_step:.2f} tokens/verify-step "
              f"({st['spec_accepted']}/{st['spec_drafted']} drafts "
              "accepted)")
    if args.shared_pool and st["pool_total_pages"]:
        hit_rate = st["prefix_hit_pages"] / max(st["prompt_pages"], 1)
        print(f"[serve] shared pool: peak {st['pool_peak_pages']}/"
              f"{st['pool_total_pages']} pages live, "
              f"{hit_rate:.0%} prompt pages from prefix cache, "
              f"{st['cow_copies']} COW copies")
    if st["tier_hot_slots"]:
        touched = st["tier_hit_pages"] + st["tier_miss_pages"]
        tier_hr = st["tier_hit_pages"] / max(touched, 1)
        print(f"[serve] tiered pool: {st['tier_hot_slots']} hot slots "
              f"(peak {st['tier_peak_hot']} resident), "
              f"{tier_hr:.0%} cached map-ins hot, "
              f"{st['tier_stall_tokens']} stall tokens, "
              f"{st['tier_promotes']} promotes / {st['tier_demotes']} "
              f"demotes ({st['tier_prefetch_pages']} prefetched)")
    for o in outs[:3]:
        print(f"  req {o.uid}: {len(o.token_ids)} tokens "
              f"({o.finish_reason}) -> {o.token_ids[:8]}...")
    return {o.uid: o for o in outs}


if __name__ == "__main__":
    serve()
