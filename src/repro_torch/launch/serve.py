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
  PYTHONPATH=src python -m repro_torch.launch.serve --speculation-k 2

Takes the reference's flags for what the port serves.  `--use-dse` takes
the variant, kv_quant and speculation_k from the design-space search
(`core/dse.recommend_engine_config`) and serves float weights, as the
reference does.  The flags of paths not ported yet, and a configuration
the port does not serve yet, exit with an error naming their ROADMAP
item.
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

# flag -> (the value that leaves it off, the ROADMAP item that ports it)
_UNPORTED = {
    "hot_pages": (0, "A12, tiered pool"),
    "no_tier_prefetch": (False, "A12, tiered pool"),
    "overlap": (False, "A13, overlapped dispatch"),
    "http": (False, "A13, HTTP front end"),
    "port": (None, "A13, HTTP front end"),
}


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
    ap.add_argument("--hot-pages", type=int, default=0)
    ap.add_argument("--no-tier-prefetch", action="store_true")
    ap.add_argument("--speculation-k", type=int, default=None,
                    help="draft tokens verified per decode step (prompt "
                    "lookup); 0 decodes sequentially, unset takes the "
                    "EngineConfig's (e.g. a --use-dse pick)")
    ap.add_argument("--overlap", action="store_true")
    ap.add_argument("--http", action="store_true")
    ap.add_argument("--port", type=int, default=None)
    return ap


def _device_name(device: torch.device) -> str:
    if device.type == "cuda":
        return torch.cuda.get_device_name(device)
    return device.type.upper()


def serve(argv=None):
    ap = _parser()
    args = ap.parse_args(argv)
    for flag, (off, item) in _UNPORTED.items():
        if getattr(args, flag) != off:
            ap.error(f"--{flag.replace('_', '-')} is not ported yet "
                     f"(ROADMAP {item})")

    pool_kw = dict(shared_pool=args.shared_pool,
                   total_pages=args.total_pages)
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
            speculation_k=args.speculation_k, device=args.device))
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
    for o in outs[:3]:
        print(f"  req {o.uid}: {len(o.token_ids)} tokens "
              f"({o.finish_reason}) -> {o.token_ids[:8]}...")
    return {o.uid: o for o in outs}


if __name__ == "__main__":
    serve()
