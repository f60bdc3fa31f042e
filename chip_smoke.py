#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA card and check it.

    python3 chip_smoke.py

Phases (each one fails the run when it fails):

1. build    the paged decode-attention kernel from src/repro_torch/csrc
            with nvcc (sm_90a), timed;
2. kernel   hold the kernel against its plain torch version on the card:
            {f32, bf16, kv8, kv4} pools x partitions {1, 16} x window
            {None, 64} x head shapes (K=16, G=1, dh=64) (qwen1.5-0.5b) and
            (K=8, G=4, dh=128) (llama3.1-8b), with ragged lengths, a
            length-1 row, a row with unwritten pages and an all-masked row;
3. timing   kernel, plain version and a library yardstick
            (scaled_dot_product_attention on pre-gathered K/V) at the
            serving shape (B=4, 512 tokens, bf16) and a long shape (B=1,
            100K tokens, bf16, 16 partitions), beside the HBM-byte bound;
4. server   `KVNANDServer` at the full width of qwen1.5-0.5b (random
            weights from a seed) answers 6 greedy requests of 5-200 prompt
            tokens x 16 new tokens; the kernel's launch counter must equal
            decode steps x 24 layers;
5. check    every served token against a kernel-free reference on the
            card: the port's plain full forward, teacher-forced on
            prompt + output.

It needs a CUDA card (exits non-zero without one, printing no result),
imports nothing of JAX, and prints the card's name and power limit, a
{"kernels": [...]} line and, last, {"ok": true, "device": {...}}.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# tolerances: f32 and kv8/kv4 (codes contracted in f32 on both sides) are
# held to the reference's f32 tolerance; bf16 pools to its bf16 one (the
# plain version rounds q and p to bf16, the kernel keeps them in f32) and,
# besides, to the f32 one against the plain version on the pools upcast to
# f32, which is the kernel's own arithmetic
TOL = {"f32": 2e-5, "bf16": 3e-2, "kv8": 2e-5, "kv4": 2e-5}
# served logprob vs the f32 teacher-forced reference: the served K/V pass
# through the bf16 pool, the reference's do not
LOGPROB_TOL = 2e-2
LOGIT_GAP_TOL = 1e-3

# HBM bandwidth by SKU (NVIDIA data sheets); float32 CUDA-core peak
HBM_BYTES_PER_S = {"H100 PCIe": 2.0e12, "H100 NVL": 3.9e12, "H200": 4.8e12,
                   "H100": 3.35e12}
F32_FLOPS = 67e12
# cycles of torch.cuda._sleep queued ahead of each timed launch (~2.5 ms
# at the H100's clock), so that the host has enqueued the whole timed
# call before the start event fires and the window holds device time only
SLEEP_CYCLES = 5_000_000


def check(cond: bool, msg: str):
    if not cond:
        raise RuntimeError(msg)


def smi_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def hbm_rate(name: str) -> float:
    for key, rate in HBM_BYTES_PER_S.items():
        if key in name:
            return rate
    raise RuntimeError(f"no HBM bandwidth on file for {name!r}")


# ---------------------------------------------------------------------------
# inputs
# ---------------------------------------------------------------------------

def make_inputs(B, K, G, NP, T, dh, fmt, lengths, gen, unwritten_row=None):
    """Random q and pools on the card; kv8/kv4 pools are the port's own
    quantized pages (codes + per-page scales)."""
    import torch
    from repro_torch.core.quant import quantize_kv_page
    dev = "cuda"
    q = torch.randn(B, K * G, dh, generator=gen, device=dev)
    kd = torch.randn(B, K, NP, T, dh, generator=gen, device=dev)
    vd = torch.randn(B, K, NP, T, dh, generator=gen, device=dev)
    base = (torch.arange(NP, device=dev, dtype=torch.int32) * T)[None]
    base = base.repeat(B, 1)
    if unwritten_row is not None:
        base[unwritten_row, NP // 2:] = -1
    length = torch.tensor(lengths, dtype=torch.int32, device=dev)
    ks = vs = None
    if fmt in ("kv8", "kv4"):
        kp, ks = quantize_kv_page(kd, fmt)
        vp, vs = quantize_kv_page(vd, fmt)
    else:
        dt = torch.float32 if fmt == "f32" else torch.bfloat16
        kp, vp = kd.to(dt), vd.to(dt)
    return q, kp, vp, base, length, ks, vs


def kv_quant_of(fmt: str) -> str:
    return fmt if fmt in ("kv8", "kv4") else "none"


def close_err(a, b, tol: float) -> float:
    """max |a - b| / (1 + |b|): <= tol means within atol = rtol = tol."""
    return float(((a.float() - b.float()).abs() / (1 + b.float().abs()))
                 .max())


# ---------------------------------------------------------------------------
# phase 2: kernel vs plain
# ---------------------------------------------------------------------------

def kernel_phase() -> float:
    import torch
    from repro_torch.kernels.paged_attention import (
        paged_attention_partial, paged_attention_partial_ref)
    gen = torch.Generator(device="cuda").manual_seed(0)
    NP, T = 32, 16
    lengths = [512, 300, 1, 400, 0]    # row 3 has unwritten pages, row 4
    max_abs = 0.0                      # attends nothing
    n = 0
    for K, G, dh in ((16, 1, 64), (8, 4, 128)):
        for fmt in ("f32", "bf16", "kv8", "kv4"):
            for P in (1, 16):
                for window in (None, 64):
                    q, kp, vp, base, length, ks, vs = make_inputs(
                        5, K, G, NP, T, dh, fmt, lengths, gen,
                        unwritten_row=3)
                    kvq = kv_quant_of(fmt)
                    o, m, l = paged_attention_partial(
                        q, kp, vp, base, length, window=window,
                        kv_quant=kvq, k_scale=ks, v_scale=vs, partitions=P)
                    torch.cuda.synchronize()
                    ro, rm, rl = paged_attention_partial_ref(
                        q, kp, vp, base, length, window=window,
                        kv_quant=kvq, k_scale=ks, v_scale=vs)
                    err = max(close_err(o, ro, TOL[fmt]),
                              close_err(m, rm, TOL[fmt]),
                              close_err(l, rl, TOL[fmt]))
                    if fmt == "bf16":
                        fo, fm, fl = paged_attention_partial_ref(
                            q, kp.float(), vp.float(), base, length,
                            window=window)
                        err32 = max(close_err(o, fo, TOL["f32"]),
                                    close_err(m, fm, TOL["f32"]),
                                    close_err(l, fl, TOL["f32"]))
                        print(f"kernel K={K} G={G} dh={dh} bf16 P={P:2d} "
                              f"window={window}: vs plain on f32-upcast "
                              f"pools rel_err={err32:.3e} "
                              f"tol={TOL['f32']:.0e}")
                        check(err32 <= TOL["f32"], "bf16 kernel disagrees "
                              f"with its own arithmetic: {err32:.3e}")
                    abs_o = float((o - ro).abs().max())
                    finite = bool(torch.isfinite(o).all()
                                  and torch.isfinite(m).all()
                                  and torch.isfinite(l).all())
                    empty_ok = bool((o[4] == 0).all() and (l[4] == 0).all()
                                    and (m[4] == -1e30).all())
                    print(f"kernel K={K} G={G} dh={dh} {fmt:4s} P={P:2d} "
                          f"window={window}: max_abs_err(o)={abs_o:.3e} "
                          f"rel_err={err:.3e} tol={TOL[fmt]:.0e}")
                    check(finite, "kernel output not finite")
                    check(empty_ok, "all-masked row is not o=0, m=-1e30, l=0")
                    check(err <= TOL[fmt], f"kernel disagrees with plain "
                          f"version: {err:.3e} > {TOL[fmt]:.0e}")
                    max_abs = max(max_abs, abs_o)
                    n += 1
    print(f"kernel phase: {n} cases within tolerance, "
          f"max_abs_err(o)={max_abs:.3e}")
    return max_abs


# ---------------------------------------------------------------------------
# phase 3: timing
# ---------------------------------------------------------------------------

def time_ms(fn, reps: int, flush) -> list:
    """Device times of fn() over `reps` launches, each timed by CUDA events
    with the L2 cache flushed before it (a decode step finds the layer's
    pages cold: the layer's weights pass through L2 in between).  A sleep
    kernel queued after the flush keeps the stream busy while the host
    runs fn()'s wrapper, so host launch latency stays outside the window."""
    import torch
    fn()
    torch.cuda.synchronize()
    pairs = []
    for _ in range(reps):
        flush.zero_()
        torch.cuda._sleep(SLEEP_CYCLES)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        pairs.append((a, b))
    torch.cuda.synchronize()
    return sorted(a.elapsed_time(b) for a, b in pairs)


def timing_shape(label, B, K, G, NP, T, dh, lengths, partitions, rate,
                 flush, gen):
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.paged_attention import (
        paged_attention_cuda, paged_attention_partial_ref,
        resolve_partitions)
    q, kp, vp, base, length, _, _ = make_inputs(B, K, G, NP, T, dh, "bf16",
                                                lengths, gen)
    P = resolve_partitions(partitions, NP)
    q4 = q.reshape(B, K, G, dh).contiguous()
    kernel_t = time_ms(lambda: paged_attention_cuda(
        q4, kp, vp, base, length, partitions=P), 20, flush)
    plain_t = time_ms(lambda: paged_attention_partial_ref(
        q, kp, vp, base, length), 5, flush)
    # library yardstick: one SDPA call on K/V pre-gathered to contiguous
    # [B, H, L, dh] (every row here has the same length)
    L = lengths[0]
    check(all(x == L for x in lengths), "timing rows must share a length")
    kc = kp.reshape(B, K, NP * T, dh)[:, :, :L]
    vc = vp.reshape(B, K, NP * T, dh)[:, :, :L]
    if G > 1:
        kc = kc.repeat_interleave(G, dim=1)
        vc = vc.repeat_interleave(G, dim=1)
    kc, vc = kc.contiguous(), vc.contiguous()
    qc = q.to(torch.bfloat16)[:, :, None]
    library_t = time_ms(lambda: F.scaled_dot_product_attention(qc, kc, vc),
                        20, flush)
    kernel_ms, plain_ms, library_ms = map(statistics.median,
                                          (kernel_t, plain_t, library_t))
    # least work: each valid token's K and V read once (bf16), q read, the
    # partials written, base/length read; QK + PV multiply-adds in f32
    valid = sum(lengths)
    kv_bytes = valid * K * dh * 2 * 2
    io_bytes = (B * K * G * dh * 4 + B * K * P * G * (dh + 2) * 4
                + B * NP * 4 + B * 4)
    flops = 4 * valid * K * G * dh
    t_bytes = (kv_bytes + io_bytes) / rate * 1e3
    t_ops = flops / F32_FLOPS * 1e3
    res = {"shape": label, "B": B, "K": K, "G": G, "dh": dh, "T": T,
           "NP": NP, "tokens": lengths, "partitions": P, "pool": "bfloat16",
           "ms": kernel_ms, "plain_ms": plain_ms, "library_ms": library_ms,
           "ms_min_max": [kernel_t[0], kernel_t[-1]],
           "plain_ms_min_max": [plain_t[0], plain_t[-1]],
           "library_ms_min_max": [library_t[0], library_t[-1]],
           "bound_ms": max(t_bytes, t_ops),
           "bound_by": "bytes" if t_bytes >= t_ops else "operations",
           "bytes": kv_bytes + io_bytes, "flops": flops}
    print(f"timing {label} (median [min, max]): kernel_ms={kernel_ms:.4f} "
          f"[{kernel_t[0]:.4f}, {kernel_t[-1]:.4f}] plain_ms={plain_ms:.4f} "
          f"[{plain_t[0]:.4f}, {plain_t[-1]:.4f}] library_ms={library_ms:.4f} "
          f"[{library_t[0]:.4f}, {library_t[-1]:.4f}] "
          f"bound_ms={res['bound_ms']:.4f} "
          f"({res['bound_by']}, {res['bytes']} bytes)")
    return res


def timing_phase(rate):
    import torch
    gen = torch.Generator(device="cuda").manual_seed(1)
    flush = torch.empty(64 * 2 ** 20, dtype=torch.float32, device="cuda")
    serving = timing_shape("serving", 4, 16, 1, 32, 16, 64, [512] * 4, 0,
                           rate, flush, gen)
    long = timing_shape("long", 1, 16, 1, 6400, 16, 64, [100_000], 0, rate,
                        flush, gen)
    check(long["partitions"] == 16, "long shape must take 16 partitions")
    return serving, long


# ---------------------------------------------------------------------------
# phases 4-5: server + teacher-forced reference
# ---------------------------------------------------------------------------

def server_phase():
    import numpy as np
    import torch
    from repro_torch.kernels.paged_attention import launches
    from repro_torch.models.registry import Model
    from repro_torch.serving.api import (KVNANDServer, SamplingParams,
                                         ServerConfig)
    t0 = time.perf_counter()
    srv = KVNANDServer(ServerConfig(
        arch="qwen1.5-0.5b", reduced=False, batch_slots=4, max_context=512,
        prefill_chunk_tokens=64, device="cuda"))
    cfg = srv.cfg
    check(cfg.n_layers == 24 and cfg.d_model == 1024 and cfg.n_heads == 16
          and cfg.padded_vocab == 152064, "not the full-width qwen1.5-0.5b")
    torch.cuda.synchronize()
    print(f"server: built {cfg.name} ({cfg.param_count() / 1e6:.1f}M params)"
          f" in {time.perf_counter() - t0:.2f} s")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, n).tolist()
               for n in (5, 37, 64, 100, 150, 200)]
    launches.reset()
    steps0 = srv.stats["decode_steps"]
    t0 = time.perf_counter()
    outs = srv.generate(prompts, SamplingParams(max_new_tokens=16,
                                                logprobs=True))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    n_launch = launches.value
    steps = srv.stats["decode_steps"] - steps0
    new_tokens = sum(len(o.token_ids) for o in outs)
    print(f"server: {len(outs)} requests, {new_tokens} tokens in {wall:.3f} s"
          f", {steps} decode steps, {srv.stats['prefill_chunks']} prefill "
          f"chunks, kernel launches {n_launch}")
    check(len(outs) == 6 and all(len(o.token_ids) == 16
                                 and o.finish_reason == "length"
                                 for o in outs), "not every request answered")
    check(steps > 0 and n_launch == steps * cfg.n_layers,
          f"launches {n_launch} != decode steps {steps} x {cfg.n_layers}")

    model = Model(cfg)
    lp_err = gap = 0.0
    with torch.no_grad():
        for o in outs:
            toks = torch.tensor(o.prompt + o.token_ids, device="cuda")[None]
            logits = model.forward(srv.params, {"tokens": toks})[0].float()
            n = len(o.prompt)
            rows = logits[n - 1:n - 1 + len(o.token_ids)]
            rows[:, cfg.vocab_size:] = -1e9
            tok = torch.tensor(o.token_ids, device="cuda")
            ref_lp = torch.log_softmax(rows, -1).gather(1, tok[:, None])[:, 0]
            served = torch.tensor(o.logprobs, device="cuda")
            check(bool(torch.isfinite(served).all()), "non-finite logprob")
            lp_err = max(lp_err, float((served - ref_lp).abs().max()))
            gap = max(gap, float((rows.max(-1).values
                                  - rows.gather(1, tok[:, None])[:, 0]).max()))
    print(f"check: max |served logprob - reference| = {lp_err:.3e} "
          f"(tol {LOGPROB_TOL:.0e}); max reference-logit gap of served "
          f"tokens = {gap:.3e} (tol {LOGIT_GAP_TOL:.0e})")
    check(lp_err <= LOGPROB_TOL, "served logprobs disagree with reference")
    check(gap <= LOGIT_GAP_TOL, "a served token is not the reference argmax")
    return {"launches": n_launch, "decode_steps": steps, "wall_s": wall,
            "tokens": new_tokens, "logprob_err": lp_err, "logit_gap": gap}


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch.kernels.paged_attention import kernel as pa_kernel
    card = smi_line()
    name = torch.cuda.get_device_name(0)
    print(card)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} on {name}")

    t0 = time.perf_counter()
    lib = pa_kernel.build()
    print(f"build: {lib.name} in {time.perf_counter() - t0:.2f} s")

    max_abs = kernel_phase()
    serving, long = timing_phase(hbm_rate(name))
    srv = server_phase()

    entry = {"name": "paged_attention", "route": "cuda",
             "source": "src/repro_torch/csrc/paged_attention.cu",
             "replaces": "src/repro/kernels/paged_attention/kernel.py:311",
             "launches": srv["launches"], "max_abs_err": max_abs,
             "ms": serving["ms"], "plain_ms": serving["plain_ms"],
             "bound_ms": serving["bound_ms"],
             "bound_by": serving["bound_by"],
             "library_ms": serving["library_ms"],
             "shapes": [serving, long], "server": srv}
    print(card)
    print(json.dumps({"kernels": [entry]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
