#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA card and check it.

    python3 chip_smoke.py                    # every phase
    python3 chip_smoke.py --paged            # the build and phases 2-3 only
    python3 chip_smoke.py --paged-timing     # the build and phase 3 only
    python3 chip_smoke.py --quant-servers    # the build and phase 8 only
    python3 chip_smoke.py --wkv              # the build and phase 11 only
    python3 chip_smoke.py --wkv-ab OLD.cu    # B5's walk-the-chunks body vs the current
    python3 chip_smoke.py --wkv-timing       # the build and B5's timing only
    python3 chip_smoke.py --gemv             # the build and phase 7 only
    python3 chip_smoke.py --gemv-ab OLD.cu   # B3's CUDA-core body vs the current
    python3 chip_smoke.py --flash            # the build and phase 9 only
    python3 chip_smoke.py --flash-timing     # the build and B4's timing only
    python3 chip_smoke.py --flash-ab OLD.cu  # B4's CUDA-core body vs the current
    python3 chip_smoke.py --dse              # the build and phases 13-15 only
    python3 chip_smoke.py --verify-ab        # V1's verify attention, the port's form vs the reference's
    python3 chip_smoke.py --window           # the build and phase 16 (G1, gemma3-12b) only

Phases (each one fails the run when it fails):

1. build    the five kernel libraries from src/repro_torch/csrc (B1 paged
            decode attention over per-slot stripes, B2 over the shared pool
            through page tables, B3 the quantized GEMV, B4 flash attention
            for the one-shot prefill, B5 the RWKV6 wkv recurrence), one nvcc
            process per source, started together, timed;
2. kernel   hold each kernel against its plain torch version on the card,
            {f32, bf16, kv8, kv4} pools x partitions {1, 16} x window
            {None, 64}.  B1: head shapes (K=16, G=1, dh=64) (qwen1.5-0.5b)
            and (K=8, G=4, dh=128) (llama3.1-8b), ragged lengths, a
            length-1 row, a row with unwritten pages, an all-masked row.
            B2: head shapes G in {1, 4, 8} x dh in {64, 128}, tables that
            permute a larger pool, a row whose entries past its length name
            pages other rows own, an all-masked row.  Then both layouts at
            every head dim they take (32, 64, 112, 128, 160, 256; K=4, G=4)
            x the four formats x the cluster size S forced to 1, 2, 4 and
            8 x window {None, 64}, 2 partitions, a one-token row (its
            tokens all in rank 0) beside the rows above;
3. timing   kernel, plain version and a library yardstick
            (scaled_dot_product_attention on K/V gathered beforehand; for
            B2 also gather + SDPA in one timed call) at the serving shape
            (B=4, 512 tokens, bf16) and a long shape (B=1, 100K tokens,
            bf16, 16 partitions), beside the HBM-byte bound; B2's tables
            permute the pool; the kernel also with S forced to each size,
            and the S the host chooses printed beside the times;
4. server   `KVNANDServer` at the full width of qwen1.5-0.5b (random
            weights from a seed), stripe pool: 6 greedy requests of 5-200
            prompt tokens x 16 new tokens; B1's launch counter must equal
            decode steps x 24 layers and B2's must stay 0;
5. shared   the same server on the shared pool (`shared_pool=True`): 6
            greedy requests, 3 of them sharing a 32-token system prefix and
            one an exact repeat, so the prefix cache hits and pages are
            copied on write; B2's counter must equal decode steps x 24 and
            B1's stay 0; the allocator's invariants hold after the drain.
            Served from a bf16 pool and, on the same prompts, from an f32
            pool;
6. check    every served token of the server phases against a
            kernel-free reference on the card: the port's plain full
            forward, teacher-forced on prompt + output (logprobs within
            LOGPROB_TOL; the token the reference argmax within
            LOGIT_GAP_TOL, except on the shared bf16 run, which reports
            its largest gap: see `shared_server_phase`);
7. B3       the quantized GEMV against its plain version on the card,
            {w4a16, w8a8} x M in {1, 4, 8, 16, 64, 70} and the crossover
            +-1 (`STREAM_MAX_M`, the largest M of the stream path) x (D, F)
            of qwen1.5-0.5b (1024->1024, 1024->2816, 2816->1024),
            llama3.1-8b (4096->14336, 14336->4096), rwkv6-3b (2560->2560,
            2560->8960, 8960->2560) and a ragged (130, 77): W8A8 within
            1e-6 x max|y|, W4A16 within 4e-3 x max|y| (the plain version
            rounds the product to bf16) and within 1e-5 x max|y| of the TPU
            kernel's function f32(bf16(x) @ w4) x scale; each case launched
            twice, with the same bits; timed (kernel, plain, library, a
            plain torch read of the packed weight, bound) at M = 4 and 64
            on qwen1.5-0.5b's gate projection and llama3.1-8b's down one,
            and both paths forced at M 8-32 (the crossover).  `--gemv-ab
            OLD.cu` times B3's earlier CUDA-core body (built from OLD.cu, e.g.
            `git show 3411943:src/repro_torch/csrc/quant_gemv.cu`) beside
            the current one at the 8 timed shapes, old, new, new, old, in
            one process;
8. Q1, Q2   the quantized deployments at the full width of qwen1.5-0.5b:
            Q1 W4A16 weights, stripe pool, kv4 pages (the design-space
            search's fallback); Q2 W8A8 weights, shared pool, kv8 pages
            (prefix hits, copy-on-write of codes and scales).  B3's
            counter must equal 4 x 24 per decode step and prefill chunk
            (wo, gate, up, down; wq/wk/wv are dequantized, the LM head is
            the float embedding), B1's (Q1) or B2's (Q2) 24 per decode
            step, the other 0.  Each is held against the same server run
            on the CPU (plain versions, the same quantized params, the
            same prompts): each prompt's last-token prefill logits within
            QUANT_PREFILL_TOL (relative Euclidean distance), and served
            logprobs within QUANT_LOGPROB_TOL up to and including each
            request's first differing token;
9. B4       flash attention against its plain version on the card,
            {f32, bf16} x heads (H, K, dh) (16, 16, 64) (qwen1.5-0.5b),
            (32, 8, 128) (llama3.1-8b), (8, 1, 64), (4, 2, 32) (every
            reduced config's head dim) and (4, 2, 112), (4, 2, 160),
            (8, 4, 256) (padded inside the kernel; every instance runs) x
            causal {True, False} x window {None, 16, 64} (16 is shorter
            than a key tile) x ragged Sq = Sk in {1, 70, 255, 511} and
            Sq = 70 < Sk = 255 (at q_offset 0 and 185) x B {1, 3}, each
            under the host's plan and with the cluster size S forced to 1,
            2, 4 and 8, each launched twice for the same bits, within
            FLASH_TOL (the reference's own tolerances); bf16 also within
            one bf16 rounding of the plain version on the inputs upcast to
            f32; timed (kernel, plain, SDPA in the same dtype, bound and
            the CUDA-core bound beside it) at the serving shape (B=1, 256
            tokens, H=K=16, dh=64, f32, causal: a bucketed admit of
            qwen1.5-0.5b), the 64-token bucket, and a long shape (B=1,
            8192 tokens, H=32, K=8, dh=128, causal) in f32 and bf16, with
            every S forced at the two short ones.  `--flash-ab OLD.cu`
            times B4's earlier CUDA-core body (e.g. `git show
            fbf4a59:src/repro_torch/csrc/flash_attention.cu`) beside the
            current one at the four timed shapes, old, new, new, old, in
            one process;
10. S1      the splice scheduler (`scheduler="splice"`) at the full width
            of qwen1.5-0.5b, stripe f32 pool: the stripe prompts plus one of
            500 tokens (its bucket clamps to 511); B4's counter must equal
            admits x 24, B1's decode steps x 24, B2's and B3's 0; served
            tokens pass the teacher-forced check with the argmax, and the
            interleaved scheduler serves the same greedy tokens;
11. B5      the RWKV6 wkv kernel against its plain versions on the card,
            B {1, 3} x S {1, 2, 31, 32, 33, 64, 65, 77, 256, 257, 511}
            (one chunk, a chunk exactly, n chunks, n chunks + 1) x H {1,
            40} x dh {16, 32, 64} x zero and random s0, decays drawn as
            the reference's tests draw them; chunks 1, 7 and 16 at S = 70;
            one long case (S = 8192, H = 40, dh = 64): out and the final
            state, each, within WKV_TOL["chunked"] of the plain chunked
            form and WKV_TOL["recurrent"] of the plain recurrence and of
            the plain version of B5's own split (`wkv_chunk_parallel`); at
            constant logw -3.0 and -4.0 (where the plain chunked form
            overflows) within WKV_TOL["recurrent"] of the recurrence; every
            case launched twice, with the same bits; constant logw -0.05
            (the state carries over many chunks) the same way; bf16 r/k/v/logw through
            `wkv6` (upcast for B5) against the plain chunked form on the
            same inputs, within one bf16 ulp; timed (kernel, plain
            chunked form, bound; the 3xTF32 bound and the bytes of B5's
            intermediates printed and in `--wkv`'s JSON only;
            no PyTorch call computes wkv6) at the serving shape (B=1, 256
            tokens, H=40, dh=64: one rwkv6-3b admit), a long shape (B=1,
            8192 tokens), one chunk (32 tokens) and R1's 500-token prompt.
            `--wkv-ab OLD.cu` times B5's earlier body (e.g. `git show
            ecc8d28:src/repro_torch/csrc/wkv6.cu`) beside the current one
            at the four timed shapes, old, new, new, old, in one process;
12. R1      `KVNANDServer` at the full width of rwkv6-3b (32 layers,
            d_model 2560, 40 heads x 64, random f32 weights from seed 0),
            interleaved scheduler, 4 slots: the stripe prompts, one of 500
            tokens and one of a single token (its admit runs the
            recurrence), 16 greedy tokens each; B5's counter must equal 32
            x the admits with >= 2 prompt tokens and B1-B4's stay 0; served
            tokens pass the teacher-forced check with the argmax; the splice
            scheduler serves the same tokens with the same B5 count;
13. heads   B1 and B2 walking one head group at a time, as the discrete
            variant (KVNAND-D) launches them: B1 over a head range of the
            whole stripe pool (`head0`, no copy), B2 over the group's
            contiguous slice of the shared pool; {f32, bf16, kv8, kv4} x
            window {None, 64} x (K, G, dh) (32, 1, 128) (llama2-7b) and
            (8, 4, 128) (llama3.1-8b) x two row sets: phase 2's rows at
            partitions {1, 16}, and D1's launch shape (4 slots x 8 pages,
            ragged) at partitions {1, 2}, where a group's launch takes a
            cluster split of 4 (2): every group against its plain version
            (TOL), the groups side by side against one all-heads launch
            (HEAD_RANGE_TOL); at D1's launch shape (one of 32 kv heads,
            dh 128, kv8, B=4 x 128 tokens) the timed group held against
            its plain version and the all-heads launch, then timed beside
            the latter;
14. D1      full-width llama2-7b (32 layers, d_model 4096, 32 heads x 128,
            d_ff 11008; random f32 weights from seed 0) under the
            design-space search's pick at max_context 128 (asserted:
            discrete, kv8) with `launch/serve.py --use-dse`'s overrides, 4
            slots, 6 greedy requests of 5-60 prompt tokens (one repeats a
            segment) x 16 new tokens: stripe pool, B1 launches = decode
            steps x 32 x 32; the compact variant on the same params and
            prompts serves the same tokens (or differs only at a near-tie,
            see `dse_server_phase`); the shared pool, B2 launches = decode
            steps x 32 x 32, the allocator's invariants after the drain;
15. V1      D1's stripe deployment with speculation_k = 4 (prompt-lookup
            draft-and-verify): the same tokens as D1's sequential run, at
            least one verify step, and the acceptance counts printed;
16. G1      full-width gemma3-12b (48 layers: 40 local over a 1024-token
            window in ring-recycled pages, 8 global; d_model 3840, 16
            heads (8 kv) x 256, d_ff 15360, vocab 262144; 47 GB of random
            f32 weights from seed 0, drawn after D1's are freed), 4 slots,
            max_context 2048, 64-token chunks, 6 greedy prompts of 5, 17,
            40, 60, 1030 and 1100 tokens x 24 new tokens (the 1100-token
            prompt wraps the 65-page ring in prefill, the 1030-token one
            in decode).  Kernels: B1 and B2 over the decode step's ring
            (bases rotated and empty slots at -1e9, window 1024) and
            global pool, kv8 and f32, and B4 over the splice admit's
            2047-token bucket (window 1024 and none), at G1's head shape,
            against their plain versions.  Golden: the 1100-token prompt chunk by chunk into
            an f32 stripe pool, then 8 decode steps, every step's logits
            within GOLDEN_TOL of the plain full forward's and the same
            argmax.  Then the design-space search's pick (asserted:
            compact, kv8) on the stripe pool (B1 = decode steps x 48),
            the shared pool (B2 = decode steps x 48, both allocators clean
            after the drain) and the splice scheduler (B4 = admits x 48,
            local layers at window 1024), the final lengths printed; the
            stripe run's logprobs against the plain forward within
            QUANT_LOGPROB_TOL; KVNAND-D on the ring (B1 = steps x 48 x 8)
            and speculation_k = 4 (the stripe run's tokens exactly).  The
            three pools and schedulers, and the two variants, serve equal
            tokens or part only at a near tie (KV8_GAP_TOL;
            LOGIT_GAP_TOL for the variants, as D1).  Peak memory and each
            run's wall printed beside the card.  `--window` runs the build
            and this phase only.

It needs a CUDA card (exits non-zero without one, printing no result),
imports nothing of JAX, and prints the card's name and power limit, a
{"kernels": [...]} line and, last, {"ok": true, "device": {...}}.
"""
from __future__ import annotations

import functools
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
# plain version rounds q and p to bf16, the kernels keep them in f32) and,
# besides, to the f32 one against the plain version on the pools upcast to
# f32, which is the kernels' own arithmetic
TOL = {"f32": 2e-5, "bf16": 3e-2, "kv8": 2e-5, "kv4": 2e-5}
# served logprob vs the f32 teacher-forced reference: the served K/V pass
# through the bf16 pool, the reference's do not
LOGPROB_TOL = 2e-2
LOGIT_GAP_TOL = 1e-3
# engine logits against the plain full forward at an f32 pool, relative to
# max |logits|: the reference's own (tests/test_engine_golden.py)
GOLDEN_TOL = 2e-4
# the quantized deployments Q1/Q2 against the same server on the CPU.
# Every quantizer (W4A16's bf16 input, W8A8's int8 activations, kv8/kv4
# codes) is a rounding step, so two correct runs agree to the model's
# quantization noise, not to float rounding.  Measured on an H100 (PERF.md,
# with three deliberately broken copies of B3): ||card - CPU|| / ||CPU||
# of the last-token prefill logits is at most 4.1e-2 over the 6 prompts of
# either phase for the sound kernel and at least 2.2e-1 for each broken
# one (4 rows of D dropped), so QUANT_PREFILL_TOL separates them.  Served
# logprobs up to each first differing token reach 1.2e-1 for the sound
# kernel and as little as 2.4e-1 for a broken one: QUANT_LOGPROB_TOL only
# bounds them, it cannot tell the two apart.
QUANT_PREFILL_TOL = 0.1
QUANT_LOGPROB_TOL = 0.3

# HBM bandwidth by SKU (NVIDIA data sheets); float32 CUDA-core peak
HBM_BYTES_PER_S = {"H100 PCIe": 2.0e12, "H100 NVL": 3.9e12, "H200": 4.8e12,
                   "H100": 3.35e12}
F32_FLOPS = 67e12
# dense tensor-core peaks (NVIDIA H100 SXM data sheet): the bound of B3's
# multiply-adds, bf16 for W4A16 (its product runs on bf16 inputs), int8
# for W8A8
TC_OPS = {"w4a16": 989e12, "w8a8": 1979e12}
# B3 against its plain version, in units of max|y| (see phase 7)
GEMV_TOL = {"w8a8": 1e-6, "w4a16": 4e-3}
GEMV_TPU_TOL = 1e-5
# B4 against its plain version: the reference's own flash-attention
# tolerances (tests/test_kernels_flash_attention.py), atol = rtol.  A bf16
# output is also held against the plain version on the inputs upcast to
# f32 within one bf16 rounding (2^-8 relative) plus the f32 tolerance: the
# kernel computes in f32 and rounds only its output to bf16
FLASH_TOL = {"f32": 2e-5, "bf16": 2e-2}
BF16_ROUNDING = 2.0 ** -8
# B5 against its plain versions, |a - b| / (1 + |b|).  The plain chunked form
# is the reference's factorization, whose e^{±65} factors amplify its own
# rounding: on this phase's cases it departs from the recurrence by up to
# 2.6e-4 (CPU, float32), so B5 is held to it at the reference's own 5e-4
# between forms.  B5 pivots each chunk at its middle, which keeps its
# factors small: a float32 emulation of its arithmetic stays within 4.6e-5
# of the recurrence on these cases, so the recurrence holds it at 1e-4
WKV_TOL = {"chunked": 5e-4, "recurrent": 1e-4}
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

def quantized(kd, vd, fmt):
    """(k, v, k_scale, v_scale) in the pool format `fmt`; kv8/kv4 pools are
    the port's own quantized pages (codes + per-page scales)."""
    import torch
    from repro_torch.core.quant import quantize_kv_page
    if fmt in ("kv8", "kv4"):
        kp, ks = quantize_kv_page(kd, fmt)
        vp, vs = quantize_kv_page(vd, fmt)
        return kp, vp, ks, vs
    dt = torch.float32 if fmt == "f32" else torch.bfloat16
    return kd.to(dt), vd.to(dt), None, None


def make_inputs(B, K, G, NP, T, dh, fmt, lengths, gen, unwritten_row=None):
    """Random q and stripe pools [B, K, NP, T, dh] on the card."""
    import torch
    dev = "cuda"
    q = torch.randn(B, K * G, dh, generator=gen, device=dev)
    kd = torch.randn(B, K, NP, T, dh, generator=gen, device=dev)
    vd = torch.randn(B, K, NP, T, dh, generator=gen, device=dev)
    base = (torch.arange(NP, device=dev, dtype=torch.int32) * T)[None]
    base = base.repeat(B, 1)
    if unwritten_row is not None:
        base[unwritten_row, NP // 2:] = -1
    length = torch.tensor(lengths, dtype=torch.int32, device=dev)
    kp, vp, ks, vs = quantized(kd, vd, fmt)
    return q, kp, vp, base, length, ks, vs


def make_shared_inputs(B, K, G, NP, T, dh, fmt, lengths, gen, P_total,
                       alias_row=None):
    """Random q and a shared pool [K, P_total, T, dh] on the card, with
    tables that permute the pool (logical page j of row b on a random
    physical page).  `alias_row`'s entries past its first page are
    replaced by pages row 0 owns: stale entries a kernel must never read
    as data."""
    import torch
    dev = "cuda"
    q = torch.randn(B, K * G, dh, generator=gen, device=dev)
    kd = torch.randn(K, P_total, T, dh, generator=gen, device=dev)
    vd = torch.randn(K, P_total, T, dh, generator=gen, device=dev)
    perm = torch.randperm(P_total, generator=gen, device=dev)[:B * NP]
    table = perm.reshape(B, NP).to(torch.int32).contiguous()
    if alias_row is not None:
        table[alias_row, 1:] = table[0, 1:]
    base = (torch.arange(NP, device=dev, dtype=torch.int32) * T)[None]
    base = base.repeat(B, 1).contiguous()
    length = torch.tensor(lengths, dtype=torch.int32, device=dev)
    kp, vp, ks, vs = quantized(kd, vd, fmt)
    return q, kp, vp, table, base, length, ks, vs


def kv_quant_of(fmt: str) -> str:
    return fmt if fmt in ("kv8", "kv4") else "none"


def close_err(a, b, tol: float) -> float:
    """max |a - b| / (1 + |b|): <= tol means within atol = rtol = tol."""
    return float(((a.float() - b.float()).abs() / (1 + b.float().abs()))
                 .max())


# ---------------------------------------------------------------------------
# phase 2: kernels vs plain
# ---------------------------------------------------------------------------

def hold_case(label, got, want, fmt, want32=None, empty_row=None) -> float:
    """Check one kernel call against its plain version; returns
    max |o - plain o|."""
    import torch
    o, m, l = got
    err = max(close_err(a, b, TOL[fmt]) for a, b in zip(got, want))
    if want32 is not None:
        err32 = max(close_err(a, b, TOL["f32"]) for a, b in zip(got, want32))
        print(f"{label}: vs plain on f32-upcast pools rel_err={err32:.3e} "
              f"tol={TOL['f32']:.0e}")
        check(err32 <= TOL["f32"], f"{label}: bf16 kernel disagrees with "
              f"its own arithmetic: {err32:.3e}")
    abs_o = float((o - want[0]).abs().max())
    finite = bool(torch.isfinite(o).all() and torch.isfinite(m).all()
                  and torch.isfinite(l).all())
    print(f"{label}: max_abs_err(o)={abs_o:.3e} rel_err={err:.3e} "
          f"tol={TOL[fmt]:.0e}")
    check(finite, f"{label}: kernel output not finite")
    if empty_row is not None:
        check(bool((o[empty_row] == 0).all() and (l[empty_row] == 0).all()
                   and (m[empty_row] == -1e30).all()),
              f"{label}: all-masked row is not o=0, m=-1e30, l=0")
    check(err <= TOL[fmt], f"{label}: kernel disagrees with plain version: "
          f"{err:.3e} > {TOL[fmt]:.0e}")
    return abs_o


def kernel_phase() -> float:
    """B1 against `paged_attention_partial_ref`."""
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
                    got = paged_attention_partial(
                        q, kp, vp, base, length, window=window,
                        kv_quant=kvq, k_scale=ks, v_scale=vs, partitions=P)
                    torch.cuda.synchronize()
                    want = paged_attention_partial_ref(
                        q, kp, vp, base, length, window=window,
                        kv_quant=kvq, k_scale=ks, v_scale=vs)
                    want32 = None
                    if fmt == "bf16":
                        want32 = paged_attention_partial_ref(
                            q, kp.float(), vp.float(), base, length,
                            window=window)
                    max_abs = max(max_abs, hold_case(
                        f"B1 K={K} G={G} dh={dh} {fmt:4s} P={P:2d} "
                        f"window={window}", got, want, fmt, want32,
                        empty_row=4))
                    n += 1
    print(f"B1 kernel phase: {n} cases within tolerance, "
          f"max_abs_err(o)={max_abs:.3e}")
    return max_abs


def shared_kernel_phase() -> float:
    """B2 against `paged_attention_shared_ref` (the slot's pages gathered
    through its table, then the stripe oracle)."""
    import torch
    from repro_torch.kernels.paged_attention import (
        paged_attention_partial, paged_attention_shared_ref)
    gen = torch.Generator(device="cuda").manual_seed(2)
    B, NP, T = 5, 32, 16
    P_total = B * NP + 40
    lengths = [512, 300, 1, 400, 0]    # row 2's entries past page 0 are
    max_abs = 0.0                      # row 0's pages; row 4 attends nothing
    n = 0
    for G in (1, 4, 8):
        K = 16 if G == 1 else 8
        for dh in (64, 128):
            for fmt in ("f32", "bf16", "kv8", "kv4"):
                for P in (1, 16):
                    for window in (None, 64):
                        q, kp, vp, table, base, length, ks, vs = \
                            make_shared_inputs(B, K, G, NP, T, dh, fmt,
                                               lengths, gen, P_total,
                                               alias_row=2)
                        kvq = kv_quant_of(fmt)
                        got = paged_attention_partial(
                            q, kp, vp, base, length, window=window,
                            kv_quant=kvq, k_scale=ks, v_scale=vs,
                            page_table=table, partitions=P)
                        torch.cuda.synchronize()
                        want = paged_attention_shared_ref(
                            q, kp, vp, table, base, length, window=window,
                            kv_quant=kvq, k_scale=ks, v_scale=vs)
                        want32 = None
                        if fmt == "bf16":
                            want32 = paged_attention_shared_ref(
                                q, kp.float(), vp.float(), table, base,
                                length, window=window)
                        max_abs = max(max_abs, hold_case(
                            f"B2 K={K} G={G} dh={dh:3d} {fmt:4s} P={P:2d} "
                            f"window={window}", got, want, fmt, want32,
                            empty_row=4))
                        n += 1
    print(f"B2 kernel phase: {n} cases within tolerance, "
          f"max_abs_err(o)={max_abs:.3e}")
    return max_abs


def split_phase() -> dict:
    """B1 and B2 at every head dim they take, with the cluster size S
    forced to each of 1, 2, 4, 8: the kernel's partials (2 caller
    partitions, each walked by S CTAs that merge through distributed
    shared memory) merged as the engine merges them, against the plain
    version.  Row 2 holds one token, so every rank but its first sees
    nothing; row 3 has unwritten pages; row 4 attends nothing.  Returns
    max |o - plain o| per kernel."""
    import itertools
    import torch
    from repro_torch.kernels.paged_attention import (
        HEAD_DIMS, SPLITS, merge_partials, paged_attention_cuda,
        paged_attention_partial_ref, paged_attention_shared_cuda,
        paged_attention_shared_ref)
    gen = torch.Generator(device="cuda").manual_seed(9)
    B, K, G, NP, T = 5, 4, 4, 32, 16
    lengths = [512, 300, 1, 400, 0]
    max_abs, n = {"B1": 0.0, "B2": 0.0}, 0
    for layout, dh, fmt, S, window in itertools.product(
            ("stripe", "shared"), HEAD_DIMS, ("f32", "bf16", "kv8", "kv4"),
            SPLITS, (None, 64)):
        kvq = kv_quant_of(fmt)
        kw = dict(window=window, kv_quant=kvq, partitions=2, split=S)
        if layout == "stripe":
            q, kp, vp, base, length, ks, vs = make_inputs(
                B, K, G, NP, T, dh, fmt, lengths, gen, unwritten_row=3)
            ref = lambda kp_, vp_, **k_: paged_attention_partial_ref(  # noqa
                q, kp_, vp_, base, length, window=window, **k_)
            part = paged_attention_cuda(
                q.reshape(B, K, G, dh).contiguous(), kp, vp, base, length,
                k_scale=ks, v_scale=vs, **kw)
        else:
            q, kp, vp, table, base, length, ks, vs = make_shared_inputs(
                B, K, G, NP, T, dh, fmt, lengths, gen, B * NP + 40,
                alias_row=2)
            ref = lambda kp_, vp_, **k_: paged_attention_shared_ref(  # noqa
                q, kp_, vp_, table, base, length, window=window, **k_)
            part = paged_attention_shared_cuda(
                q.reshape(B, K, G, dh).contiguous(), kp, vp, table, base,
                length, k_scale=ks, v_scale=vs, **kw)
        torch.cuda.synchronize()
        o, m, l = merge_partials(*part, axis=2)
        got = (o.reshape(B, K * G, dh), m.reshape(B, K * G),
               l.reshape(B, K * G))
        want = ref(kp, vp, kv_quant=kvq, k_scale=ks, v_scale=vs)
        want32 = ref(kp.float(), vp.float()) if fmt == "bf16" else None
        check(bool((part[1][2, :, 1] == -1e30).all()
                   and (part[2][2, :, 1] == 0).all()),
              f"split S={S}: the one-token row's second partition is not "
              "empty")
        name = "B1" if layout == "stripe" else "B2"
        max_abs[name] = max(max_abs[name], hold_case(
            f"{name} split S={S} dh={dh:3d} {fmt:4s} window={window}", got,
            want, fmt, want32, empty_row=4))
        n += 1
    print(f"B1/B2 split phase: {n} cases within tolerance, "
          f"max_abs_err(o) B1 {max_abs['B1']:.3e}, B2 {max_abs['B2']:.3e}")
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


def summarize(label, times: dict, *, B, K, G, NP, T, dh, lengths, P, rate,
              table_bytes=0, split=None) -> dict:
    """Medians with [min, max], and the least time the card could take:
    each valid token's K and V read once (bf16), q read, the partials
    written, base/length (and the table) read; QK + PV multiply-adds in
    f32.  `split`: the cluster size the host chose for `ms`."""
    valid = sum(lengths)
    kv_bytes = valid * K * dh * 2 * 2
    io_bytes = (B * K * G * dh * 4 + B * K * P * G * (dh + 2) * 4
                + B * NP * 4 + B * 4 + table_bytes)
    flops = 4 * valid * K * G * dh
    t_bytes = (kv_bytes + io_bytes) / rate * 1e3
    t_ops = flops / F32_FLOPS * 1e3
    res = {"shape": label, "B": B, "K": K, "G": G, "dh": dh, "T": T,
           "NP": NP, "tokens": lengths, "partitions": P, "split": split,
           "pool": "bfloat16",
           "bound_ms": max(t_bytes, t_ops),
           "bound_by": "bytes" if t_bytes >= t_ops else "operations",
           "bytes": kv_bytes + io_bytes, "flops": flops}
    for key, t in times.items():
        res[key] = statistics.median(t)
        res[f"{key}_min_max"] = [t[0], t[-1]]
    print(f"timing {label} (median [min, max]; chosen split S={split}): "
          + " ".join(f"{k}={res[k]:.6f} [{t[0]:.6f}, {t[-1]:.6f}]"
                     for k, t in times.items())
          + f" bound_ms={res['bound_ms']:.6f} ({res['bound_by']}, "
          f"{res['bytes']} bytes)")
    return res


def sdpa_operands(q, k_stripe, v_stripe, B, K, G, NP, T, dh, L):
    """q [B, H, 1, dh] bf16 and contiguous K/V [B, H, L, dh] for one SDPA
    call (GQA groups repeated)."""
    import torch
    kc = k_stripe.reshape(B, K, NP * T, dh)[:, :, :L]
    vc = v_stripe.reshape(B, K, NP * T, dh)[:, :, :L]
    if G > 1:
        kc = kc.repeat_interleave(G, dim=1)
        vc = vc.repeat_interleave(G, dim=1)
    return q.to(torch.bfloat16)[:, :, None], kc.contiguous(), vc.contiguous()


def split_times(kernel, B, K, NP, T, P, flush) -> tuple:
    """The cluster size the host chooses for this launch, and the kernel's
    times with each size forced ({} for a kernel without a split: an older
    body timed beside this one)."""
    import torch
    from repro_torch.kernels import paged_attention as tpa
    if not hasattr(tpa, "choose_split"):
        return None, {}
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    chosen = tpa.choose_split(B * K * P, NP // P * T, sms)
    return chosen, {f"ms_split{S}": time_ms(
        functools.partial(kernel, split=S), 20, flush) for S in tpa.SPLITS}


def timing_shape(label, B, K, G, NP, T, dh, lengths, partitions, rate,
                 flush, gen):
    """B1 at one shape."""
    import torch.nn.functional as F
    from repro_torch.kernels.paged_attention import (
        paged_attention_cuda, paged_attention_partial_ref,
        resolve_partitions)
    q, kp, vp, base, length, _, _ = make_inputs(B, K, G, NP, T, dh, "bf16",
                                                lengths, gen)
    P = resolve_partitions(partitions, NP)
    q4 = q.reshape(B, K, G, dh).contiguous()
    L = lengths[0]
    check(all(x == L for x in lengths), "timing rows must share a length")
    qc, kc, vc = sdpa_operands(q, kp, vp, B, K, G, NP, T, dh, L)

    def kernel(**kw):
        return paged_attention_cuda(q4, kp, vp, base, length, partitions=P,
                                    **kw)

    chosen, forced = split_times(kernel, B, K, NP, T, P, flush)
    times = {
        "ms": time_ms(kernel, 20, flush),
        **forced,
        "plain_ms": time_ms(lambda: paged_attention_partial_ref(
            q, kp, vp, base, length), 5, flush),
        "library_ms": time_ms(
            lambda: F.scaled_dot_product_attention(qc, kc, vc), 20, flush),
    }
    return summarize(f"B1 {label}", times, B=B, K=K, G=G, NP=NP, T=T, dh=dh,
                     lengths=lengths, P=P, rate=rate, split=chosen)


def shared_timing_shape(label, B, K, G, NP, T, dh, lengths, P_total,
                        partitions, rate, flush, gen):
    """B2 at one shape: the tables permute a pool of P_total pages."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.paged_attention import (
        gather_table_pages, paged_attention_shared_cuda,
        paged_attention_shared_ref, resolve_partitions)
    q, kp, vp, table, base, length, _, _ = make_shared_inputs(
        B, K, G, NP, T, dh, "bf16", lengths, gen, P_total)
    P = resolve_partitions(partitions, NP)
    q4 = q.reshape(B, K, G, dh).contiguous()
    L = lengths[0]
    check(all(x == L for x in lengths), "timing rows must share a length")

    def gathered():
        return sdpa_operands(q, gather_table_pages(kp, table),
                             gather_table_pages(vp, table), B, K, G, NP, T,
                             dh, L)

    qc, kc, vc = gathered()
    # the same pages in table order (slot b's logical page j on physical
    # page b·NP + j of the pool): what the page indirection itself costs
    ident = torch.arange(B * NP, dtype=torch.int32,
                         device="cuda").reshape(B, NP) % P_total

    def kernel(**kw):
        return paged_attention_shared_cuda(q4, kp, vp, table, base, length,
                                           partitions=P, **kw)

    chosen, forced = split_times(kernel, B, K, NP, T, P, flush)
    times = {
        "ms": time_ms(kernel, 20, flush),
        **forced,
        "ms_table_in_order": time_ms(lambda: paged_attention_shared_cuda(
            q4, kp, vp, ident, base, length, partitions=P), 20, flush),
        "plain_ms": time_ms(lambda: paged_attention_shared_ref(
            q, kp, vp, table, base, length), 5, flush),
        "library_ms": time_ms(
            lambda: F.scaled_dot_product_attention(qc, kc, vc), 20, flush),
        "library_gather_ms": time_ms(
            lambda: F.scaled_dot_product_attention(*gathered()), 10, flush),
    }
    res = summarize(f"B2 {label}", times, B=B, K=K, G=G, NP=NP, T=T, dh=dh,
                    lengths=lengths, P=P, rate=rate, table_bytes=B * NP * 4,
                    split=chosen)
    res["P_total"] = P_total
    return res


def timing_phase(rate):
    import torch
    gen = torch.Generator(device="cuda").manual_seed(1)
    flush = torch.empty(64 * 2 ** 20, dtype=torch.float32, device="cuda")
    b1 = (timing_shape("serving", 4, 16, 1, 32, 16, 64, [512] * 4, 0, rate,
                       flush, gen),
          timing_shape("long", 1, 16, 1, 6400, 16, 64, [100_000], 0, rate,
                       flush, gen))
    # serving: 4 x 32 logical pages permuted over a 128-page pool; long:
    # 100 000 tokens = 6250 logical pages of a 6400-entry table (16
    # partitions, as B1), permuted over a 6400-page pool
    b2 = (shared_timing_shape("serving", 4, 16, 1, 32, 16, 64, [512] * 4,
                              128, 0, rate, flush, gen),
          shared_timing_shape("long", 1, 16, 1, 6400, 16, 64, [100_000],
                              6400, 0, rate, flush, gen))
    check(b1[1]["partitions"] == 16 and b2[1]["partitions"] == 16,
          "long shapes must take 16 partitions")
    return b1, b2


# ---------------------------------------------------------------------------
# phases 4-6: servers + teacher-forced reference
# ---------------------------------------------------------------------------

def build_server(params=None, device="cuda", scheduler="interleaved",
                 **engine):
    """The full-width qwen1.5-0.5b server on `device`: random weights from
    seed 0, or `params` (e.g. a quantized tree)."""
    import torch
    from repro_torch.configs import EngineConfig
    from repro_torch.serving.api import KVNANDServer, ServerConfig
    t0 = time.perf_counter()
    eng = EngineConfig(page_tokens=16, uniform_lengths=False, **engine)
    srv = KVNANDServer(ServerConfig(
        arch="qwen1.5-0.5b", reduced=False, engine=eng, batch_slots=4,
        max_context=512, prefill_chunk_tokens=64, device=device,
        scheduler=scheduler),
        params=params)
    cfg = srv.cfg
    check(cfg.n_layers == 24 and cfg.d_model == 1024 and cfg.n_heads == 16
          and cfg.padded_vocab == 152064, "not the full-width qwen1.5-0.5b")
    pool = {"kv8": torch.int8, "kv4": torch.uint8}.get(
        eng.kv_quant, getattr(torch, eng.kv_dtype))
    check(srv._batcher.cache.k_pages_g.dtype == pool,
          f"the KV pool is not {pool}")
    if device == "cuda":
        torch.cuda.synchronize()
    print(f"server: built {cfg.name} ({cfg.param_count() / 1e6:.1f}M params,"
          f" {eng}, {scheduler} scheduler) on {device} in "
          f"{time.perf_counter() - t0:.2f} s")
    return srv


def serve(label, srv, prompts, max_new=16):
    """Drive the server's main path with every launch counter reset just
    before and read just after; returns the outputs and the counts.  A
    request answers `max_new` tokens ("length"), or fewer where its prompt
    fills the slot first ("capacity")."""
    import torch
    from repro_torch.kernels import flash_attention, quant_gemv, wkv6
    from repro_torch.kernels.paged_attention import launches, launches_shared
    from repro_torch.serving.api import SamplingParams
    steps0 = srv.stats["decode_steps"]
    chunks0 = srv.stats["prefill_chunks"]
    admits0 = srv.stats["admits"]
    counters = {"B1": launches, "B2": launches_shared,
                "B3": quant_gemv.launches, "B4": flash_attention.launches,
                "B5": wkv6.launches}
    for c in counters.values():
        c.reset()
    t0 = time.perf_counter()
    outs = srv.generate(prompts, SamplingParams(max_new_tokens=max_new,
                                                logprobs=True))
    if srv._batcher.device.type == "cuda":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = {k: c.value for k, c in counters.items()}
    steps = srv.stats["decode_steps"] - steps0
    counts["prefill_chunks"] = srv.stats["prefill_chunks"] - chunks0
    counts["admits"] = srv.stats["admits"] - admits0
    new_tokens = sum(len(o.token_ids) for o in outs)
    print(f"{label}: {len(outs)} requests, {new_tokens} tokens in "
          f"{wall:.3f} s, {steps} decode steps, "
          f"{counts['prefill_chunks']} prefill chunks, launches {counts}")
    ctx = srv._batcher.max_context

    def answered(o):
        want = min(max_new, ctx - len(o.prompt))
        return len(o.token_ids) == want and o.finish_reason == (
            "length" if want == max_new else "capacity")

    check(len(outs) == len(prompts) and all(answered(o) for o in outs),
          f"{label}: not every request answered")
    return outs, counts, steps, wall, new_tokens


def teacher_forced_check(label, srv, outs, *, argmax=True,
                         tol=LOGPROB_TOL):
    """Every served token against the port's plain full forward on the
    card (kernel-free), teacher-forced on prompt + output, served
    logprobs within `tol`.  argmax=False reports the largest
    reference-logit gap instead of failing on it."""
    import torch
    from repro_torch.models.registry import Model
    cfg = srv.cfg
    model = Model(cfg)
    lp_err = gap = 0.0
    worst = None
    with torch.no_grad():
        for r, o in enumerate(outs):
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
            gaps = rows.max(-1).values - rows.gather(1, tok[:, None])[:, 0]
            j = int(gaps.argmax())
            if float(gaps[j]) > gap:
                gap = float(gaps[j])
                top2 = rows[j].topk(2).values
                worst = (r, j, float(top2[0] - top2[1]),
                         float((served[j] - ref_lp[j]).abs()))
    print(f"check {label}: max |served logprob - reference| = {lp_err:.3e} "
          f"(tol {tol:.0e}); max reference-logit gap of served "
          f"tokens = {gap:.3e} (tol {LOGIT_GAP_TOL:.0e})")
    if worst is not None:
        print(f"check {label}: largest gap at request {worst[0]} token "
              f"{worst[1]}: reference top-2 margin {worst[2]:.3e}, "
              f"|served logprob - reference| there {worst[3]:.3e}")
    check(lp_err <= tol,
          f"{label}: served logprobs disagree with reference")
    check(gap <= LOGIT_GAP_TOL or not argmax,
          f"{label}: a served token is not the reference argmax")
    return lp_err, gap


def stripe_prompts(V):
    """6 prompts of 5-200 tokens."""
    import numpy as np
    rng = np.random.default_rng(0)
    return [rng.integers(0, V, n).tolist()
            for n in (5, 37, 64, 100, 150, 200)]


def shared_prompts(V):
    """6 prompts: 3 share a 32-token system prefix (2 pages of 16), one
    repeats the first exactly; the last two are admitted once slots free
    up, after the first registered its pages."""
    import numpy as np
    rng = np.random.default_rng(1)
    system = rng.integers(0, V, 32).tolist()
    a = system + rng.integers(0, V, 37).tolist()
    prompts = [a] + [rng.integers(0, V, n).tolist() for n in (100, 150, 64)]
    return prompts + [system + rng.integers(0, V, 50).tolist(), list(a)]


def server_phase():
    """The stripe pool: every decode step goes through B1."""
    srv = build_server()
    prompts = stripe_prompts(srv.cfg.vocab_size)
    outs, counts, steps, wall, tokens = serve("server (stripe)", srv, prompts)
    L = srv.cfg.n_layers
    check(steps > 0 and counts["B1"] == steps * L and counts["B2"] == 0
          and counts["B3"] == 0 and counts["B4"] == 0 and counts["B5"] == 0,
          f"stripe launches {counts} != (decode steps {steps} x {L}, 0, 0, "
          "0)")
    lp_err, gap = teacher_forced_check("stripe", srv, outs)
    return {"launches": counts["B1"], "launches_B2": counts["B2"],
            "decode_steps": steps, "wall_s": wall, "tokens": tokens,
            "logprob_err": lp_err, "logit_gap": gap}


def shared_server_phase(kv_dtype: str):
    """The shared pool: every decode step goes through B2, the prefix
    cache hits and pages are copied on write.  Served twice on the same
    prompts: with a bf16 pool (the serving default) and with an f32 pool.
    At bf16 the served logits differ from the f32 reference by up to a
    few 1e-3, so a token whose reference top-2 margin is smaller may
    legitimately differ from the reference argmax: the bf16 run is held
    to the logprob tolerance and reports its largest argmax gap, the f32
    run (kernel arithmetic = reference arithmetic up to summation order)
    is held to the argmax too."""
    srv = build_server(shared_pool=True, kv_dtype=kv_dtype)
    prompts = shared_prompts(srv.cfg.vocab_size)
    label = f"server (shared, {kv_dtype})"
    outs, counts, steps, wall, tokens = serve(label, srv, prompts)
    L = srv.cfg.n_layers
    st = srv.stats
    b = srv._batcher
    print(f"{label}: prefix_hit_pages={st['prefix_hit_pages']} "
          f"cow_copies={st['cow_copies']} prompt_pages={st['prompt_pages']} "
          f"pool_peak_pages={st['pool_peak_pages']} of "
          f"{st['pool_total_pages']}")
    check(steps > 0 and counts["B2"] == steps * L and counts["B1"] == 0
          and counts["B3"] == 0 and counts["B4"] == 0 and counts["B5"] == 0,
          f"shared launches {counts} != (0, decode steps {steps} x {L}, 0, "
          "0)")
    check(st["prefix_hit_pages"] > 0, "the prefix cache never hit")
    check(st["cow_copies"] > 0, "no page was copied on write")
    b.alloc.check()
    check(b.alloc.live_count == b.prefix_cache.evictable_pages(),
          "pages still mapped after the drain")
    check(outs[5].token_ids == outs[0].token_ids,
          "the exact repeat served other tokens than its original")
    lp_err, gap = teacher_forced_check(f"shared {kv_dtype}", srv, outs,
                                       argmax=kv_dtype == "float32")
    return {"launches": counts["B2"], "launches_B1": counts["B1"],
            "kv_dtype": kv_dtype, "decode_steps": steps, "wall_s": wall,
            "tokens": tokens, "prefix_hit_pages": st["prefix_hit_pages"],
            "cow_copies": st["cow_copies"],
            "pool_peak_pages": st["pool_peak_pages"],
            "pool_total_pages": st["pool_total_pages"],
            "logprob_err": lp_err, "logit_gap": gap,
            "token_ids": [o.token_ids for o in outs]}


# ---------------------------------------------------------------------------
# phases 7-8: the quantized GEMV (B3) and the quantized deployments
# ---------------------------------------------------------------------------

GEMV_SHAPES = (("qwen1.5-0.5b wo", 1024, 1024),
               ("qwen1.5-0.5b gate/up", 1024, 2816),
               ("qwen1.5-0.5b down", 2816, 1024),
               ("llama3.1-8b gate/up", 4096, 14336),
               ("llama3.1-8b down", 14336, 4096),
               ("rwkv6-3b att", 2560, 2560),
               ("rwkv6-3b ffn key", 2560, 8960),
               ("rwkv6-3b ffn value", 8960, 2560),
               ("ragged", 130, 77))
# the timed shapes: the serving shape first (W4A16, qwen1.5-0.5b's gate
# projection at the 4 decode slots), then the long one (llama3.1-8b's down
# projection) and both at the 64-row prefill chunk
GEMV_TIMED = (("qwen1.5-0.5b gate, serving", 4, 1024, 2816),
              ("llama3.1-8b down, long", 4, 14336, 4096),
              ("qwen1.5-0.5b gate, prefill", 64, 1024, 2816),
              ("llama3.1-8b down, prefill", 64, 14336, 4096))


def gemv_rows():
    """The sweep's M: one row, the decode slots, the stream path's two
    instances, the prefill chunk, two row tiles, and the crossover +-1."""
    from repro_torch.kernels.quant_gemv.kernel import STREAM_MAX_M
    return sorted({1, 4, 8, 16, 64, 70, STREAM_MAX_M - 1, STREAM_MAX_M,
                   STREAM_MAX_M + 1})


def gemv_case(scheme, M, D, F, gen):
    """Random x [M, D] and a quantized fan-in-scaled weight [D, F]."""
    import torch
    from repro_torch.core.quant import quantize_weight
    w = torch.randn(D, F, generator=gen, device="cuda") / D ** 0.5
    x = torch.randn(M, D, generator=gen, device="cuda")
    return x, quantize_weight(w, scheme)


def rel_err(a, b) -> float:
    """max |a - b| / max |b|."""
    return float((a.double() - b.double()).abs().max()
                 / b.double().abs().max())


def quant_kernel_phase() -> float:
    """B3 against `quant_gemv_ref`, and W4A16 also against the TPU
    kernel's function (float32 accumulation of bf16(x) · w4, taken in
    float64 here); a second launch on the same inputs must give the same
    bits (the split-D sum is ordered, not atomic)."""
    import torch
    from repro_torch.core.quant import unpack_int4
    from repro_torch.kernels.quant_gemv import quant_gemv, quant_gemv_ref
    from repro_torch.kernels.quant_gemv.kernel import choose_gemv_plan
    gen = torch.Generator(device="cuda").manual_seed(3)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    max_abs, n = 0.0, 0
    for scheme in ("w4a16", "w8a8"):
        for M in gemv_rows():
            for label, D, F in GEMV_SHAPES:
                x, qw = gemv_case(scheme, M, D, F, gen)
                got = quant_gemv(x, qw)
                again = quant_gemv(x, qw)
                torch.cuda.synchronize()
                want = quant_gemv_ref(x, qw.q, qw.scale, scheme)
                err = rel_err(got, want)
                plan = choose_gemv_plan(M, D, F, scheme, sms)
                msg = (f"B3 {scheme} M={M:2d} {label} [{D}->{F}] "
                       f"({plan.path}, {plan.rows} rows, S={plan.splits}): "
                       f"rel_err={err:.3e} (tol {GEMV_TOL[scheme]:.0e})")
                check(bool(torch.isfinite(got).all())
                      and got.shape == (M, F), f"{msg}: bad output")
                check(torch.equal(got, again),
                      f"{msg}: a second launch gave other bits")
                if scheme == "w4a16":
                    tpu = ((x.to(torch.bfloat16).double()
                            @ unpack_int4(qw.q).double())
                           * qw.scale.double())
                    err_tpu = rel_err(got, tpu)
                    msg += (f", vs the TPU kernel's function "
                            f"{err_tpu:.3e} (tol {GEMV_TPU_TOL:.0e})")
                    check(err_tpu <= GEMV_TPU_TOL, msg)
                print(msg)
                check(err <= GEMV_TOL[scheme], msg)
                max_abs = max(max_abs, float((got - want).abs().max()))
                n += 1
    print(f"B3 kernel phase: {n} cases within tolerance, each launched "
          f"twice with the same bits, max_abs_err={max_abs:.3e}")
    return max_abs


def gemv_bound(scheme, M, D, F, rate) -> dict:
    """Packed weight + scale + x + out bytes at the HBM rate vs 2·M·D·F
    operations at the dense tensor-core peak of the input type."""
    nbytes = (D * F // (2 if scheme == "w4a16" else 1) + 4 * F
              + M * D * (2 if scheme == "w4a16" else 1) + 4 * M * F)
    ops = 2 * M * D * F
    t_bytes = nbytes / rate * 1e3
    t_ops = ops / TC_OPS[scheme] * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": nbytes, "ops": ops}


def timed_result(head: str, res: dict, times: dict) -> dict:
    for key, t in times.items():
        res[key] = statistics.median(t)
        res[f"{key}_min_max"] = [t[0], t[-1]]
    print(f"timing {head} (median [min, max]): "
          + " ".join(f"{k}={res[k]:.6f} [{t[0]:.6f}, {t[-1]:.6f}]"
                     for k, t in times.items())
          + f" bound_ms={res['bound_ms']:.6f} ({res['bound_by']}, "
          f"{res['bytes']} bytes, {res['ops']} ops)")
    return res


def gemv_kernel_input(scheme, x):
    """x as B3 receives it: bf16, or int8 codes and their scales."""
    import torch
    from repro_torch.core.quant import quantize_activations_int8
    if scheme == "w8a8":
        return quantize_activations_int8(x)
    return x.to(torch.bfloat16), None


def quant_timing_shape(label, scheme, M, D, F, rate, flush, gen):
    """B3 at one shape: the kernel on x prepared as it receives it (bf16,
    or int8 codes), the plain version on float x (its activation
    quantization included), and the library yardstick: torch._int_mm
    plus the two scales (W8A8 at M > 16, where that call exists), else a
    dense bf16 torch.matmul on the weight dequantized beforehand — the
    product the quantized weight replaces.  read_ms: one torch sum over
    the packed weight's bytes (as float32 words, NaN or not), what a
    single read of them costs in practice under this timing: a yardstick
    beside the bound, not a gate."""
    import torch
    from repro_torch.core.quant import dequantize
    from repro_torch.kernels.quant_gemv import quant_gemv_cuda, quant_gemv_ref
    x, qw = gemv_case(scheme, M, D, F, gen)
    xk, xs = gemv_kernel_input(scheme, x)
    times = {
        "ms": time_ms(lambda: quant_gemv_cuda(xk, qw.q, qw.scale, scheme),
                      20, flush),
        "plain_ms": time_ms(lambda: quant_gemv_ref(x, qw.q, qw.scale,
                                                   scheme), 5, flush),
    }
    if scheme == "w8a8" and M > 16:
        library = "torch._int_mm + scales"
        qb = qw.q
        try:
            torch._int_mm(xk, qb)
        except RuntimeError:          # cuBLASLt wants B column-major
            qb = qw.q.t().contiguous().t()
        times["library_ms"] = time_ms(
            lambda: torch._int_mm(xk, qb).float() * qw.scale * xs, 20, flush)
    else:
        library = "torch.matmul bf16 on the dequantized weight"
        wd = dequantize(qw, torch.bfloat16)
        xb = x.to(torch.bfloat16)
        times["library_ms"] = time_ms(lambda: torch.matmul(xb, wd), 20,
                                      flush)
    words = qw.q.view(torch.float32)
    times["read_ms"] = time_ms(lambda: words.sum(), 20, flush)
    res = {"shape": label, "scheme": scheme, "M": M, "D": D, "F": F,
           "library": library, **gemv_bound(scheme, M, D, F, rate)}
    return timed_result(f"B3 {scheme} {label} M={M} [{D}->{F}]", res,
                        times)


def crossover_timing(rate, flush, gen) -> list:
    """Both paths forced at the M around the crossover, on the two timed
    weights: where the tile path overtakes the stream path."""
    import torch
    from repro_torch.kernels.quant_gemv.kernel import (choose_gemv_plan,
                                                       quant_gemv_cuda)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    rows = []
    for scheme in ("w4a16", "w8a8"):
        for label, _, D, F in GEMV_TIMED[:2]:
            for M in (8, 16, 24, 32):
                x, qw = gemv_case(scheme, M, D, F, gen)
                xk, _ = gemv_kernel_input(scheme, x)
                times = {}
                for path in ("stream", "tile"):
                    plan = choose_gemv_plan(M, D, F, scheme, sms, path=path)
                    times[f"{path}_ms"] = time_ms(
                        lambda: quant_gemv_cuda(xk, qw.q, qw.scale, scheme,
                                                plan=plan), 20, flush)
                res = {"shape": label.split(",")[0], "scheme": scheme,
                       "M": M, "D": D, "F": F,
                       **gemv_bound(scheme, M, D, F, rate)}
                rows.append(timed_result(
                    f"B3 crossover {scheme} {res['shape']} M={M}", res,
                    times))
    return rows


def quant_timing_phase(rate):
    """The four timed shapes for both schemes, then the crossover."""
    import torch
    gen = torch.Generator(device="cuda").manual_seed(4)
    flush = torch.empty(64 * 2 ** 20, dtype=torch.float32, device="cuda")
    shapes = [quant_timing_shape(label, scheme, M, D, F, rate, flush, gen)
              for scheme in ("w4a16", "w8a8")
              for label, M, D, F in GEMV_TIMED]
    return shapes, crossover_timing(rate, flush, gen)


def old_gemv_launcher(source: str):
    """B3's earlier CUDA-core body (its C interface: splits chosen in C, x
    rows padded to a multiple of 4), built by nvcc from `source` into
    build/ and bound beside the current one, for a one-process A/B."""
    import ctypes
    import hashlib
    import torch
    from repro_torch.kernels import _build
    src = Path(source).resolve()
    digest = hashlib.sha256(src.read_bytes()).hexdigest()[:16]
    out = _build._BUILD_DIR / f"quant_gemv_old-{digest}.so"
    if not out.exists():
        _build._BUILD_DIR.mkdir(parents=True, exist_ok=True)
        subprocess.run([_build._nvcc(), *_build._NVCC_FLAGS, "-o", str(out),
                        str(src)], check=True)
    lib = ctypes.CDLL(str(out))
    P, I = ctypes.c_void_p, ctypes.c_int
    gemv, splits_of = lib.kvnand_quant_gemv, lib.kvnand_quant_gemv_splits
    gemv.argtypes, gemv.restype = [P] * 6 + [I] * 7 + [P], I
    splits_of.argtypes, splits_of.restype = [I] * 5, I
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    tickets = torch.zeros(1 << 16, dtype=torch.int32, device="cuda")

    def launch(x, q, scale, scheme):
        M, D = x.shape
        F = q.shape[-1]
        check(D % 4 == 0 and F % 4 == 0, "the A/B shapes need no padding")
        code = 0 if scheme == "w4a16" else 1
        out = torch.empty((M, F), dtype=torch.float32, device="cuda")
        s = splits_of(M, D, F, code, sms)
        ws = torch.empty((s, M, F), dtype=torch.float32, device="cuda")
        rc = gemv(x.data_ptr(), q.data_ptr(), scale.data_ptr(),
                  out.data_ptr(), ws.data_ptr(), tickets.data_ptr(), M, D, F,
                  D, code, s, 1, torch.cuda.current_stream().cuda_stream)
        check(rc == 0, f"old B3 launch failed: CUDA error {rc}")
        return out
    return launch


def gemv_ab_phase(source: str, rate) -> list:
    """The old body (from `source`) and the current one at the 8 timed
    shapes, in one process, in the order old, new, new, old; both are
    first held against each other (W8A8 exactly, W4A16 within the TPU
    function's tolerance)."""
    import torch
    from repro_torch.kernels.quant_gemv import quant_gemv_cuda
    old = old_gemv_launcher(source)
    gen = torch.Generator(device="cuda").manual_seed(4)
    flush = torch.empty(64 * 2 ** 20, dtype=torch.float32, device="cuda")
    rows = []
    for scheme in ("w4a16", "w8a8"):
        for label, M, D, F in GEMV_TIMED:
            x, qw = gemv_case(scheme, M, D, F, gen)
            xk, _ = gemv_kernel_input(scheme, x)
            fns = {"old": lambda: old(xk, qw.q, qw.scale, scheme),
                   "new": lambda: quant_gemv_cuda(xk, qw.q, qw.scale,
                                                  scheme)}
            err = rel_err(fns["new"](), fns["old"]())
            check(err <= (0 if scheme == "w8a8" else GEMV_TPU_TOL),
                  f"A/B {scheme} {label}: old and new bodies differ by "
                  f"{err:.3e}")
            times = {}
            for i, which in enumerate(("old", "new", "new", "old")):
                times[f"{which}{i}_ms"] = time_ms(fns[which], 20, flush)
            res = {"shape": label, "scheme": scheme, "M": M, "D": D, "F": F,
                   "old_vs_new_rel_err": err,
                   **gemv_bound(scheme, M, D, F, rate)}
            rows.append(timed_result(f"B3 A/B {scheme} {label} M={M}", res,
                                     times))
    return rows


def tree_to(tree, device):
    """A parameter tree (tensors and QuantizedWeight leaves) on `device`."""
    if isinstance(tree, dict):
        return {k: tree_to(v, device) for k, v in tree.items()}
    return tree.to(device)


def compare_runs(outs, ref_outs):
    """Served logprobs of two runs of the same prompts, up to and
    including each request's first differing token (after it the two
    condition on other tokens); returns (max |difference|, requests that
    served identical tokens, per request (first differing index or None,
    max |difference| before it, |difference| at it))."""
    err, same, rows = 0.0, 0, []
    for o, r in zip(outs, ref_outs):
        n = 0
        while (n < len(o.token_ids) and n < len(r.token_ids)
               and o.token_ids[n] == r.token_ids[n]):
            n += 1
        same += o.token_ids == r.token_ids
        d = [abs(a - b) for a, b in zip(o.logprobs, r.logprobs)]
        before = max(d[:n], default=0.0)
        at = d[n] if n < len(d) else None
        rows.append((n if n < len(d) else None, before, at))
        err = max(err, before, at or 0.0)
    return err, same, rows


def prefill_logits(srv, prompt):
    """`prompt` prefilled chunk by chunk into a fresh one-slot cache of the
    server's engine: its last-token logits over the vocabulary, on the
    CPU."""
    import torch
    b = srv._batcher
    cache = b.engine.init_cache(1, b.max_context)
    C = b.chunk_tokens
    for pos in range(0, len(prompt), C):
        n = min(C, len(prompt) - pos)
        toks = torch.zeros((1, C), dtype=torch.long, device=b.device)
        toks[0, :n] = torch.tensor(prompt[pos:pos + n])
        logits, _ = b.engine.prefill_chunk(b.params, cache, {"tokens": toks},
                                           0, pos, n, first=pos == 0)
    return logits.float().cpu()[..., :srv.cfg.vocab_size]


def prefill_gaps(card, cpu, prompts):
    """Each prompt prefilled on the card and on the CPU (no sampling, so
    nothing diverges): ||card - CPU|| / ||CPU|| of its last-token logits
    (Euclidean norms over the vocabulary)."""
    gaps = []
    for prompt in prompts:
        a, r = prefill_logits(card, prompt), prefill_logits(cpu, prompt)
        gaps.append(float((a - r).norm() / r.norm()))
    return gaps


def quant_server_phase(label, scheme, kv_quant, shared, prompts_of):
    """A quantized deployment of full-width qwen1.5-0.5b on the card (the
    random model of the server phases, quantized by `quantize_params`),
    then the same server on the CPU with the same params, both serving the
    same prompts.  Every copy-on-write is checked as it happens: the new
    page's codes and scales equal its source's."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core import paged_kv
    from repro_torch.core.quant import quantize_params
    from repro_torch.models.registry import Model
    cfg = get_config("qwen1.5-0.5b")
    gen = torch.Generator(device="cuda").manual_seed(0)
    qparams = quantize_params(Model(cfg).init(gen), scheme)
    eng = dict(kv_quant=kv_quant, shared_pool=shared)
    srv = build_server(params=qparams, **eng)
    prompts = prompts_of(srv.cfg.vocab_size)
    copies = []
    plain_copy = paged_kv.copy_page_shared

    def checked_copy(leaf, src, dst):
        plain_copy(leaf, src, dst)
        copies.append((leaf.dtype == torch.float32,
                       bool(torch.equal(leaf[:, :, dst], leaf[:, :, src]))))
        return leaf

    paged_kv.copy_page_shared = checked_copy
    try:
        outs, counts, steps, wall, tokens = serve(label, srv, prompts)
    finally:
        paged_kv.copy_page_shared = plain_copy
    L = srv.cfg.n_layers
    chunks = counts["prefill_chunks"]
    paged = "B2" if shared else "B1"
    other = "B1" if shared else "B2"
    check(steps > 0 and counts["B3"] == 4 * L * (steps + chunks)
          and counts[paged] == steps * L and counts[other] == 0
          and counts["B4"] == 0 and counts["B5"] == 0,
          f"{label}: launches {counts} != (B3 4 x {L} x ({steps} decode "
          f"steps + {chunks} chunks), {paged} {steps} x {L}, {other} 0, B4 "
          "0)")
    st = srv.stats
    res = {"launches": counts["B3"], f"launches_{paged}": counts[paged],
           f"launches_{other}": counts[other], "scheme": scheme,
           "kv_quant": kv_quant, "pool": "shared" if shared else "stripe",
           "decode_steps": steps, "prefill_chunks": chunks, "wall_s": wall,
           "tokens": tokens}
    if shared:
        b = srv._batcher
        scale_copies = sum(1 for is_scale, _ in copies if is_scale)
        print(f"{label}: prefix_hit_pages={st['prefix_hit_pages']} "
              f"cow_copies={st['cow_copies']} ({len(copies)} leaf copies, "
              f"{scale_copies} of scales, all equal to their source: "
              f"{all(eq for _, eq in copies)}) pool_peak_pages="
              f"{st['pool_peak_pages']} of {st['pool_total_pages']}")
        check(st["prefix_hit_pages"] > 0, f"{label}: no prefix hit")
        check(st["cow_copies"] > 0
              and len(copies) == 4 * st["cow_copies"]
              and scale_copies == 2 * st["cow_copies"]
              and all(eq for _, eq in copies),
              f"{label}: copy-on-write did not copy codes and scales")
        b.alloc.check()
        check(b.alloc.live_count == b.prefix_cache.evictable_pages(),
              f"{label}: pages still mapped after the drain")
        check(outs[5].token_ids == outs[0].token_ids,
              f"{label}: the exact repeat served other tokens")
        res.update(prefix_hit_pages=st["prefix_hit_pages"],
                   cow_copies=st["cow_copies"])
    # the same server on the CPU: plain versions, the same params
    cpu = build_server(params=tree_to(qparams, "cpu"), device="cpu", **eng)
    cpu_outs, cpu_counts, _, cpu_wall, _ = serve(f"{label} on the CPU", cpu,
                                                 prompts)
    check(all(cpu_counts[k] == 0 for k in ("B1", "B2", "B3", "B4", "B5")),
          f"{label}: the CPU run launched a kernel")
    lp_err, same, rows = compare_runs(outs, cpu_outs)
    gaps = prefill_gaps(srv, cpu, prompts)
    print(f"check {label}: card vs CPU run ({cpu_wall:.3f} s on the CPU): "
          f"{same} of {len(prompts)} requests served identical tokens; max "
          f"|served logprob difference| up to each first differing token = "
          f"{lp_err:.3e} (tol {QUANT_LOGPROB_TOL:.0e}); per request (first "
          f"differing token, max before it, at it): {rows}")
    print(f"check {label}: each prompt prefilled on both, ||logit "
          f"difference|| / ||CPU logits|| at its last token: "
          f"{', '.join(f'{g:.4e}' for g in gaps)} (max {max(gaps):.4e}, tol "
          f"{QUANT_PREFILL_TOL:.0e})")
    res.update(cpu_wall_s=cpu_wall, same_tokens=same, logprob_err=lp_err,
               prefill_gaps=gaps, prefill_gap=max(gaps))
    return res


# ---------------------------------------------------------------------------
# phases 9-10: flash attention (B4) and the splice scheduler
# ---------------------------------------------------------------------------

# H, K, dh: qwen1.5-0.5b, llama3.1-8b, MQA, the reduced configs' 32, and
# the head dims B4 pads inside shared memory (112, 160 and 256, which
# gemma3-12b serves), so every instance (width 64, 128, 256 x f32, bf16)
# runs
FLASH_HEADS = ((16, 16, 64), (32, 8, 128), (8, 1, 64), (4, 2, 32),
               (4, 2, 112), (4, 2, 160), (8, 4, 256))
# (Sq, Sk, q_offset): ragged prompts, and queries placed before or at the
# end of a longer key range
FLASH_LENGTHS = ((1, 1, 0), (70, 70, 0), (255, 255, 0), (511, 511, 0),
                 (70, 255, 0), (70, 255, 185))
# the plans each sweep case runs under: the host's choice, then every
# cluster size forced
FLASH_PLANS = (None, 1, 2, 4, 8)
# dense tensor-core peaks (NVIDIA H100 SXM data sheet): B4's f32 products
# run as three TF32 products each, its bf16 ones on bf16
TF32_FLOPS = 494.7e12
BF16_FLOPS = 989e12


def flash_inputs(B, Sq, Sk, H, K, dh, dtype, gen):
    import torch
    return (torch.randn(B, Sq, H, dh, generator=gen, device="cuda")
            .to(dtype),
            torch.randn(B, Sk, K, dh, generator=gen, device="cuda").to(dtype),
            torch.randn(B, Sk, K, dh, generator=gen, device="cuda").to(dtype))


def flash_plan(q, k, split, **kw):
    """The host's plan for this call, or one with `split` forced."""
    import torch
    from repro_torch.kernels.flash_attention import choose_flash_plan
    B, Sq, H, dh = q.shape
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return choose_flash_plan(B, Sq, k.shape[1], H, kw["causal"],
                             kw["window"], sms, q_offset=kw["q_offset"],
                             dh=dh, dtype=q.dtype, split=split)


def flash_kernel_phase() -> float:
    """B4 against `flash_attention_ref` under the host's plan and every
    forced cluster size, each plan launched twice for the same bits;
    returns max |o - plain o|."""
    import itertools
    import torch
    from repro_torch.kernels.flash_attention import (flash_attention_cuda,
                                                     flash_attention_ref)
    gen = torch.Generator(device="cuda").manual_seed(5)
    max_abs, n = 0.0, 0
    worst = {"f32": 0.0, "bf16": 0.0, "bf16 vs f32": 0.0}
    chosen = {}
    for fmt, (H, K, dh), causal, window, (Sq, Sk, off), B in \
            itertools.product(("f32", "bf16"), FLASH_HEADS, (True, False),
                              (None, 16, 64), FLASH_LENGTHS, (1, 3)):
        dt = torch.float32 if fmt == "f32" else torch.bfloat16
        q, k, v = flash_inputs(B, Sq, Sk, H, K, dh, dt, gen)
        kw = dict(causal=causal, window=window, q_offset=off)
        want = flash_attention_ref(q, k, v, **kw)
        w32 = (flash_attention_ref(q.float(), k.float(), v.float(), **kw)
               if fmt == "bf16" else None)
        for split in FLASH_PLANS:
            plan = flash_plan(q, k, split, **kw)
            got = flash_attention_cuda(q, k, v, plan=plan, **kw)
            again = flash_attention_cuda(q, k, v, plan=plan, **kw)
            torch.cuda.synchronize()
            label = (f"B4 {fmt} H={H} K={K} dh={dh} causal={causal} "
                     f"window={window} B={B} Sq={Sq} Sk={Sk} q_offset={off} "
                     f"S={plan.split}{'' if split else ' (chosen)'}")
            if split is None:
                chosen[plan.split] = chosen.get(plan.split, 0) + 1
            check(got.shape == want.shape and got.dtype == dt
                  and bool(torch.isfinite(got).all()), f"{label}: bad output")
            check(torch.equal(got, again),
                  f"{label}: a repeated launch gave other bits")
            err = close_err(got, want, FLASH_TOL[fmt])
            worst[fmt] = max(worst[fmt], err)
            check(err <= FLASH_TOL[fmt], f"{label}: kernel disagrees with "
                  f"plain version: {err:.3e} > {FLASH_TOL[fmt]:.0e}")
            if fmt == "bf16":
                bound = BF16_ROUNDING * w32.abs() + FLASH_TOL["f32"] * (
                    1 + w32.abs())
                err32 = float(((got.float() - w32).abs() / bound).max())
                worst["bf16 vs f32"] = max(worst["bf16 vs f32"], err32)
                check(err32 <= 1, f"{label}: bf16 kernel disagrees with its "
                      f"own arithmetic: {err32:.3e} of one bf16 rounding + "
                      "2e-5")
            max_abs = max(max_abs, float((got.float() - want.float()).abs()
                                         .max()))
            n += 1
    print(f"B4 kernel phase: {n} cases within tolerance (each launched "
          f"twice with the same bits; the host chose S "
          f"{dict(sorted(chosen.items()))}); worst rel_err f32 "
          f"{worst['f32']:.3e} (tol {FLASH_TOL['f32']:.0e}), bf16 "
          f"{worst['bf16']:.3e} (tol {FLASH_TOL['bf16']:.0e}), bf16 vs the "
          f"f32-upcast plain version {worst['bf16 vs f32']:.3e} of one bf16 "
          f"rounding + 2e-5; max_abs_err={max_abs:.3e}")
    return max_abs


def flash_bound(B, S, H, K, dh, dtype, rate) -> dict:
    """The least time the card could take for one causal prompt (Sq = Sk
    = S): 4·dh FLOPs per visible (query, key) pair at the fastest exact
    route of the input type (f32: three TF32 products at the TF32 peak;
    bf16: the bf16 peak), against q, k, v and o moved once at the HBM
    rate; and the same FLOPs at the f32 CUDA-core peak beside it."""
    pairs = S * (S + 1) // 2
    flops = 4 * B * H * dh * pairs
    f32 = dtype == "float32"
    nbytes = (4 if f32 else 2) * B * S * dh * (2 * H + 2 * K)
    t_ops = (3 * flops / TF32_FLOPS if f32 else flops / BF16_FLOPS) * 1e3
    t_bytes = nbytes / rate * 1e3
    return {"bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "bound_cuda_core_ms": flops / F32_FLOPS * 1e3,
            "flops": flops, "bytes": nbytes}


def flash_timing_shape(label, B, S, H, K, dh, dtype, rate, flush, gen, reps,
                       splits=()):
    """B4 at one causal shape: the kernel under the host's plan (and, for
    each of `splits`, with S forced), the plain version, and one SDPA call
    in the same dtype on the same tensors (K/V expanded to H heads
    beforehand, [B, H, S, dh] copies)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import (flash_attention_cuda,
                                                     flash_attention_ref)
    dt = getattr(torch, dtype)
    q, k, v = flash_inputs(B, S, S, H, K, dh, dt, gen)
    G = H // K
    qs = q.transpose(1, 2).contiguous()
    ks = k.repeat_interleave(G, dim=2).transpose(1, 2).contiguous()
    vs = v.repeat_interleave(G, dim=2).transpose(1, 2).contiguous()
    kw = dict(causal=True, window=None, q_offset=0)
    plan = flash_plan(q, k, None, **kw)
    times = {
        "ms": time_ms(lambda: flash_attention_cuda(q, k, v, causal=True),
                      reps, flush),
        "plain_ms": time_ms(lambda: flash_attention_ref(q, k, v, causal=True),
                            3, flush),
        "library_ms": time_ms(lambda: F.scaled_dot_product_attention(
            qs, ks, vs, is_causal=True), reps, flush),
    }
    for split in splits:
        forced = flash_plan(q, k, split, **kw)
        times[f"S{split}_ms"] = time_ms(
            lambda: flash_attention_cuda(q, k, v, causal=True, plan=forced),
            reps, flush)
    res = {"shape": label, "B": B, "S": S, "H": H, "K": K, "dh": dh,
           "dtype": dtype, "causal": True, "split": plan.split,
           "library": f"scaled_dot_product_attention(is_causal=True), "
                      f"{dtype}",
           **flash_bound(B, S, H, K, dh, dtype, rate)}
    for key, t in times.items():
        res[key] = statistics.median(t)
        res[f"{key}_min_max"] = [t[0], t[-1]]
    print(f"timing B4 {label} B={B} S={S} H={H} K={K} dh={dh} {dtype} causal "
          f"(median [min, max]; chosen split S={plan.split}): " + " ".join(
              f"{k}={res[k]:.6f} [{t[0]:.6f}, {t[-1]:.6f}]"
              for k, t in times.items())
          + f" bound_ms={res['bound_ms']:.6f} ({res['bound_by']}, "
          f"{res['flops']} flops, {res['bytes']} bytes) "
          f"bound_cuda_core_ms={res['bound_cuda_core_ms']:.6f}; library = "
          f"{res['library']}")
    return res


def flash_timing_phase(rate):
    """The serving shape (a bucketed qwen1.5-0.5b admit), the 64-token
    bucket, and the long shape (llama3.1-8b heads) in f32 and bf16; every
    cluster size forced at the two short ones."""
    import torch
    gen = torch.Generator(device="cuda").manual_seed(6)
    flush = torch.empty(64 * 2 ** 20, dtype=torch.float32, device="cuda")
    return (flash_timing_shape("serving", 1, 256, 16, 16, 64, "float32",
                               rate, flush, gen, 20, splits=(1, 2, 4, 8)),
            flash_timing_shape("bucket64", 1, 64, 16, 16, 64, "float32",
                               rate, flush, gen, 20, splits=(1, 2)),
            flash_timing_shape("long", 1, 8192, 32, 8, 128, "float32", rate,
                               flush, gen, 5),
            flash_timing_shape("long bf16", 1, 8192, 32, 8, 128, "bfloat16",
                               rate, flush, gen, 5))


def old_flash_launcher(source: str):
    """B4's body before its tensor-core redesign (its C interface: no
    split argument), built by nvcc from `source` into build/ and bound
    beside the current one, for a one-process A/B."""
    import ctypes
    import hashlib
    import torch
    from repro_torch.kernels import _build
    src = Path(source).resolve()
    digest = hashlib.sha256(src.read_bytes()).hexdigest()[:16]
    out = _build._BUILD_DIR / f"flash_attention_old-{digest}.so"
    if not out.exists():
        _build._BUILD_DIR.mkdir(parents=True, exist_ok=True)
        subprocess.run([_build._nvcc(), *_build._NVCC_FLAGS, "-o", str(out),
                        str(src)], check=True)
    fn = ctypes.CDLL(str(out)).kvnand_flash_attention
    P, LL, I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    fn.argtypes = [P] * 4 + [LL] * 9 + [I] * 10 + [ctypes.c_float, P]
    fn.restype = I

    def launch(q, k, v):
        B, Sq, H, dh = q.shape
        out = torch.empty_like(q)
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], B, Sq,
                k.shape[1], H, k.shape[2], dh, 1, 0, 0,
                int(q.dtype == torch.bfloat16), dh ** -0.5,
                torch.cuda.current_stream().cuda_stream)
        check(rc == 0, f"old B4 launch failed: CUDA error {rc}")
        return out
    return launch


def flash_ab_phase(source: str, rate) -> list:
    """The old body (from `source`) and the current one at the four timed
    shapes, causal, in one process, in the order old, new, new, old; both
    are first held against each other within FLASH_TOL."""
    import torch
    from repro_torch.kernels.flash_attention import flash_attention_cuda
    old = old_flash_launcher(source)
    gen = torch.Generator(device="cuda").manual_seed(6)
    flush = torch.empty(64 * 2 ** 20, dtype=torch.float32, device="cuda")
    rows = []
    for label, B, S, H, K, dh, dtype, reps in (
            ("serving", 1, 256, 16, 16, 64, "float32", 20),
            ("bucket64", 1, 64, 16, 16, 64, "float32", 20),
            ("long", 1, 8192, 32, 8, 128, "float32", 5),
            ("long bf16", 1, 8192, 32, 8, 128, "bfloat16", 5)):
        q, k, v = flash_inputs(B, S, S, H, K, dh, getattr(torch, dtype), gen)
        fns = {"old": lambda: old(q, k, v),
               "new": lambda: flash_attention_cuda(q, k, v, causal=True)}
        fmt = "f32" if dtype == "float32" else "bf16"
        err = close_err(fns["new"](), fns["old"](), FLASH_TOL[fmt])
        check(err <= FLASH_TOL[fmt], f"A/B B4 {label}: old and new bodies "
              f"differ by {err:.3e}")
        times = {}
        for i, which in enumerate(("old", "new", "new", "old")):
            times[f"{which}{i}_ms"] = time_ms(fns[which], reps, flush)
        res = {"shape": label, "B": B, "S": S, "H": H, "K": K, "dh": dh,
               "dtype": dtype, "old_vs_new_rel_err": err,
               **flash_bound(B, S, H, K, dh, dtype, rate)}
        for key, t in times.items():
            res[key] = statistics.median(t)
            res[f"{key}_min_max"] = [t[0], t[-1]]
        print(f"timing B4 A/B {label} (median [min, max]): " + " ".join(
            f"{k}={res[k]:.6f} [{t[0]:.6f}, {t[-1]:.6f}]"
            for k, t in times.items())
            + f" bound_ms={res['bound_ms']:.6f} old_vs_new_rel_err={err:.3e}")
        rows.append(res)
    return rows


def splice_prompts(V):
    """The stripe prompts and one of 500 tokens, whose power-of-two bucket
    (512) clamps to the slot's 511."""
    import numpy as np
    rng = np.random.default_rng(2)
    return stripe_prompts(V) + [rng.integers(0, V, 500).tolist()]


def splice_server_phase():
    """S1: the splice scheduler on a stripe f32 pool.  Every admit is one
    B4 launch per layer (the bucketed one-shot prefill), every decode step
    one B1 launch per layer; the interleaved scheduler on the same prompts
    serves the same greedy tokens."""
    from repro_torch.serving.scheduler import bucket_length
    srv = build_server(scheduler="splice", kv_dtype="float32")
    prompts = splice_prompts(srv.cfg.vocab_size)
    check(bucket_length(len(prompts[-1]), hi=511) == 511,
          "the long prompt's bucket does not clamp to 511")
    label = "S1 (splice, stripe, f32)"
    outs, counts, steps, wall, tokens = serve(label, srv, prompts)
    L = srv.cfg.n_layers
    admits = counts["admits"]
    stall = srv.stats["decode_stall_tokens"]
    print(f"{label}: {admits} admits, decode_stall_tokens={stall}, wall "
          f"{wall:.3f} s")
    check(admits == len(prompts) and counts["B4"] == admits * L
          and counts["B1"] == steps * L and counts["B2"] == 0
          and counts["B3"] == 0 and counts["B5"] == 0,
          f"{label}: launches {counts} != (B1 decode steps {steps} x {L}, "
          f"B2 0, B3 0, B4 admits {admits} x {L})")
    lp_err, gap = teacher_forced_check("S1 splice", srv, outs)
    inter = build_server(kv_dtype="float32")
    i_outs, i_counts, _, i_wall, _ = serve("S1 on the interleaved scheduler",
                                           inter, prompts)
    same = sum(a.token_ids == b.token_ids for a, b in zip(outs, i_outs))
    print(f"check S1: {same} of {len(prompts)} requests served the same "
          f"greedy tokens on the splice and the interleaved scheduler")
    check(same == len(prompts) and i_counts["B4"] == 0,
          "S1: the splice and the interleaved scheduler served other tokens")
    return {"launches": counts["B4"], "launches_B1": counts["B1"],
            "admits": admits, "decode_steps": steps, "wall_s": wall,
            "interleaved_wall_s": i_wall, "tokens": tokens,
            "decode_stall_tokens": stall, "logprob_err": lp_err,
            "logit_gap": gap}


# ---------------------------------------------------------------------------
# phases 11-12: the RWKV6 wkv kernel (B5) and the RWKV6 server
# ---------------------------------------------------------------------------

WKV_LENGTHS = (1, 2, 31, 32, 33, 64, 65, 77, 256, 257, 511)
# chunk sizes other than the model's 32, at S = 70 (several chunks, a tail)
WKV_CHUNKS = (1, 7, 16)
# the timed shapes: (label, B, S, H, dh, reps), 40 heads x 64 as rwkv6-3b
WKV_TIMED = (("serving", 1, 256, 40, 64, 20), ("long", 1, 8192, 40, 64, 5),
             ("one chunk", 1, 32, 40, 64, 20),
             ("500 tokens", 1, 500, 40, 64, 20))


def wkv_inputs(B, S, H, dh, gen, logw=None, zero_state=False):
    """r, k, v, logw, u, s0 on the card; decays as the reference's tests
    draw them (-0.05 - 4·sigmoid(N(0, 1))) unless a constant is given."""
    import torch
    dev = "cuda"
    r, k, v = (torch.randn(B, S, H, dh, generator=gen, device=dev)
               for _ in range(3))
    if logw is None:
        lw = -0.05 - 4.0 * torch.sigmoid(
            torch.randn(B, S, H, dh, generator=gen, device=dev))
    else:
        lw = torch.full((B, S, H, dh), float(logw), device=dev)
    u = torch.randn(H, dh, generator=gen, device=dev) * 0.5
    s0 = torch.randn(B, H, dh, dh, generator=gen, device=dev) * 0.1
    return r, k, v, lw, u, torch.zeros_like(s0) if zero_state else s0


def wkv_errs(got, want) -> tuple:
    """(out, final state) of max |a - b| / (1 + |b|)."""
    return tuple(float(((g.float() - w.float()).abs()
                        / (1 + w.float().abs())).max())
                 for g, w in zip(got, want))


def wkv_hold(label, got, want, tol, name, worst) -> None:
    """Check out and the state against `want` separately; keep the worst
    of each in worst[name]."""
    err = wkv_errs(got, want)
    worst[name] = [max(a, b) for a, b in zip(worst[name], err)]
    check(err[0] <= tol and err[1] <= tol, f"{label}: kernel disagrees with "
          f"the plain {name}: out {err[0]:.3e}, state {err[1]:.3e} (tol "
          f"{tol:.0e})")


def wkv_launch_twice(label, x, chunk):
    """B5 launched twice; both launches must give the same bits.  Returns
    the first result."""
    import torch
    from repro_torch.kernels.wkv6 import wkv6_cuda
    B, S, H, dh = x[0].shape
    got = wkv6_cuda(*x, chunk=chunk)
    again = wkv6_cuda(*x, chunk=chunk)
    torch.cuda.synchronize()
    check(got[0].shape == (B, S, H, dh) and got[1].shape == (B, H, dh, dh)
          and all(bool(torch.isfinite(g).all()) for g in got),
          f"{label}: bad output")
    check(all(torch.equal(a, b) for a, b in zip(got, again)),
          f"{label}: a repeated launch gave other bits")
    return got


def wkv_kernel_phase() -> float:
    """B5 against the plain chunked form, the plain recurrence and the
    plain version of its own split (`wkv_chunk_parallel`), out and state
    held and reported separately, each case launched twice; returns
    max |out - plain chunked out| over the reference-distribution
    cases."""
    import itertools
    import torch
    from repro_torch.kernels.wkv6 import (wkv6, wkv_chunk_parallel,
                                          wkv_chunked, wkv_recurrent)
    gen = torch.Generator(device="cuda").manual_seed(7)
    worst = {name: [0.0, 0.0] for name in
             ("chunked form", "recurrence", "chunk-parallel form",
              "recurrence at logw -3/-4", "bf16")}
    max_abs, n = 0.0, 0
    cases = [(B, S, H, dh, zero, None, 32) for B, S, H, dh, zero in
             itertools.product((1, 3), WKV_LENGTHS, (1, 40), (16, 32, 64),
                               (True, False))]
    cases += [(B, S, 40, dh, False, logw, 32) for B, S, dh, logw in
              itertools.product((1, 3), (33, 256, 511), (16, 64),
                                (-3.0, -4.0, -0.05))]
    cases += [(2, 70, 3, dh, False, logw, chunk) for logw, dh, chunk in
              itertools.product((None, -4.0, -0.05), (16, 32, 64),
                                WKV_CHUNKS)]
    cases += [(1, 8192, 40, 64, False, None, 32)]
    for B, S, H, dh, zero, logw, chunk in cases:
        x = wkv_inputs(B, S, H, dh, gen, logw=logw, zero_state=zero)
        label = (f"B5 B={B} S={S} H={H} dh={dh} chunk={chunk} "
                 f"s0={'zero' if zero else 'random'} "
                 f"logw={'drawn' if logw is None else logw}")
        got = wkv_launch_twice(label, x, chunk)
        tol = WKV_TOL["recurrent"]
        strong = logw is not None and logw <= -3.0
        wkv_hold(label, got, wkv_recurrent(*x), tol,
                 "recurrence at logw -3/-4" if strong else "recurrence",
                 worst)
        wkv_hold(label, got, wkv_chunk_parallel(*x, chunk=chunk), tol,
                 "chunk-parallel form", worst)
        if not strong:
            chunked = wkv_chunked(*x, chunk=chunk)
            wkv_hold(label, got, chunked, WKV_TOL["chunked"], "chunked form",
                     worst)
            if logw is None:
                max_abs = max(max_abs, float((got[0] - chunked[0]).abs()
                                             .max()))
        n += 1
    # bf16 r/k/v/logw, as a server with bf16 activations hands them over:
    # `wkv6` upcasts them for B5 and returns bf16; the plain chunked form
    # on the same inputs upcasts inside too.  Both round the output to
    # bf16, so they may land one bf16 ulp (2^-7 relative) apart
    for B, S, dh in ((1, 2, 64), (3, 77, 32), (1, 511, 64)):
        x = wkv_inputs(B, S, 40, dh, gen)
        xb = tuple(a.to(torch.bfloat16) for a in x[:4]) + x[4:]
        got = wkv6(*xb)
        torch.cuda.synchronize()
        want = wkv_chunked(*xb)
        label = f"B5 bf16 B={B} S={S} H=40 dh={dh}"
        check(got[0].dtype == torch.bfloat16
              and got[1].dtype == torch.float32
              and all(bool(torch.isfinite(g).all()) for g in got),
              f"{label}: bad output")
        tol = WKV_TOL["chunked"]
        err_out = float(((got[0].float() - want[0].float()).abs()
                         / (tol + (2.0 ** -7 + tol)
                            * want[0].float().abs())).max())
        err_state = wkv_errs(got[1:], want[1:])[0]
        worst["bf16"] = [max(worst["bf16"][0], err_out),
                         max(worst["bf16"][1], err_state)]
        check(err_out <= 1 and err_state <= tol,
              f"{label}: kernel disagrees with the plain chunked form on "
              f"bf16 inputs: out {err_out:.3e} of one bf16 ulp + {tol:.0e}, "
              f"state {err_state:.3e} > {tol:.0e}")
        n += 1
    print(f"B5 kernel phase: {n} cases within tolerance (each launched "
          "twice, with the same bits); worst (out, state): " + "; ".join(
              f"vs the plain {k} ({v[0]:.3e}, {v[1]:.3e})"
              for k, v in worst.items() if k != "bf16")
          + f" (tol {WKV_TOL['chunked']:.0e} for the chunked form, "
          f"{WKV_TOL['recurrent']:.0e} the others); bf16 inputs "
          f"({worst['bf16'][0]:.3e} of one bf16 ulp + "
          f"{WKV_TOL['chunked']:.0e}, {worst['bf16'][1]:.3e}); "
          f"max_abs_err={max_abs:.3e}")
    return max_abs


# bounds beside B5's `bound_ms`, computed from the shape, printed and kept
# in `--wkv`'s JSON, left out of the {"kernels": ...} line
WKV_DESIGN_BOUNDS = ("bound_tc_ms", "design_bytes", "bound_design_ms")


def wkv_bound(B, S, H, dh, rate, chunk=32) -> dict:
    """The least time the card could take: the chunked form's
    4·dh·(32 + dh) FLOPs per token and head at the float32 CUDA-core peak,
    against r, k, v, logw and out moved once (plus u, s0 and sT) at the HBM
    rate.  Beside it: the same FLOPs as three TF32 products at the TF32
    peak (`bound_tc_ms`), and the bytes B5's split adds (rs, dS and e^{tot}
    of every chunk and the intra rows of out, each written and read once
    more; none for one chunk) with the time of all its bytes
    (`bound_design_ms`)."""
    flops = 4 * dh * (32 + dh) * B * S * H
    nbytes = 4 * (5 * B * S * H * dh + H * dh + 2 * B * H * dh * dh)
    n = -(-S // chunk)
    extra = 0 if n < 2 else 2 * 4 * B * H * (
        n * chunk * dh + n * dh * dh + n * dh + S * dh)
    t_ops = flops / F32_FLOPS * 1e3
    t_bytes = nbytes / rate * 1e3
    return {"bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "bound_tc_ms": 3 * flops / TF32_FLOPS * 1e3,
            "design_bytes": extra,
            "bound_design_ms": (nbytes + extra) / rate * 1e3,
            "flops": flops, "bytes": nbytes}


def wkv_timing_shape(label, B, S, H, dh, rate, flush, gen, reps):
    """B5 at one shape against the plain chunked form."""
    from repro_torch.kernels.wkv6 import wkv6_cuda, wkv_chunked
    x = wkv_inputs(B, S, H, dh, gen)
    times = {"ms": time_ms(lambda: wkv6_cuda(*x), reps, flush),
             "plain_ms": time_ms(lambda: wkv_chunked(*x), 3, flush)}
    res = {"shape": label, "B": B, "S": S, "H": H, "dh": dh,
           "dtype": "float32", "library_ms": None,
           "library": "none: no PyTorch call computes the wkv6 recurrence",
           **wkv_bound(B, S, H, dh, rate)}
    for key, t in times.items():
        res[key] = statistics.median(t)
        res[f"{key}_min_max"] = [t[0], t[-1]]
    print(f"timing B5 {label} B={B} S={S} H={H} dh={dh} f32 (median [min, "
          f"max]): "
          + " ".join(f"{k}={res[k]:.6f} [{t[0]:.6f}, {t[-1]:.6f}]"
                     for k, t in times.items())
          + f" bound_ms={res['bound_ms']:.6f} ({res['bound_by']}, "
          f"{res['flops']} flops, {res['bytes']} bytes) bound_tc_ms="
          f"{res['bound_tc_ms']:.6f} design_bytes={res['design_bytes']} "
          f"bound_design_ms={res['bound_design_ms']:.6f}; library = "
          f"{res['library']}")
    return res


def wkv_timing_phase(rate):
    import torch
    gen = torch.Generator(device="cuda").manual_seed(8)
    flush = torch.empty(64 * 2 ** 20, dtype=torch.float32, device="cuda")
    return tuple(wkv_timing_shape(label, B, S, H, dh, rate, flush, gen, reps)
                 for label, B, S, H, dh, reps in WKV_TIMED)


def old_wkv_launcher(source: str):
    """B5's body before its chunk-parallel redesign (its C interface: no
    scratch), built by nvcc from `source` into build/ and
    bound beside the current one, for a one-process A/B."""
    import ctypes
    import hashlib
    import torch
    from repro_torch.kernels import _build
    src = Path(source).resolve()
    digest = hashlib.sha256(src.read_bytes()).hexdigest()[:16]
    out = _build._BUILD_DIR / f"wkv6_old-{digest}.so"
    if not out.exists():
        _build._BUILD_DIR.mkdir(parents=True, exist_ok=True)
        subprocess.run([_build._nvcc(), *_build._NVCC_FLAGS, "-o", str(out),
                        str(src)], check=True)
    fn = ctypes.CDLL(str(out)).kvnand_wkv6
    P, LL, I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    fn.argtypes = [P] * 8 + [LL] * 12 + [I] * 5 + [P]
    fn.restype = I

    def launch(r, k, v, lw, u, s0):
        B, S, H, dh = r.shape
        o = torch.empty_like(r)
        sT = torch.empty_like(s0)
        rc = fn(r.data_ptr(), k.data_ptr(), v.data_ptr(), lw.data_ptr(),
                u.data_ptr(), s0.data_ptr(), o.data_ptr(), sT.data_ptr(),
                *r.stride()[:3], *k.stride()[:3], *v.stride()[:3],
                *lw.stride()[:3], B, S, H, dh, 32,
                torch.cuda.current_stream().cuda_stream)
        check(rc == 0, f"old B5 launch failed: CUDA error {rc}")
        return o, sT
    return launch


def wkv_ab_phase(source: str, rate) -> list:
    """The old body (from `source`) and the current one at the timed
    shapes, in one process, in the order old, new, new, old; both are
    first held against each other within WKV_TOL["chunked"]."""
    import torch
    from repro_torch.kernels.wkv6 import wkv6_cuda
    old = old_wkv_launcher(source)
    gen = torch.Generator(device="cuda").manual_seed(8)
    flush = torch.empty(64 * 2 ** 20, dtype=torch.float32, device="cuda")
    rows = []
    for label, B, S, H, dh, reps in WKV_TIMED:
        x = wkv_inputs(B, S, H, dh, gen)
        fns = {"old": lambda: old(*x), "new": lambda: wkv6_cuda(*x)}
        err = max(wkv_errs(fns["new"](), fns["old"]()))
        check(err <= WKV_TOL["chunked"], f"A/B B5 {label}: old and new "
              f"bodies differ by {err:.3e}")
        times = {}
        for i, which in enumerate(("old", "new", "new", "old")):
            times[f"{which}{i}_ms"] = time_ms(fns[which], reps, flush)
        res = {"shape": label, "B": B, "S": S, "H": H, "dh": dh,
               "old_vs_new_rel_err": err, **wkv_bound(B, S, H, dh, rate)}
        for key, t in times.items():
            res[key] = statistics.median(t)
            res[f"{key}_min_max"] = [t[0], t[-1]]
        print(f"timing B5 A/B {label} (median [min, max]): " + " ".join(
            f"{k}={res[k]:.6f} [{t[0]:.6f}, {t[-1]:.6f}]"
            for k, t in times.items())
            + f" bound_ms={res['bound_ms']:.6f} old_vs_new_rel_err={err:.3e}")
        rows.append(res)
    return rows


def rwkv_prompts(V):
    """The stripe prompts, one of 500 tokens and one of a single token."""
    import numpy as np
    rng = np.random.default_rng(3)
    return (stripe_prompts(V) + [rng.integers(0, V, 500).tolist()]
            + [rng.integers(0, V, 1).tolist()])


def build_rwkv_server(scheduler, params=None):
    """Full-width rwkv6-3b on the card, float32 weights (random from seed
    0, or `params`) and float32 token shifts."""
    import torch
    from repro_torch.configs import EngineConfig
    from repro_torch.serving.api import KVNANDServer, ServerConfig
    t0 = time.perf_counter()
    eng = EngineConfig(page_tokens=16, uniform_lengths=False,
                       kv_dtype="float32")
    srv = KVNANDServer(ServerConfig(
        arch="rwkv6-3b", reduced=False, engine=eng, batch_slots=4,
        max_context=512, prefill_chunk_tokens=64, device="cuda",
        scheduler=scheduler), params=params)
    cfg = srv.cfg
    check(cfg.family == "ssm" and cfg.n_layers == 32 and cfg.d_model == 2560
          and cfg.n_heads == 40 and cfg.d_head == 64 and cfg.d_ff == 8960
          and cfg.vocab_size == 65536, "not the full-width rwkv6-3b")
    c = srv._batcher.cache
    check(c.k_pages_g is None and c.rwkv_state.shape == (32, 4, 40, 64, 64),
          "the RWKV6 cache is not a recurrent state")
    torch.cuda.synchronize()
    n = sum(t.numel() for t in _leaves(srv.params))
    print(f"server: built {cfg.name} ({n / 1e9:.3f}B params, "
          f"{4 * n / 1e9:.1f} GB float32, {eng}, {scheduler} scheduler) on "
          f"the card in {time.perf_counter() - t0:.2f} s")
    return srv, n


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def rwkv_server_phase():
    """R1: full-width rwkv6-3b on the interleaved scheduler, then the same
    requests on the splice scheduler.  Each admit of >= 2 prompt tokens is
    one whole-prompt prefill, one B5 launch per layer; a one-token admit
    and every decode step run the recurrence, which has no kernel."""
    srv, n_params = build_rwkv_server("interleaved")
    prompts = rwkv_prompts(srv.cfg.vocab_size)
    L = srv.cfg.n_layers
    multi = sum(len(p) >= 2 for p in prompts)
    check(multi == len(prompts) - 1, "R1 needs exactly one 1-token prompt")
    label = "R1 (rwkv6-3b, interleaved)"
    outs, counts, steps, wall, tokens = serve(label, srv, prompts)
    check(counts["admits"] == len(prompts)
          and counts["prefill_chunks"] == len(prompts)
          and counts["B5"] == L * multi
          and all(counts[k] == 0 for k in ("B1", "B2", "B3", "B4")),
          f"{label}: launches {counts} != (B5 {L} x {multi} admits of >= 2 "
          "tokens, B1-B4 0, one chunk per admit)")
    lp_err, gap = teacher_forced_check("R1 interleaved", srv, outs)
    params = srv.params
    del srv
    splice, _ = build_rwkv_server("splice", params=params)
    s_outs, s_counts, s_steps, s_wall, _ = serve(
        "R1 on the splice scheduler", splice, prompts)
    same = sum(a.token_ids == b.token_ids for a, b in zip(outs, s_outs))
    print(f"check R1: {same} of {len(prompts)} requests served the same "
          f"greedy tokens on the interleaved and the splice scheduler")
    check(same == len(prompts) and s_counts["B5"] == L * multi
          and all(s_counts[k] == 0 for k in ("B1", "B2", "B3", "B4")),
          f"R1 splice: {same} of {len(prompts)} same tokens, launches "
          f"{s_counts}")
    s_lp_err, s_gap = teacher_forced_check("R1 splice", splice, s_outs)
    return {"launches": counts["B5"], "admits": counts["admits"],
            "admits_multi_token": multi, "params": n_params,
            "decode_steps": steps, "wall_s": wall, "tokens": tokens,
            "logprob_err": lp_err, "logit_gap": gap,
            "splice_launches": s_counts["B5"], "splice_decode_steps": s_steps,
            "splice_wall_s": s_wall, "splice_logprob_err": s_lp_err,
            "splice_logit_gap": s_gap,
            "splice_decode_stall_tokens": splice.stats["decode_stall_tokens"]}


# ---------------------------------------------------------------------------
# phases 13-15: the design-space deployment (KVNAND-D) and speculation
# ---------------------------------------------------------------------------

# the head shapes of the head-range sweep: llama2-7b (MHA, the model the
# DSE picks the discrete variant for) and llama3.1-8b (GQA)
HEAD_RANGE_SHAPES = ((32, 1, 128), (8, 4, 128))
# the row sets of the sweep: (label, B, NP, lengths, partitions, a row
# with unwritten pages (stripe), a row of at most one page whose table
# entries past it are stale (shared), an all-masked row).  Phase 2's rows (ragged over 32 pages, a one-token row), and D1's
# launch shape: 4 slots x 8 pages of 16 tokens (the pool at max_context
# 128), ragged as D1's requests are, where `choose_split` gives one
# group's grid of B CTAs a cluster split S = 4 at P=1 (2 at P=2) and the
# all-heads launch S = 1
HEAD_RANGE_ROWS = (
    ("phase-2 rows", 5, 32, (512, 300, 1, 400, 0), (1, 16), 3, 2, 4),
    ("D1 rows", 4, 8, (128, 76, 9, 0), (1, 2), 1, 2, 3),
)
# one head group's launches against one all-heads launch of the same
# kernel: both compute in float32, and the host may pick another cluster
# split for a grid of B CTAs than for B·K (`choose_split`), so the two
# agree to float32 summation order, not bitwise
HEAD_RANGE_TOL = 2e-5
LLAMA2_CTX = 128         # --max-context at which the DSE picks KVNAND-D


def head_range_phase() -> dict:
    """B1 and B2 walking one head group at a time, as the discrete
    variant launches them: B1 reads group i's heads of the whole stripe
    pool in place (`head0`), B2 takes the group's slice of the shared
    pool (a contiguous view).  {f32, bf16, kv8, kv4} x window {None, 64}
    x (K, G, dh) in HEAD_RANGE_SHAPES x the row sets of HEAD_RANGE_ROWS,
    each at its partitions (ragged rows, a one-token or short row,
    unwritten pages, an all-masked row).  Each group against its plain
    version (TOL; a bf16 pool also within TOL["f32"] of the plain version
    on the pools upcast), and the K groups side by side against one
    all-heads launch within HEAD_RANGE_TOL.  Returns max |o - plain o|
    per kernel."""
    import itertools
    import torch
    from repro_torch.kernels.paged_attention import (
        choose_split, paged_attention_partial)
    gen = torch.Generator(device="cuda").manual_seed(11)
    T = 16
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    worst = {"B1": 0.0, "B2": 0.0}
    worst_cat = 0.0
    n = 0
    for rows_set, layout, (K, G, dh), fmt, window in itertools.product(
            HEAD_RANGE_ROWS, ("stripe", "shared"), HEAD_RANGE_SHAPES,
            ("f32", "bf16", "kv8", "kv4"), (None, 64)):
        rows_label, B, NP, lengths, parts, unwritten, alias, empty = rows_set
        kvq = kv_quant_of(fmt)
        shared = layout == "shared"
        table = None
        if shared:
            q, kp, vp, table, base, length, ks, vs = make_shared_inputs(
                B, K, G, NP, T, dh, fmt, list(lengths), gen, B * NP + 40,
                alias_row=alias)
        else:
            q, kp, vp, base, length, ks, vs = make_inputs(
                B, K, G, NP, T, dh, fmt, list(lengths), gen,
                unwritten_row=unwritten)
        ax = 0 if shared else 1
        name = "B2" if shared else "B1"
        for P in parts:
            kw = dict(window=window, kv_quant=kvq, page_table=table,
                      partitions=P)
            compact = paged_attention_partial(q, kp, vp, base, length,
                                              k_scale=ks, v_scale=vs, **kw)
            groups = [paged_attention_partial(
                q[:, i * G:(i + 1) * G].contiguous(), kp, vp, base, length,
                k_scale=ks, v_scale=vs, kv_heads=(i, 1), **kw)
                for i in range(K)]
            torch.cuda.synchronize()
            splits = (choose_split(B * P, NP // P * T, sms),
                      choose_split(B * K * P, NP // P * T, sms))
            label = (f"{name} head range {rows_label} K={K} G={G} dh={dh} "
                     f"{fmt:4s} P={P:2d} window={window} S={splits[0]} "
                     f"(all heads S={splits[1]})")
            err, err32, abs_o = hold_groups(
                label, groups, q, kp, vp, ks, vs, table, base, length,
                window, kvq, fmt, G, ax, empty)
            cat = [torch.cat([g[j] for g in groups], dim=1)
                   for j in range(3)]
            err_cat = max(close_err(a, b, HEAD_RANGE_TOL)
                          for a, b in zip(cat, compact))
            print(f"{label}: {K} groups vs plain rel_err={err:.3e} (tol "
                  f"{TOL[fmt]:.0e})"
                  + (f", vs plain on f32-upcast pools {err32:.3e}"
                     if fmt == "bf16" else "")
                  + f", max_abs_err(o)={abs_o:.3e}; groups side by side vs "
                  f"one all-heads launch rel_err={err_cat:.3e} (tol "
                  f"{HEAD_RANGE_TOL:.0e})")
            check(err <= TOL[fmt], f"{label}: a group disagrees with its "
                  f"plain version: {err:.3e}")
            check(err32 <= TOL["f32"], f"{label}: bf16 group disagrees "
                  f"with its own arithmetic: {err32:.3e}")
            check(err_cat <= HEAD_RANGE_TOL, f"{label}: the groups disagree "
                  f"with the all-heads launch: {err_cat:.3e}")
            worst[name] = max(worst[name], abs_o)
            worst_cat = max(worst_cat, err_cat)
            n += 1
    print(f"head-range phase: {n} cases within tolerance, max_abs_err(o) "
          f"B1 {worst['B1']:.3e}, B2 {worst['B2']:.3e}; groups vs all "
          f"heads rel_err {worst_cat:.3e}")
    return {**worst, "groups_vs_all_heads": worst_cat, "cases": n}


def hold_groups(label, groups, q, kp, vp, ks, vs, table, base, length,
                window, kvq, fmt, G, ax, empty):
    """Each group's partials against the plain version on the group's
    slice of the pool (and, for a bf16 pool, on the slice upcast to f32);
    finite, and the all-masked row `empty` o=0, m=-1e30, l=0.  Returns
    (rel_err, rel_err on the upcast pools, max |o - plain o|)."""
    import torch
    from repro_torch.kernels.paged_attention import (
        paged_attention_partial_ref, paged_attention_shared_ref)

    def plain(i, kp_, vp_, **k_):
        qi = q[:, i * G:(i + 1) * G]
        kpi, vpi = kp_.narrow(ax, i, 1), vp_.narrow(ax, i, 1)
        if table is not None:
            return paged_attention_shared_ref(
                qi, kpi, vpi, table, base, length, window=window, **k_)
        return paged_attention_partial_ref(qi, kpi, vpi, base, length,
                                           window=window, **k_)

    err = err32 = abs_o = 0.0
    for i, got in enumerate(groups):
        sc = {} if ks is None else dict(
            k_scale=ks.narrow(ax, i, 1), v_scale=vs.narrow(ax, i, 1))
        want = plain(i, kp, vp, kv_quant=kvq, **sc)
        err = max(err, max(close_err(a, b, TOL[fmt])
                           for a, b in zip(got, want)))
        if fmt == "bf16":
            want32 = plain(i, kp.float(), vp.float())
            err32 = max(err32, max(close_err(a, b, TOL["f32"])
                                   for a, b in zip(got, want32)))
        abs_o = max(abs_o, float((got[0] - want[0]).abs().max()))
        o, m, l = got
        check(bool(torch.isfinite(o).all() and torch.isfinite(m).all()
                   and torch.isfinite(l).all()),
              f"{label}: group {i} output not finite")
        check(bool((o[empty] == 0).all() and (l[empty] == 0).all()
                   and (m[empty] == -1e30).all()),
              f"{label}: group {i}: all-masked row is not o=0, m=-1e30, "
              "l=0")
    return err, err32, abs_o


def group_timing_phase(rate):
    """B1 and B2 at the discrete variant's launch shape in D1: one head
    group (kv head 31 of llama2-7b's 32, dh 128) of a kv8 pool of 4 slots
    x 128 tokens, beside one all-heads launch over the same pool (the
    compact variant's launch; a decode step launches 32 of the first per
    layer, or one of the second).  The group is first held against its
    plain version (TOL) and the all-heads launch's head (HEAD_RANGE_TOL)
    on the timed inputs.  Plain = the plain version on the
    group's pool slice; library = SDPA on the group's K/V dequantized to
    bf16 beforehand.  Bound = the group's kv8 codes and scales, q, the
    partials and base/length (and the table) at the card's HBM rate."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.paged_attention import (
        gather_table_pages, paged_attention_cuda, paged_attention_partial_ref,
        paged_attention_shared_cuda, paged_attention_shared_ref)
    gen = torch.Generator(device="cuda").manual_seed(12)
    flush = torch.empty(64 * 2 ** 20, dtype=torch.float32, device="cuda")
    B, K, G, dh, T = 4, 32, 1, 128, 16
    NP = LLAMA2_CTX // T
    h = K - 1
    lengths = [LLAMA2_CTX] * B
    rows = []
    for layout in ("stripe", "shared"):
        shared = layout == "shared"
        if shared:
            q, kp, vp, table, base, length, ks, vs = make_shared_inputs(
                B, K, G, NP, T, dh, "kv8", lengths, gen, B * NP)
        else:
            q, kp, vp, base, length, ks, vs = make_inputs(
                B, K, G, NP, T, dh, "kv8", lengths, gen)
        ax = 0 if shared else 1
        q4 = q.reshape(B, K, G, dh).contiguous()
        qg = q4[:, h:h + 1].contiguous()
        kv = dict(kv_quant="kv8")
        gk, gv = kp.narrow(ax, h, 1), vp.narrow(ax, h, 1)
        gks, gvs = ks.narrow(ax, h, 1), vs.narrow(ax, h, 1)
        if shared:
            group = functools.partial(
                paged_attention_shared_cuda, qg, gk, gv, table, base, length,
                k_scale=gks, v_scale=gvs, **kv)
            allh = functools.partial(
                paged_attention_shared_cuda, q4, kp, vp, table, base, length,
                k_scale=ks, v_scale=vs, **kv)
            plain = functools.partial(
                paged_attention_shared_ref, q[:, h:h + 1], gk, gv, table,
                base, length, k_scale=gks, v_scale=gvs, **kv)
            kd = gather_table_pages(gk, table).float() * gather_table_pages(
                gks, table)[..., None, None]
            vd = gather_table_pages(gv, table).float() * gather_table_pages(
                gvs, table)[..., None, None]
            kd, vd = kd.to(torch.bfloat16), vd.to(torch.bfloat16)
        else:
            group = functools.partial(
                paged_attention_cuda, qg, kp, vp, base, length, k_scale=ks,
                v_scale=vs, head0=h, **kv)
            allh = functools.partial(
                paged_attention_cuda, q4, kp, vp, base, length, k_scale=ks,
                v_scale=vs, **kv)
            plain = functools.partial(
                paged_attention_partial_ref, q[:, h:h + 1], gk, gv, base,
                length, k_scale=gks, v_scale=gvs, **kv)
            kd = (gk.float() * gks[..., None, None]).to(torch.bfloat16)
            vd = (gv.float() * gvs[..., None, None]).to(torch.bfloat16)
        qc, kc, vc = sdpa_operands(q[:, h:h + 1], kd, vd, B, 1, G, NP, T,
                                   dh, LLAMA2_CTX)
        got, want, every = group(), plain(), allh()
        err = max(close_err(a.reshape(b.shape), b, TOL["kv8"])
                  for a, b in zip(got, want))
        err_all = max(close_err(a, b[:, h:h + 1], HEAD_RANGE_TOL)
                      for a, b in zip(got, every))
        label = f"timing {'B2' if shared else 'B1'} group"
        print(f"{label}: kv head {h} vs plain rel_err={err:.3e} (tol "
              f"{TOL['kv8']:.0e}), vs the all-heads launch's head {h} "
              f"rel_err={err_all:.3e} (tol {HEAD_RANGE_TOL:.0e})")
        check(err <= TOL["kv8"], f"{label}: disagrees with its plain "
              f"version: {err:.3e}")
        check(err_all <= HEAD_RANGE_TOL, f"{label}: disagrees with the "
              f"all-heads launch: {err_all:.3e}")
        times = {
            "ms": time_ms(group, 20, flush),
            "ms_all_heads": time_ms(allh, 20, flush),
            "plain_ms": time_ms(plain, 5, flush),
            "library_ms": time_ms(
                lambda: F.scaled_dot_product_attention(qc, kc, vc), 20,
                flush),
        }
        valid = sum(lengths)
        nbytes = (valid * dh * 2 + B * NP * 2 * 4 + B * G * dh * 4
                  + B * G * (dh + 2) * 4 + B * NP * 4 + B * 4
                  + (B * NP * 4 if shared else 0))
        flops = 4 * valid * G * dh
        t_bytes, t_ops = nbytes / rate * 1e3, flops / F32_FLOPS * 1e3
        res = {"shape": f"{'B2' if shared else 'B1'} discrete group "
               "(llama2-7b D1: 1 of 32 kv heads, dh 128, kv8, B=4 x 128 "
               "tokens)", "B": B, "K": 1, "K_pool": K, "G": G, "dh": dh,
               "T": T, "NP": NP, "tokens": lengths, "partitions": 1,
               "pool": "kv8", "bytes": nbytes, "flops": flops,
               "bound_ms": max(t_bytes, t_ops),
               "bound_by": "bytes" if t_bytes >= t_ops else "operations"}
        for key, t in times.items():
            res[key] = statistics.median(t)
            res[f"{key}_min_max"] = [t[0], t[-1]]
        print(f"timing {res['shape']}: "
              + " ".join(f"{k}={res[k]:.6f}" for k in times)
              + f" bound_ms={res['bound_ms']:.6f} ({res['bound_by']}); 32 "
              f"group launches {32 * res['ms']:.6f} ms vs one all-heads "
              f"launch {res['ms_all_heads']:.6f} ms")
        rows.append(res)
    return rows


def llama2_prompts(V, seed=4):
    """6 prompts of 5-60 tokens; the last repeats a 6-token segment, so
    prompt-lookup drafts have something to match."""
    import numpy as np
    rng = np.random.default_rng(seed)
    seg = rng.integers(0, V, 6).tolist()
    rep = rng.integers(0, V, 6).tolist() + seg * 9
    return [rng.integers(0, V, n).tolist() for n in (5, 17, 29, 41, 60)] + [
        rep]


def build_llama2_server(params=None, speculation_k=None, **over):
    """Full-width llama2-7b on the card under the design-space search's
    pick at max_context LLAMA2_CTX, with `launch/serve.py --use-dse`'s
    overrides (page_tokens 16, ragged appends, float weights) and `over`;
    random float32 weights from seed 0, or `params`."""
    import torch
    from repro_torch.configs import EngineConfig
    from repro_torch.core.dse import recommend_engine_config
    from repro_torch.serving.api import KVNANDServer, ServerConfig
    t0 = time.perf_counter()
    pick = recommend_engine_config("llama2-7b", LLAMA2_CTX)
    check(pick.variant == "discrete" and pick.kv_quant == "kv8",
          f"the DSE's llama2-7b pick at {LLAMA2_CTX} is not discrete + kv8:"
          f" {pick}")
    eng = EngineConfig(**{**pick.__dict__, "page_tokens": 16,
                          "uniform_lengths": False, "quant": "none",
                          **over})
    srv = KVNANDServer(ServerConfig(
        arch="llama2-7b", reduced=False, engine=eng, batch_slots=4,
        max_context=LLAMA2_CTX, prefill_chunk_tokens=64, device="cuda",
        speculation_k=speculation_k), params=params)
    cfg = srv.cfg
    check(cfg.n_layers == 32 and cfg.d_model == 4096 and cfg.n_heads == 32
          and cfg.n_kv_heads == 32 and cfg.d_head == 128
          and cfg.d_ff == 11008, "not the full-width llama2-7b")
    check(srv._batcher.cache.k_pages_g.dtype == torch.int8,
          "the KV pool is not kv8")
    torch.cuda.synchronize()
    n = sum(t.numel() for t in _leaves(srv.params))
    print(f"server: built {cfg.name} ({n / 1e9:.3f}B params, "
          f"{4 * n / 1e9:.1f} GB float32, {eng}, speculation_k="
          f"{srv._batcher.spec_k}) on the card in "
          f"{time.perf_counter() - t0:.2f} s")
    return srv


def dse_server_phase():
    """D1: full-width llama2-7b under the DSE's KVNAND-D pick (discrete,
    kv8), stripe pool: B1 launches = decode steps x 32 layers x 32 head
    groups, B2-B5 0.  The same prompts on the same params with the
    compact variant (one B1 launch a layer): greedy tokens equal, or, at
    a request's first differing token, a near-tie: the two runs condition
    on the same tokens there, each served its own argmax, and the gap
    between the two tokens' logprobs (what separates them in the
    discrete run's logits, to the runs' float32 summation order) is
    within LOGIT_GAP_TOL; served logprobs before it within LOGPROB_TOL.
    Then the shared pool (B2 launches = decode steps x 32 x 32, B1 0,
    the allocator's invariants after the drain).  Returns the results,
    the params and the stripe run's outputs (V1 serves against them)."""
    srv = build_llama2_server()
    cfg = srv.cfg
    L, K = cfg.n_layers, cfg.n_kv_heads
    prompts = llama2_prompts(cfg.vocab_size)
    label = "D1 (llama2-7b, KVNAND-D, stripe, kv8)"
    outs, counts, steps, wall, tokens = serve(label, srv, prompts)
    check(steps > 0 and counts["B1"] == steps * L * K
          and all(counts[k] == 0 for k in ("B2", "B3", "B4", "B5")),
          f"{label}: launches {counts} != (B1 decode steps {steps} x {L} x "
          f"{K}, B2-B5 0)")
    params = srv.params
    del srv
    comp = build_llama2_server(params, variant="compact", hg_pipeline=False)
    c_outs, c_counts, c_steps, c_wall, _ = serve(
        "D1 compact (same prompts, one launch a layer)", comp, prompts)
    check(c_counts["B1"] == c_steps * L and c_counts["B2"] == 0,
          f"D1 compact: launches {c_counts} != (decode steps {c_steps} x "
          f"{L}, 0)")
    del comp
    _, same, rows = compare_runs(outs, c_outs)
    lp_err = max(before for _, before, _ in rows)
    gap_max = max((at for n, _, at in rows if n is not None), default=0.0)
    for o, c, (n, _, at) in zip(outs, c_outs, rows):
        if n is not None:
            print(f"check D1: request {o.uid} differs at token {n}: "
                  f"discrete {o.token_ids[n]}, compact {c.token_ids[n]}, "
                  f"logprob gap {at:.3e}")
    print(f"check D1: {same} of {len(prompts)} requests served the same "
          f"greedy tokens as the compact variant; max |logprob difference| "
          f"before a divergence {lp_err:.3e} (tol {LOGPROB_TOL:.0e}); max "
          f"gap at a divergence {gap_max:.3e} (tol {LOGIT_GAP_TOL:.0e})")
    check(lp_err <= LOGPROB_TOL, "D1: discrete and compact logprobs "
          "disagree")
    check(gap_max <= LOGIT_GAP_TOL, "D1: discrete and compact served "
          "different tokens where neither is a near-tie")
    sh = build_llama2_server(params, shared_pool=True)
    s_label = "D1 shared (llama2-7b, KVNAND-D, shared pool, kv8)"
    s_outs, s_counts, s_steps, s_wall, s_tokens = serve(s_label, sh, prompts)
    check(s_steps > 0 and s_counts["B2"] == s_steps * L * K
          and all(s_counts[k] == 0 for k in ("B1", "B3", "B4", "B5")),
          f"{s_label}: launches {s_counts} != (B2 decode steps {s_steps} x "
          f"{L} x {K}, B1/B3-B5 0)")
    b = sh._batcher
    b.alloc.check()
    check(b.alloc.live_count == b.prefix_cache.evictable_pages(),
          "D1 shared: pages still mapped after the drain")
    s_same = sum(a.token_ids == c.token_ids for a, c in zip(outs, s_outs))
    print(f"D1 shared: {s_same} of {len(prompts)} requests served the "
          "stripe run's tokens")
    del sh
    return ({"launches_B1": counts["B1"], "decode_steps": steps,
             "wall_s": wall, "tokens": tokens,
             "compact_launches_B1": c_counts["B1"],
             "compact_decode_steps": c_steps, "compact_wall_s": c_wall,
             "same_as_compact": same, "logprob_err_vs_compact": lp_err,
             "max_gap_at_divergence": gap_max,
             "shared_launches_B2": s_counts["B2"],
             "shared_decode_steps": s_steps, "shared_wall_s": s_wall,
             "shared_same_as_stripe": s_same}, params, prompts, outs)


def spec_server_phase(params, prompts, d1_outs):
    """V1: D1's deployment with speculation_k = 4: every decode step a
    prompt-lookup draft-and-verify step (the verify forward's past
    partial is plain torch, as in the reference; a step where no slot
    may draft runs the discrete decode step, B1 = those steps x 32 x 32).
    Served tokens must equal D1's sequential ones, and a verify step must
    have run."""
    srv = build_llama2_server(params, speculation_k=4)
    cfg = srv.cfg
    L, K = cfg.n_layers, cfg.n_kv_heads
    st = srv.stats
    v0 = st["verify_steps"]
    label = "V1 (llama2-7b, KVNAND-D, kv8, speculation_k=4)"
    outs, counts, steps, wall, tokens = serve(label, srv, prompts)
    verify = st["verify_steps"] - v0
    same = sum(a.token_ids == b.token_ids for a, b in zip(outs, d1_outs))
    print(f"V1: {verify} verify steps, {steps} sequential decode steps; "
          f"spec_steps={st['spec_steps']} spec_drafted={st['spec_drafted']} "
          f"spec_accepted={st['spec_accepted']}; {same} of {len(prompts)} "
          "requests served D1's sequential tokens")
    lp_err, _, rows = compare_runs(outs, d1_outs)
    for o, d, (n, _, at) in zip(outs, d1_outs, rows):
        if n is not None:
            print(f"check V1: request {o.uid} differs at token {n}: "
                  f"speculative {o.token_ids[n]}, sequential "
                  f"{d.token_ids[n]}, logprob gap {at:.3e}")
    print(f"V1: max |served logprob - D1's| {lp_err:.3e}")
    check(verify > 0, "V1: no verify step ran")
    check(counts["B1"] == steps * L * K
          and all(counts[k] == 0 for k in ("B2", "B3", "B4", "B5")),
          f"{label}: launches {counts} != (B1 decode steps {steps} x {L} x "
          f"{K}, B2-B5 0)")
    check(same == len(prompts), "V1: speculative tokens differ from "
          "sequential ones")
    return {"verify_steps": verify, "decode_steps": steps,
            "launches_B1": counts["B1"], "wall_s": wall, "tokens": tokens,
            "spec_steps": st["spec_steps"],
            "spec_drafted": st["spec_drafted"],
            "spec_accepted": st["spec_accepted"],
            "same_as_sequential": same, "logprob_err_vs_sequential": lp_err}


# prompt seeds of the verify A/B (4 is D1's and V1's)
VERIFY_AB_SEEDS = (4, 5, 6, 7)


def reference_span_attention(engine):
    """The reference's verify attention over a kv8/kv4 pool
    (`src/repro/core/engine.py:652-673`), for `engine`: a causal in-span
    partial over the span's own K/V in full precision, merged with the
    past partial over the slot's pages up to `lengths`.  Takes the place
    of the port's `_span_quant_attention` in the verify A/B only."""
    import torch
    from repro_torch.core import seqpar
    from repro_torch.kernels.paged_attention import paged_chunk_attention
    eng = engine.eng

    def attend(q, k, v, kp, vp, ks, vs, base, page_table, lengths,
               positions):
        span = seqpar._attn_block_partial(
            q, k, v, torch.arange(q.shape[1], device=q.device), 0,
            causal=True, window=None, scale=engine.cfg.d_head ** -0.5)
        past = paged_chunk_attention(
            q, kp, vp, base, lengths, positions, kv_quant=eng.kv_quant,
            k_scale=ks, v_scale=vs,
            page_table=page_table if eng.shared_pool else None,
            partitions=eng.attn_partitions)
        return seqpar.merge_two(*span, *past)
    return attend


def timed_verify(engine, times: list):
    """Wrap `engine.verify_step` so that each call's host wall, the card
    synchronized before and after, lands in `times`."""
    import torch
    inner = engine.verify_step

    def run(*a, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = inner(*a, **kw)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        return out
    engine.verify_step = run


def verify_ab_phase() -> dict:
    """V1's verify attention over the kv8 pool in two forms, on D1's
    deployment and the prompt sets of VERIFY_AB_SEEDS: the port's (the
    span's pages as the requantizing appends leave them,
    `_span_quant_attention`) and the reference's
    (`reference_span_attention`).  Per form and seed: the requests that
    serve D1's sequential tokens for the same prompts, each first
    differing token with its logprob gap, the spec counters, and the
    median host wall of a verify step.  Only the port's form is checked
    (its tokens must equal the sequential ones, as V1 holds them); the
    reference form's are reported."""
    import torch
    seq = build_llama2_server()
    params = seq.params
    forms = {"port": build_llama2_server(params, speculation_k=4),
             "reference": build_llama2_server(params, speculation_k=4)}
    eng = forms["reference"]._batcher.engine
    eng._span_quant_attention = reference_span_attention(eng)
    times = {f: [] for f in forms}
    for f, srv in forms.items():
        timed_verify(srv._batcher.engine, times[f])
    res = {f: {"same": 0, "requests": 0, "divergences": [],
               "verify_steps": 0, "spec_drafted": 0, "spec_accepted": 0}
           for f in forms}
    for seed in VERIFY_AB_SEEDS:
        prompts = llama2_prompts(seq.cfg.vocab_size, seed)
        want, *_ = serve(f"verify A/B seed {seed}: sequential", seq,
                         prompts)
        for f, srv in forms.items():
            st = dict(srv.stats)
            outs, *_ = serve(f"verify A/B seed {seed}: {f} form", srv,
                             prompts)
            _, same, rows = compare_runs(outs, want)
            r = res[f]
            r["same"] += same
            r["requests"] += len(prompts)
            for key in ("verify_steps", "spec_drafted", "spec_accepted"):
                r[key] += srv.stats[key] - st[key]
            for o, w, (n, _, at) in zip(outs, want, rows):
                if n is not None:
                    print(f"verify A/B seed {seed}: {f} form: request "
                          f"{o.uid} differs at token {n}: speculative "
                          f"{o.token_ids[n]}, sequential {w.token_ids[n]}, "
                          f"logprob gap {at:.3e}")
                    r["divergences"].append({"seed": seed, "request": o.uid,
                                             "token": n, "gap": at})
    for f, r in res.items():
        t = sorted(times[f])
        r["verify_ms_median"] = 1e3 * statistics.median(t)
        r["verify_ms_min_max"] = [1e3 * t[0], 1e3 * t[-1]]
        print(f"verify A/B {f} form: {r['same']} of {r['requests']} requests "
              f"served the sequential tokens; {r['verify_steps']} verify "
              f"steps, median {r['verify_ms_median']:.3f} ms (min "
              f"{r['verify_ms_min_max'][0]:.3f}, max "
              f"{r['verify_ms_min_max'][1]:.3f}); {r['spec_accepted']} of "
              f"{r['spec_drafted']} drafts accepted")
    check(res["port"]["same"] == res["port"]["requests"],
          "verify A/B: the port's form served other tokens than sequential "
          "decode")
    del seq, forms
    torch.cuda.empty_cache()
    return res


# ---------------------------------------------------------------------------
# phase 16: G1, full-width gemma3-12b over window rings
# ---------------------------------------------------------------------------

GEMMA_CTX = 2048         # --max-context at which the DSE picks kv8 pages
GEMMA_NEW = 24           # new tokens a request
# the prompts: the 1100-token one wraps the 1040-token ring in prefill, the
# 1030-token one in decode (1030 + 24 > 1040)
GEMMA_PROMPT_LENS = (5, 17, 40, 60, 1030, 1100)
# kv8 pages written through two kernels (B1 / B2 split their walks
# differently, so the K/V they feed later layers differ in the last bits)
# round some codes apart, so two sound runs may part at a near tie: the two
# tokens' logprobs there within KV8_GAP_TOL (kv8's serving tolerance,
# tests/test_torch_quant_server.py), served logprobs before it within
# LOGPROB_TOL
KV8_GAP_TOL = 1e-2


def gemma_prompts(V):
    import numpy as np
    rng = np.random.default_rng(6)
    return [rng.integers(0, V, n).tolist() for n in GEMMA_PROMPT_LENS]


def gemma_params():
    """Full-width gemma3-12b's random float32 weights on the card, seed 0
    (what `KVNANDServer` draws when it is given none)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models.registry import Model
    cfg = get_config("gemma3-12b")
    check(cfg.n_layers == 48 and cfg.d_model == 3840 and cfg.n_heads == 16
          and cfg.n_kv_heads == 8 and cfg.d_head == 256
          and cfg.d_ff == 15360 and cfg.window == 1024
          and cfg.global_every == 6 and cfg.vocab_size == 262144,
          "not the full-width gemma3-12b")
    t0 = time.perf_counter()
    params = Model(cfg).init(torch.Generator(device="cuda").manual_seed(0))
    torch.cuda.synchronize()
    n = sum(t.numel() for t in _leaves(params))
    print(f"G1: {cfg.name} weights, {n / 1e9:.3f}B params ({4 * n / 1e9:.1f}"
          f" GB float32), drawn on the card in {time.perf_counter() - t0:.2f}"
          " s")
    return cfg, params


def gemma_engine_config(**over):
    """The design-space search's pick at GEMMA_CTX (asserted: compact,
    kv8) with `launch/serve.py --use-dse`'s overrides and `over`."""
    from repro_torch.configs import EngineConfig
    from repro_torch.core.dse import recommend_engine_config
    pick = recommend_engine_config("gemma3-12b", GEMMA_CTX)
    check(pick.variant == "compact" and pick.kv_quant == "kv8",
          f"the DSE's gemma3-12b pick at {GEMMA_CTX} is not compact + kv8: "
          f"{pick}")
    return EngineConfig(**{**pick.__dict__, "page_tokens": 16,
                           "uniform_lengths": False, "quant": "none",
                           **over})


def build_gemma_server(cfg, params, scheduler="interleaved",
                       speculation_k=None, **over):
    import torch
    from repro_torch.serving.api import KVNANDServer, ServerConfig
    eng = gemma_engine_config(**over)
    srv = KVNANDServer(ServerConfig(
        arch="gemma3-12b", engine=eng, scheduler=scheduler, batch_slots=4,
        max_context=GEMMA_CTX, prefill_chunk_tokens=64, device="cuda",
        speculation_k=speculation_k), cfg=cfg, params=params)
    c = srv._batcher.cache
    check(c.k_pages_w.dtype == torch.int8 and c.k_pages_g.dtype == torch.int8
          and c.page_pos_w.shape[1] * 16 == ring_tokens(cfg),
          "G1: the pools are not kv8 pages with the window's ring")
    return srv


def ring_tokens(cfg) -> int:
    """Tokens a ring of 16-token pages holds: (ceil(window / 16) + 1) x
    16, 1040 for gemma3-12b's window of 1024."""
    return (-(-cfg.window // 16) + 1) * 16


def window_kernel_phase(cfg) -> dict:
    """B1, B2 and B4 at the shapes G1's main path gives them, held against
    their plain versions before G1 serves: the decode step's ring (4
    slots x 8 kv heads x 2 queries x dh 256, 65 pages of 16, the bases a
    ring leaves after 28, 83, 1053 and 1123 tokens: rotated, -1e9 where
    empty; window 1024) and global pool (128 pages) in kv8 and f32, B2's
    through permuted tables of a larger pool; and the splice admit's
    one-shot prefill (2047-token bucket, 16 heads / 8 kv x 256, f32) with
    the local layers' window and without.  Returns each kernel's max
    |o - plain o|."""
    import torch
    from repro_torch.core import paged_kv
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import paged_attention as pa
    gen = torch.Generator(device="cuda").manual_seed(21)
    lengths = (28, 83, 1053, 1123)
    B, K, G, dh, T = len(lengths), cfg.n_kv_heads, cfg.group_size, \
        cfg.d_head, 16
    NPw = ring_tokens(cfg) // T
    errs = {"B1": 0.0, "B2": 0.0, "B4": 0.0}
    length = torch.tensor(lengths, dtype=torch.int32, device="cuda")
    ring = torch.stack([torch.as_tensor(paged_kv.window_page_positions(
        n, NPw, T)) for n in lengths]).cuda()
    for pool, NP, base, window in (
            ("ring", NPw, ring, cfg.window),
            ("global", GEMMA_CTX // T, None, None)):
        if base is None:
            base = (torch.arange(NP, dtype=torch.int32, device="cuda")
                    * T)[None].repeat(B, 1)
        for fmt in ("kv8", "f32"):
            q, kp, vp, _, _, ks, vs = make_inputs(B, K, G, NP, T, dh, fmt,
                                                  lengths, gen)
            kvq = kv_quant_of(fmt)
            kw = dict(window=window, kv_quant=kvq, k_scale=ks, v_scale=vs)
            got = pa.paged_attention_partial(q, kp, vp, base, length, **kw)
            want = pa.paged_attention_partial_ref(q, kp, vp, base, length,
                                                  **kw)
            errs["B1"] = max(errs["B1"], hold_case(
                f"G1 kernels: B1 {pool} {fmt}", got, want, fmt))
            P = B * NP + 7
            perm = torch.randperm(P, generator=torch.Generator().manual_seed(
                NP))[:B * NP]
            table = perm.reshape(B, NP).to(torch.int32).cuda()

            def scatter(x):
                """The stripe pages [B, K, NP, ...] moved to the table's
                physical pages of a shared pool [K, P, ...]."""
                out = x.new_zeros((K, P) + x.shape[3:])
                out[:, table.long()] = x.movedim(1, 0)
                return out
            sp = [None if a is None else scatter(a) for a in (kp, vp, ks, vs)]
            got = pa.paged_attention_partial(
                q, sp[0], sp[1], base, length, window=window, kv_quant=kvq,
                k_scale=sp[2], v_scale=sp[3], page_table=table)
            want = pa.paged_attention_shared_ref(
                q, sp[0], sp[1], table, base, length, window=window,
                kv_quant=kvq, k_scale=sp[2], v_scale=sp[3])
            errs["B2"] = max(errs["B2"], hold_case(
                f"G1 kernels: B2 {pool} {fmt}", got, want, fmt))
    q, k, v = flash_inputs(1, 2047, 2047, cfg.n_heads, K, dh, torch.float32,
                           gen)
    for window in (cfg.window, None):
        got = fa.flash_attention(q, k, v, causal=True, window=window)
        want = fa.flash_attention_ref(q, k, v, causal=True, window=window)
        err = close_err(got, want, FLASH_TOL["f32"])
        abs_o = float((got - want).abs().max())
        print(f"G1 kernels: B4 2047 tokens window {window}: max_abs_err "
              f"{abs_o:.3e} rel_err={err:.3e} tol={FLASH_TOL['f32']:.0e}")
        check(err <= FLASH_TOL["f32"], f"G1 kernels: B4 at window {window} "
              "disagrees with its plain version")
        errs["B4"] = max(errs["B4"], abs_o)
    torch.cuda.synchronize()
    return errs


def window_golden_phase(cfg, params):
    """G1 golden: the 1100-token prompt chunk by chunk (64 tokens) into an
    f32 stripe pool, engine-level, wrapping its ring during prefill, then
    8 greedy decode steps; the logits at every step against the port's
    plain full forward on the card (kernel-free) over the prompt and the
    emitted tokens, within GOLDEN_TOL of max |logits| (the reference's
    tests/test_engine_golden.py), and the same argmax at every step."""
    import torch
    from repro_torch.configs import EngineConfig
    from repro_torch.core.engine import KVNANDEngine
    from repro_torch.kernels.paged_attention import launches
    from repro_torch.models.registry import Model
    t0 = time.perf_counter()
    eng = KVNANDEngine(cfg, EngineConfig(page_tokens=16,
                                         uniform_lengths=False,
                                         kv_dtype="float32"), device="cuda")
    prompt = gemma_prompts(cfg.vocab_size)[-1]
    n, V = len(prompt), cfg.vocab_size
    check(n > ring_tokens(cfg), "G1 golden: the prompt fits the ring")
    cache = eng.init_cache(1, GEMMA_CTX)
    with torch.no_grad():
        for pos in range(0, n, 64):
            cl = min(64, n - pos)
            toks = torch.zeros((1, 64), dtype=torch.long, device="cuda")
            toks[0, :cl] = torch.tensor(prompt[pos:pos + cl])
            lg, _ = eng.prefill_chunk(params, cache, {"tokens": toks}, 0,
                                      pos, cl, first=pos == 0)
        rows, out = [lg[0, :V]], [int(lg[0, :V].argmax())]
        launches.reset()
        for _ in range(8):
            lg, _ = eng.decode_step(params, cache, torch.tensor(
                [[out[-1]]], device="cuda"))
            rows.append(lg[0, :V])
            out.append(int(lg[0, :V].argmax()))
        b1 = launches.value
        ring = cache.page_pos_w[0].tolist()
        got = torch.stack(rows).float()
        full = Model(cfg).forward(params, {"tokens": torch.tensor(
            [prompt + out[:8]], device="cuda")})[0, n - 1:, :V].float()
    torch.cuda.synchronize()
    err = float((got - full).abs().max() / full.abs().max())
    want = full.argmax(-1).tolist()
    wall = time.perf_counter() - t0
    print(f"G1 golden: 1100-token prompt in 64-token chunks + 8 decode "
          f"steps, f32 stripe pool: max |logits - plain forward| / max "
          f"|logits| = {err:.3e} (tol {GOLDEN_TOL:.0e}); argmax {out} vs "
          f"{want}; ring bases after the steps {sorted(ring)[:3]}.."
          f"{sorted(ring)[-2:]}; B1 launches {b1}; {wall:.3f} s")
    check(b1 == 8 * cfg.n_layers, f"G1 golden: B1 launches {b1} != 8 x "
          f"{cfg.n_layers}")
    check(max(ring) >= ring_tokens(cfg) and min(ring) >= 0,
          "G1 golden: the ring did not wrap")
    check(err <= GOLDEN_TOL, "G1 golden: logits disagree with the plain "
          "forward")
    check(out == want, "G1 golden: a greedy token differs from the plain "
          "forward's")
    del eng, cache, full
    torch.cuda.empty_cache()
    return {"rel_err": err, "tokens": out, "launches_B1": b1,
            "wall_s": wall}


def near_tie_check(label, outs, ref_outs, gap_tol, lp_tol=LOGPROB_TOL):
    """Two sound runs of the same prompts: equal tokens, or at a request's
    first differing token a near tie (the two runs condition on the same
    tokens there and the two tokens' logprobs lie within `gap_tol`);
    served logprobs before it within `lp_tol`.  Returns (requests equal,
    max |logprob difference| before a divergence, max gap at one)."""
    _, same, rows = compare_runs(outs, ref_outs)
    before = max(b for _, b, _ in rows)
    gap = max((at for n, _, at in rows if n is not None), default=0.0)
    for o, r, (n, _, at) in zip(outs, ref_outs, rows):
        if n is not None:
            print(f"check {label}: request {o.uid} differs at token {n}: "
                  f"{o.token_ids[n]} vs {r.token_ids[n]}, logprob gap "
                  f"{at:.3e}")
    print(f"check {label}: {same} of {len(outs)} requests equal; max "
          f"|logprob difference| before a divergence {before:.3e} (tol "
          f"{lp_tol:.0e}); max gap at one {gap:.3e} (tol {gap_tol:.0e})")
    check(before <= lp_tol and gap <= gap_tol,
          f"{label}: the runs part where neither is a near tie")
    return same, before, gap


def window_phases() -> dict:
    """Phase 16, G1 (see the module docstring)."""
    import torch
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    cfg, params = gemma_params()
    L, K = cfg.n_layers, cfg.n_kv_heads
    res = {"kernels": window_kernel_phase(cfg),
           "golden": window_golden_phase(cfg, params)}
    prompts = gemma_prompts(cfg.vocab_size)
    runs = {}
    for key, label, kw, kernel in (
            ("stripe", "G1 stripe (DSE pick: compact, kv8)", {}, "B1"),
            ("shared", "G1 shared", {"shared_pool": True}, "B2"),
            ("splice", "G1 splice", {"scheduler": "splice"}, "B1")):
        srv = build_gemma_server(cfg, params, **kw)
        outs, counts, steps, wall, tokens = serve(label, srv, prompts,
                                                  GEMMA_NEW)
        admits = counts["admits"]
        want = {k: 0 for k in ("B1", "B2", "B3", "B4", "B5")}
        want[kernel] = steps * L
        if key == "splice":
            want["B4"] = admits * L
        check(steps > 0 and counts == {**counts, **want},
              f"{label}: launches {counts} != {want} ({steps} decode steps,"
              f" {admits} admits x {L} layers)")
        if key == "shared":
            b = srv._batcher
            b.alloc.check()
            b.alloc_w.check()
            check(b.alloc.live_count == 0 and b.alloc_w.live_count == 0,
                  "G1 shared: pages still mapped after the drain")
        final = [len(o.prompt) + len(o.token_ids) - 1 for o in outs]
        print(f"{label}: final lengths {final} (a ring holds "
              f"{ring_tokens(cfg)} tokens)")
        runs[key] = outs
        res[key] = {"launches": counts[kernel], "decode_steps": steps,
                    "admits": admits, "launches_B4": counts["B4"],
                    "wall_s": wall, "tokens": tokens,
                    "final_lengths": final}
        if key == "stripe":
            lp, _ = teacher_forced_check("G1 stripe (kv8 pages)", srv, outs,
                                         argmax=False, tol=QUANT_LOGPROB_TOL)
            res[key]["logprob_err_vs_plain_forward"] = lp
        del srv
    check(res["stripe"]["final_lengths"][4] > ring_tokens(cfg)
          > GEMMA_PROMPT_LENS[4], "G1: no request wrapped its ring during "
          "decode")
    # the splice run's one-shot prefill attends the prompt's float K/V
    # through B4 where the chunked prefill's past partials read kv8 codes:
    # the two differ by kv8's noise, bounded as Q1/Q2 bound theirs
    for key, tols in (("shared", (KV8_GAP_TOL, LOGPROB_TOL)),
                      ("splice", (QUANT_LOGPROB_TOL, QUANT_LOGPROB_TOL))):
        same, before, gap = near_tie_check(f"G1 {key} vs stripe", runs[key],
                                           runs["stripe"], *tols)
        res[key].update(same_as_stripe=same, logprob_err=before,
                        max_gap_at_divergence=gap)
    disc = build_gemma_server(cfg, params, variant="discrete")
    label = "G1 discrete (KVNAND-D over the ring, stripe)"
    outs, counts, steps, wall, tokens = serve(label, disc, prompts,
                                              GEMMA_NEW)
    check(steps > 0 and counts["B1"] == steps * L * K
          and all(counts[k] == 0 for k in ("B2", "B3", "B4", "B5")),
          f"{label}: launches {counts} != (B1 decode steps {steps} x {L} x "
          f"{K}, B2-B5 0)")
    del disc
    same, before, gap = near_tie_check("G1 discrete vs stripe", outs,
                                       runs["stripe"], LOGIT_GAP_TOL)
    res["discrete"] = {"launches": counts["B1"], "decode_steps": steps,
                       "wall_s": wall, "tokens": tokens,
                       "same_as_stripe": same, "logprob_err": before,
                       "max_gap_at_divergence": gap}
    spec = build_gemma_server(cfg, params, speculation_k=4)
    st = spec.stats
    label = "G1 speculative (speculation_k=4, stripe)"
    outs, counts, steps, wall, tokens = serve(label, spec, prompts,
                                              GEMMA_NEW)
    same = sum(a.token_ids == b.token_ids
               for a, b in zip(outs, runs["stripe"]))
    lp_err, _, _ = compare_runs(outs, runs["stripe"])
    print(f"{label}: {st['verify_steps']} verify steps, {steps} sequential "
          f"decode steps, {st['spec_accepted']} of {st['spec_drafted']} "
          f"drafts accepted; {same} of {len(prompts)} requests served the "
          f"stripe run's tokens, max |logprob difference| {lp_err:.3e}")
    check(st["verify_steps"] > 0 and counts["B1"] == steps * L
          and all(counts[k] == 0 for k in ("B2", "B3", "B4", "B5")),
          f"{label}: launches {counts} != (B1 decode steps {steps} x {L}, "
          "B2-B5 0) or no verify step")
    check(same == len(prompts), "G1 speculative: tokens differ from "
          "sequential decode")
    res["speculative"] = {"verify_steps": st["verify_steps"],
                          "decode_steps": steps, "launches": counts["B1"],
                          "wall_s": wall, "tokens": tokens,
                          "spec_drafted": st["spec_drafted"],
                          "spec_accepted": st["spec_accepted"],
                          "same_as_stripe": same, "logprob_err": lp_err}
    del spec, params
    res["peak_memory_gb"] = torch.cuda.max_memory_allocated() / 1e9
    torch.cuda.empty_cache()
    print(f"G1: peak memory {res['peak_memory_gb']:.2f} GB; walls (s): "
          + ", ".join(f"{k} {v['wall_s']:.3f}" for k, v in res.items()
                      if isinstance(v, dict) and "wall_s" in v)
          + f"; on {smi_line()}")
    return res


def dse_phases(rate) -> dict:
    """Phases 13-15, in the order `--dse` runs them."""
    head = head_range_phase()
    group_rows = group_timing_phase(rate)
    d1, params, prompts, d1_outs = dse_server_phase()
    v1 = spec_server_phase(params, prompts, d1_outs)
    return {"head_range": head, "group_timing": group_rows, "D1": d1,
            "V1": v1}


def kernel_entry(name, source, replaces, launches, max_abs, shapes, server):
    serving = shapes[0]
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches,
            "max_abs_err": max_abs, "ms": serving["ms"],
            "plain_ms": serving["plain_ms"], "bound_ms": serving["bound_ms"],
            "bound_by": serving["bound_by"],
            "library_ms": serving["library_ms"], "shapes": list(shapes),
            "server": server}


def main(argv) -> int:
    import torch
    if (argv not in ([], ["--paged"], ["--paged-timing"], ["--quant-servers"],
                     ["--wkv"], ["--wkv-timing"], ["--gemv"], ["--flash"],
                     ["--flash-timing"], ["--dse"], ["--verify-ab"],
                     ["--window"])
            and not (len(argv) == 2
                     and argv[0] in ("--gemv-ab", "--flash-ab", "--wkv-ab"))):
        print(__doc__, file=sys.stderr)
        return 2
    quant_only = argv == ["--quant-servers"]
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch.kernels import _build
    card = smi_line()
    name = torch.cuda.get_device_name(0)
    rate = hbm_rate(name)
    print(card)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} on {name}")

    t0 = time.perf_counter()
    libs = _build.build()
    print(f"build: {len(libs)} libraries "
          f"({', '.join(p.name for p in libs.values())}) in "
          f"{time.perf_counter() - t0:.2f} s (parallel nvcc)")
    if argv in (["--paged"], ["--paged-timing"]):
        paged = {}
        if argv == ["--paged"]:
            paged.update(B1_max_abs_err=kernel_phase(),
                         B2_max_abs_err=shared_kernel_phase(),
                         split_max_abs_err=split_phase())
        paged["B1"], paged["B2"] = timing_phase(rate)
        print(card)
        print(json.dumps({"paged_attention": paged}))
        return 0
    if argv == ["--gemv"]:
        b3_err = quant_kernel_phase()
        b3_shapes, crossover = quant_timing_phase(rate)
        print(card)
        print(json.dumps({"quant_gemv": {"max_abs_err": b3_err,
                                         "shapes": b3_shapes,
                                         "crossover": crossover}}))
        return 0
    if argv[:1] == ["--gemv-ab"]:
        rows = gemv_ab_phase(argv[1], rate)
        print(card)
        print(json.dumps({"quant_gemv_ab": rows}))
        return 0
    if argv in (["--flash"], ["--flash-timing"]):
        b4_err = flash_kernel_phase() if argv == ["--flash"] else None
        b4_shapes = flash_timing_phase(rate)
        print(card)
        print(json.dumps({"flash_attention": {"max_abs_err": b4_err,
                                              "shapes": list(b4_shapes)}}))
        return 0
    if argv[:1] == ["--flash-ab"]:
        rows = flash_ab_phase(argv[1], rate)
        print(card)
        print(json.dumps({"flash_attention_ab": rows}))
        return 0
    if argv in (["--wkv"], ["--wkv-timing"]):
        b5_err = wkv_kernel_phase() if argv == ["--wkv"] else None
        b5_shapes = wkv_timing_phase(rate)
        print(card)
        print(json.dumps({"wkv6": {"max_abs_err": b5_err,
                                   "shapes": list(b5_shapes)}}))
        return 0
    if argv[:1] == ["--wkv-ab"]:
        rows = wkv_ab_phase(argv[1], rate)
        print(card)
        print(json.dumps({"wkv6_ab": rows}))
        return 0
    if argv == ["--verify-ab"]:
        ab = verify_ab_phase()
        print(card)
        print(json.dumps({"verify_ab": ab}))
        return 0
    if argv == ["--dse"]:
        dse = dse_phases(rate)
        print(card)
        print(json.dumps({"dse": dse}))
        return 0
    if argv == ["--window"]:
        g1 = window_phases()
        print(card)
        print(json.dumps({"window": g1}))
        return 0

    if not quant_only:
        b1_err = kernel_phase()
        b2_err = shared_kernel_phase()
        split_err = split_phase()
        b1_err = max(b1_err, split_err["B1"])
        b2_err = max(b2_err, split_err["B2"])
        b1_shapes, b2_shapes = timing_phase(rate)
        stripe = server_phase()
        shared = shared_server_phase("bfloat16")
        shared32 = shared_server_phase("float32")
        same = sum(x == y for x, y in zip(shared["token_ids"],
                                          shared32["token_ids"]))
        print(f"server (shared): {same} of 6 requests served the same "
              "tokens from the bf16 and the f32 pool")
        for r in (shared, shared32):
            del r["token_ids"]
        b3_err = quant_kernel_phase()
        b3_shapes, b3_crossover = quant_timing_phase(rate)
        b4_err = flash_kernel_phase()
        b4_shapes = flash_timing_phase(rate)
        s1 = splice_server_phase()
        b5_err = wkv_kernel_phase()
        b5_shapes = wkv_timing_phase(rate)
        r1 = rwkv_server_phase()
    q1 = quant_server_phase("Q1 (w4a16, stripe, kv4)", "w4a16", "kv4",
                            False, stripe_prompts)
    q2 = quant_server_phase("Q2 (w8a8, shared, kv8)", "w8a8", "kv8", True,
                            shared_prompts)
    for label, q in (("Q1", q1), ("Q2", q2)):
        check(q["prefill_gap"] <= QUANT_PREFILL_TOL,
              f"{label}: prefill logits disagree with the CPU run: "
              f"{q['prefill_gap']:.3e} > {QUANT_PREFILL_TOL:.0e}")
        check(q["logprob_err"] <= QUANT_LOGPROB_TOL,
              f"{label}: served logprobs disagree with the CPU run: "
              f"{q['logprob_err']:.3e} > {QUANT_LOGPROB_TOL:.0e}")
    if quant_only:
        print(card)
        print(json.dumps({"quant_servers": [q1, q2]}))
        return 0
    dse = dse_phases(rate)
    d1, v1, head = dse["D1"], dse["V1"], dse["head_range"]
    b1_err = max(b1_err, head["B1"])
    b2_err = max(b2_err, head["B2"])
    g1 = window_phases()
    b1_err = max(b1_err, g1["kernels"]["B1"])
    b2_err = max(b2_err, g1["kernels"]["B2"])
    b4_err = max(b4_err, g1["kernels"]["B4"])
    g1_b1 = sum(g1[k]["launches"] for k in ("stripe", "splice", "discrete",
                                            "speculative"))
    g1_b1 += g1["golden"]["launches_B1"]
    kernels = [
        kernel_entry("paged_attention", "src/repro_torch/csrc/"
                     "paged_attention.cu",
                     "src/repro/kernels/paged_attention/kernel.py:311",
                     stripe["launches"] + d1["launches_B1"]
                     + v1["launches_B1"] + g1_b1, b1_err,
                     list(b1_shapes) + dse["group_timing"][:1],
                     [stripe, {"D1": d1, "V1": v1, "G1": g1}]),
        kernel_entry("paged_attention_shared", "src/repro_torch/csrc/"
                     "paged_attention_shared.cu",
                     "src/repro/kernels/paged_attention/kernel.py:209",
                     shared["launches"] + d1["shared_launches_B2"]
                     + g1["shared"]["launches"], b2_err,
                     list(b2_shapes) + dse["group_timing"][1:],
                     [shared, shared32, {"D1 shared": d1,
                                         "G1 shared": g1["shared"]}]),
        kernel_entry("quant_gemv", "src/repro_torch/csrc/quant_gemv.cu",
                     "src/repro/kernels/quant_gemv/kernel.py:68",
                     q1["launches"] + q2["launches"], b3_err, b3_shapes,
                     [q1, q2]) | {
            "design": "tensor-core mma.sync (bf16 / s8) with the weights "
                      "dequantized into the A operand; stream path (M <= "
                      "STREAM_MAX_M, 8 or 16 rows a CTA) and tile path (64 "
                      "rows) over a 4-stage cp.async ring; ordered split-D "
                      "sum", "crossover": b3_crossover},
        kernel_entry("flash_attention",
                     "src/repro_torch/csrc/flash_attention.cu",
                     "src/repro/kernels/flash_attention/kernel.py:82",
                     s1["launches"] + g1["splice"]["launches_B4"], b4_err,
                     b4_shapes, [s1, {"G1 splice": g1["splice"]}]) | {
            "bound_cuda_core_ms": b4_shapes[0]["bound_cuda_core_ms"],
            "design": "f32 as 3xTF32 mma.sync (hi/lo split, f32-exact), "
                      "bf16 on bf16 mma.sync, cp.async K/V ring, each q "
                      "tile's key range split over a cluster of S CTAs "
                      "(choose_flash_plan)"},
        kernel_entry("wkv6", "src/repro_torch/csrc/wkv6.cu",
                     "src/repro/kernels/wkv6/kernel.py:74", r1["launches"],
                     b5_err, [{k: v for k, v in s.items()
                               if k not in WKV_DESIGN_BOUNDS}
                              for s in b5_shapes], r1) | {
            "design": "two launches: a local pass over every (b, h, chunk) "
                      "at once (mid-chunk pivot, float64 decay scan, lower "
                      "score tiles, A·v and the state delta on 3xTF32 "
                      "mma.sync), then a carry per (b, h, 16 value columns) "
                      "walking the chunks with the state in registers "
                      "through a 4-stage cp.async ring; one chunk: the "
                      "local pass alone"},
    ]
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
