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
    python3 chip_smoke.py --tier             # the build and phase 17 (T1, the tiered pool) only
    python3 chip_smoke.py --overlap          # the build and phase 18 (O1, the overlapped schedule) only
    python3 chip_smoke.py --http             # the build and phase 19 (H1, the HTTP front end) only
    python3 chip_smoke.py --replicas         # the build and phase 20 (M1, multi-replica serving) only
    python3 chip_smoke.py --hybrid           # the build and phase 21 (Y1, hymba-1.5b) only
    python3 chip_smoke.py --moe              # the build and phase 22 (E1, mixtral-8x7b) only
    python3 chip_smoke.py --vlm              # the build and phase 23 (P1, pixtral-12b) only
    python3 chip_smoke.py --audio            # the build and phase 24 (W1, whisper-base) only
    python3 chip_smoke.py --train            # the build and phase 25 (L1, training) only
    python3 chip_smoke.py --mesh             # the build and phase 26 (X1, the device mesh) only
    python3 chip_smoke.py --dryrun           # the build and phase 27 (F1, the dry-run's count on the card) only

A call that runs one model's phase alone (--quant-servers, --dse,
--window, --replicas, --hybrid, --moe, --vlm, --train, --mesh, and
--tier, --overlap, --http) runs that model at full depth; the default
run cuts Q1 / Q2, T1 / O1 / H1, D1 / V1 / M1, G1, Y1, E1, L1's hymba and
X1 in depth (never in width), and the CPU sides of Y1's and P1's DSE
checks to their shorter prompts, to fit every phase into its time
limit.

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
8. Q1, Q2   the quantized deployments at the full width of qwen1.5-0.5b
            (in the default run cut to QWEN_QUANT_LAYERS of its 24 layers;
            `--quant-servers` runs all 24): Q1 W4A16 weights, stripe
            pool, kv4 pages (the design-space search's fallback); Q2 W8A8
            weights, shared pool, kv8 pages (prefix hits, copy-on-write of
            codes and scales).  B3's counter must equal 4 x L per decode
            step and prefill chunk (wo, gate, up, down; wq/wk/wv are
            dequantized, the LM head is the float embedding), B1's (Q1) or
            B2's (Q2) L per decode step, the other 0.  Each is held against the same server run
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
14. D1      full-width llama2-7b, in the default run cut to 8 of its 32
            layers (LLAMA2_LAYERS;
            d_model 4096, 32 heads x 128, d_ff 11008; random f32 weights
            from seed 0) under the
            design-space search's pick at max_context 128 (asserted:
            discrete, kv8) with `launch/serve.py --use-dse`'s overrides, 4
            slots, 6 greedy requests of 5-60 prompt tokens (one repeats a
            segment) x 16 new tokens: stripe pool, B1 launches = decode
            steps x 8 x 32; the compact variant on the same params and
            prompts serves the same tokens (or differs only at a near-tie,
            see `dse_server_phase`); the shared pool, B2 launches = decode
            steps x 8 x 32, the allocator's invariants after the drain;
15. V1      D1's stripe deployment with speculation_k = 4 (prompt-lookup
            draft-and-verify): the same tokens as D1's sequential run, at
            least one verify step, and the acceptance counts printed;
16. G1      full-width gemma3-12b, in the default run cut to 6 of its 48
            layers (GEMMA_LAYERS:
            5 local over a 1024-token window in ring-recycled pages, 1
            global; d_model 3840, 16 heads (8 kv) x 256, d_ff 15360, vocab
            262144; 15 GB of random f32 weights from seed 0, drawn after
            D1's are freed), 4 slots,
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
            compact, kv8) on the stripe pool (B1 = decode steps x 12),
            the shared pool (B2 = decode steps x 12, both allocators clean
            after the drain) and the splice scheduler (B4 = admits x 12,
            local layers at window 1024), the final lengths printed; the
            stripe run's logprobs against the plain forward within
            QUANT_LOGPROB_TOL; KVNAND-D on the ring (B1 = steps x 12 x 8)
            and speculation_k = 4 (the stripe run's tokens exactly).  The
            three pools and schedulers, and the two variants, serve equal
            tokens or part only at a near tie (KV8_GAP_TOL;
            LOGIT_GAP_TOL for the variants, as D1).  Peak memory and each
            run's wall printed beside the card.  `--window` runs the build
            and this phase only;
17. T1      the tiered pool at the full width of qwen1.5-0.5b (random
            weights from seed 0; T1, O1 and H1 share them, in the default
            run SERVING_LAYERS of its 24 layers), 4 slots, 512 tokens of context, a flash
            pool of 512 pages (`total_pages`) and a hot tier of
            `dse.recommend_hot_pages(flashsim.kvnand_c(), cfg, 512,
            slots=4, page_tokens=16, total_pages=512)` pages (asserted:
            128, the 4-slot working set).  Three waves of 16 greedy new
            tokens a request: 8 distinct 256-token prefixes with 8-40-token
            suffixes; 8 unrelated prompts of 100-300 tokens, which demote
            the first wave's cached pages; the first wave's prefixes again
            with new suffixes.  At f32 and kv8, each tiered with prefetch,
            tiered without, and flat (hot_pages 0, the same 512 pages):
            the same tokens in all three, logprobs within
            TIER_LP_TOL of the flat pool's; demotions, promotions and
            prefetched pages > 0 and fewer stall tokens with prefetch;
            after the drain the allocator's and the tier's invariants hold
            and no hot page is pinned; B2 = decode steps x 24.  Each run's
            wall, pool size and peak device memory printed beside the
            card.  `--tier` runs the build and this phase only;
18. O1      the overlapped schedule: stripe bf16, shared f32, T1's tiered
            f32 and stripe with speculation_k = 4 (which runs
            synchronously), each served synchronously and overlapped on the
            stripe prompts under mixed sampling params (greedy with
            logprobs, seeded temperature, top-k, top-k/top-p, a stop token
            the greedy request first samples at index >= 3, greedy): the
            same tokens, logprobs and finish reasons both ways, and B1 (or
            B2) = decode steps x 24 each way (an overlapped dispatch cannot
            admit into a slot its own collect frees, so the step counts may
            differ); wall, decode steps, host-observed device idle time
            and phantom tokens printed.  Then a decode-only `dispatch()`,
            and a second one chained on it, under
            `torch.cuda.set_sync_debug_mode("error")` on the stripe, shared
            and tiered pools: the stripe pool's must not synchronize; the
            first synchronizing call of the others is printed.
            `--overlap` runs the build and this phase only;
19. H1      the HTTP front end (`BackgroundServer`, overlapped engine
            loop) around the full-width shared f32 pool: 6 concurrent
            `POST /v1/completions` of the stripe prompts, 3 one-shot and 3
            SSE, each equal to `generate()` on an identically configured
            server; `GET /metrics` reports the 6 finished requests, their
            TTFTs and 90 decode tokens; B2 = decode steps x 24; the wall
            printed.  `--http` runs the build and this phase only;
20. M1      multi-replica serving, run after V1 on D1's full-width
            llama2-7b weights (8 layers) before they are freed: first the seeded
            streams on the card against the CPU's for the same (seed,
            position) (keys, random bits and uniform floats exactly, the
            Gumbel noise within 2^-22 (1 + |n|), its two logs' bound).  Then,
            at f32 and kv8, each on a flat pool and on a tiered one (a
            64-page hot tier), three replicas built by `build_replica`
            on the same weight tensors (compact variant, 4 slots,
            max_context 512, each its own 128-page shared pool; the
            f32-tiered and kv8-flat replicas overlapped): wave 1, 8
            requests of 16 new tokens (5-60 prompt tokens behind a common
            32-token system prefix; 6 greedy, 2 seeded stochastic),
            disaggregated through `ReplicaRouter` (replica 0 prefills,
            each request migrates once, through the envelope's wire
            bytes, and decodes on replica 1 or 2); wave 2, 8 more behind
            the same prefix, routed over the decode replicas, which the
            prefill replica's published prefix pages warm
            (`prefix_warmed_pages` > 0).  The tokens equal one server's on
            the same weights and pool, or part only at a near tie
            (LOGIT_GAP_TOL at f32, KV8_GAP_TOL at kv8; a seeded request's
            gap measured in its perturbed scores); B2 = the replicas'
            decode steps x 8, B1 and B3-B5 0; every allocator and tier
            clean after the drain, no hot page pinned.  Envelope bytes,
            the migration pump's host wall, the wall, peak memory and the
            card printed.  `--replicas` runs the build and this phase on
            freshly drawn weights;
21. Y1      full-width hymba-1.5b, the hybrid family, in the default run
            cut to 24 of its 32 layers (HYMBA_LAYERS: 23 local over a 1024-token window in
            ring-recycled pages, global 15; d_model 1600, 25 heads (5 kv, a head group of 5) x
            64, d_ff 5504, vocab 32001 padded to 32256, an untied LM
            head; a selective-SSM mixer (state 16) beside attention in
            every layer; 128 meta tokens; 4.3 GB of random f32 weights
            from seed 0, drawn after G1's are freed), 4 slots,
            max_context 2048, 64-token chunks, 6 greedy prompts of 5, 17,
            60, 200, 900 and 1100 tokens x 24 new tokens (with the meta
            tokens the 1100-token prompt wraps the 65-page ring in
            prefill, the 900-token one in decode).  Kernels at Y1's
            shapes against their plain versions: B1 and B2 (K = 5, G = 5,
            dh 64; 16- and 64-token pages; the ring at window 1024 and the
            global pool; f32, bf16, kv8, kv4), B4 (1228 positions, 25 / 5
            heads, window 1024 and none), B3 (W4A16 at hymba's six
            projection shapes x M 4, 64, 1228), then timed at Y1's
            serving shapes.  Golden: the 1100-token prompt as one
            whole-prompt chunk into an f32 stripe pool, then 8 decode
            steps, within GOLDEN_TOL of the plain full forward, the same
            argmax.  Servers at f32 pages of 16 tokens: stripe (B1 =
            decode steps x 24; every prompt ONE whole-prompt chunk; the
            teacher-forced check with the argmax), shared (B2 = steps x
            24, the prefix cache off, both allocators clean), splice (B4
            = admits x 24), KVNAND-D (B1 = steps x 24 x 5), stripe kv8
            pages and the overlapped schedule, each serving the stripe
            run's tokens or parting only at a near tie (LOGIT_GAP_TOL;
            for kv8, whose pages differ from the f32 run's by the
            format's noise, KV8_F32_TOL, and its logprobs against the
            plain forward within it); shared kv8 pages (B2) against the
            stripe kv8 run within KV8_GAP_TOL; two replicas, one
            prefilling and one decoding (every request migrates once:
            pages, ring bases, SSM rows), against the shared server's
            tokens the same way.  Then the design-space search's pick
            (asserted: compact, 64-token pages, W4A16, kv8, one
            partition): B3 = 10 x 24 per decode step and whole-prompt
            chunk (wo, gate, up, down and the mixer's six projections), B1
            = steps x 24; served logprobs against the plain forward within
            QUANT_LOGPROB_TOL, and each prompt of at most HYMBA_CPU_PROMPT
            tokens (HYMBA_CPU_PROMPT_CUT in the default run) prefilled on
            the card and on the CPU within
            HYMBA_PREFILL_TOL, the CPU computing B3's own function
            (`b3_function`); two controls beside it, printed: the card
            computing that function too (what the gap owes to the rest of
            the model), and the card's plain GEMV, which must read above
            the bound.  Launch counts, walls and peak memory printed
            beside the card.  `--hybrid` runs the build and this phase
            only;
22. E1      full-width mixtral-8x7b, the MoE family (32 layers, in the
            default run cut to 8 (MIXTRAL_LAYERS), d_model
            4096, 32 heads over 8 kv heads x 128 (G = 4), 8 experts,
            top-2, d_ff 14336 an expert, vocab 32000, an untied LM head,
            rope theta 1e4) at W4A16: random weights built one layer at a
            time on the card (the port's `init_model` on a one-layer copy
            of the config, seeded with the layer's index, then
            `quantize_params`, its codes and scales copied into stacked
            leaves), so no float32 tree of 187 GB is ever made; the
            embedding, LM head, norms and router stay float32.  Kernels
            at E1's shapes against their plain versions: B1 and B2 (K =
            8, G = 4, dh 128; 16- and 64-token pages over 1024 tokens;
            f32, bf16, kv8, kv4; all heads and a KVNAND-D group of one kv
            head), B4 (32 / 8 heads, f32, causal, 64 and 600 positions),
            B3 (W4A16, 4096 -> 4096, M 4 and 64), then timed at E1's
            serving shapes.  One layer's `moe` on the card and on the card
            machine's CPU (a 64-token chunk, a 4-row decode, the chunk at
            capacity 0.5): the routes (`layers.moe_route`) equal, the
            outputs within MOE_LAYER_TOL.  Golden: the 600-token prompt
            in 64-token chunks into an f32 stripe pool, then 8 decode
            steps, at the no-drop capacity E / top_k, against the plain
            full forward computing wo as B3's function (MIXTRAL_GOLDEN_TOL,
            the same argmax), and again as the control with wo
            dequantized to f32 on both sides (`float_wo`: no B3, no bf16
            rounding of wo's input), within GOLDEN_TOL.  Servers at the
            reference capacity 1.25 (tokens past an expert's capacity
            dropped), 4 slots, max_context 1024, 64-token chunks, 6
            greedy prompts of 5-600 tokens (two behind a 64-token prefix)
            x 16 new tokens: stripe f32 (B1 = decode steps x 32, B3 = 32 x
            (steps + chunks)), shared (B2, the prefix hit at the chunk
            boundary), overlapped, KVNAND-D (B1 = steps x 32 x 8) and two
            replicas, one prefilling and one decoding, each serving the
            stripe run's tokens (the replicas the shared run's) or parting
            only at a near tie (MIXTRAL_GAP_TOL); stripe kv8 against
            stripe f32 within MIXTRAL_KV8_F32_TOL, shared kv8 against
            stripe kv8 within KV8_GAP_TOL.  The splice scheduler (B4 =
            admits x 32) and speculation_k = 4 call `moe` at other
            lengths, so they run at the no-drop capacity against a stripe
            run at it, whose logprobs are held to the plain forward (wo as
            B3's function).  The control pair, stripe and KVNAND-D on
            float wo at the no-drop capacity on the first two prompts,
            within LOGIT_GAP_TOL of the plain forward and of each other.  Then O1's probe on the
            stripe pool: a decode-only dispatch through `moe`, and a
            second chained on it, under
            `torch.cuda.set_sync_debug_mode("error")` must not
            synchronize.  Launch counts, walls and peak memory printed
            beside the card.
            `--moe` runs the build and this phase only;
23. P1      full-width pixtral-12b, the VLM family, at full depth (40
            layers, d_model 5120, 32 heads over 8 kv x 160 (G = 4), d_ff
            14336, vocab 131072, an untied LM head, rope theta 1e6; 51 GB
            of random f32 weights from seed 0, drawn after E1's are
            freed).  Kernels at P1's shapes against their plain versions:
            B1 and B2 (16- and 64-token pages over PIXTRAL_CTX tokens, f32
            and bf16, all heads and a KVNAND-D group), B4 (32 / 8 heads x
            160, causal, 320 and 600 positions), B3 (W4A16 at wo, gate/up
            and down, M 4 and 64), then timed.  Golden: 256 patch
            embeddings before a 64-token prompt, one-shot prefill (B4 =
            40, the slot's length counting the patches) and 8 decode steps
            (B1 = 8 x 40) against the plain forward over the same patches
            within GOLDEN_TOL, every argmax equal.  Servers (4 slots,
            max_context 1024, 64-token chunks, 6 greedy prompts of 5-600
            tokens, two behind a 64-token prefix, x 16, f32 pages of 16;
            the schedulers feed no patches, as the reference's): stripe
            (B1 = decode steps x 40, the teacher-forced check with the
            argmax), shared (B2, the prefix cache hitting the shared
            prefix), splice (B4 = admits x 40) and KVNAND-D (B1 = steps x
            40 x 8), each serving the stripe run's tokens or parting only
            at a near tie (LOGIT_GAP_TOL).  Then the f32 tree is freed and
            the design-space search's pick (asserted: compact, 64-token
            bf16 pages, W4A16) served on W4A16 weights built one layer at
            a time: B3 = 4 x 40 per decode step and chunk, B1 = steps x
            40, logprobs against the plain forward within
            QUANT_LOGPROB_TOL, and the prompts of at most
            PIXTRAL_CPU_PROMPT tokens (PIXTRAL_CPU_PROMPT_CUT in the
            default run) prefilled on the card and on the
            card machine's CPU computing B3's function within
            PIXTRAL_PREFILL_TOL, with Y1's two controls.  `--vlm` runs the
            build and this phase only;
24. W1      full-width whisper-base, the encoder-decoder family, at full
            depth (6 encoder + 6 decoder layers, d_model 512, 8 heads x 64,
            d_ff 2048 GELU, vocab 51865, tied; random f32 weights from seed
            0).  Kernels against their plain versions: B1/B2 over the
            decoder's self-attention pool (G = 1, dh 64), B1 over the
            encoder's 96 pages of 16 (WHISPER_FRAMES = 1536, whisper's
            1500 rounded up to whole pages) in one and four partitions, B4
            non-causal on the encoder (1536 x 1536) and the
            cross-attention (40 and 1 rows against 1536), each under the
            host's plan and S forced to 1 and 8, f32 and bf16; then timed.
            Golden, compact and KVNAND-D, f32 and bf16 K/V: 1536 frames
            and a 40-token prompt, one-shot prefill (the encoder once; B4
            = 6 + 6 + 6) and 8 decode steps (B1 = 8 x (6 + 6), KVNAND-D 8
            x (6 x 8 + 6)) against the plain forward over the same frames:
            f32 within GOLDEN_TOL with every argmax equal, bf16 within
            WHISPER_BF16_TOL.  The reference's servers cannot serve
            whisper (ROADMAP §C), so neither do the port's: W1 is the
            engine.  `--audio` runs the build and this phase only;
25. L1      training (`training/train_step.py`, `launch/train.py`), every
            attention forward through B4 under autograd
            (`FlashAttentionFn`: B4's forward, a torch-op backward).
            First B4's gradients: dq / dk / dv against autograd through
            the plain version on the card (FLASH_TOL of max |grad|, f32
            and bf16) at FLASH_GRAD_SHAPES (qwen1.5-0.5b's 16 x 64 causal
            at 256, hymba's 25 / 5 x 64 at window 1024 over 1152
            positions, 32 / 8 x 128 at 600, whisper's non-causal 8 x 64
            encoder at 1536 and its cross-attention 256 x 1536), and the
            forward and backward timed at qwen's training shape beside
            the plain version under autograd and SDPA's.  Then
            qwen1.5-0.5b at full width and depth (random f32 weights
            from seed 0, `SyntheticLM` seed 0, seq TRAIN_SEQ x batch
            TRAIN_BATCH): (a) step 0's gradients on the kernel path
            against impl="ref" on the card (TRAIN_LOSS_TOL,
            TRAIN_NORM_TOL, TRAIN_LEAF_TOL); (b) remat "block", "full"
            and 2 microbatches against remat "none" within the same
            bounds, each run's peak memory printed; (c) B4 launches =
            24 a step, 48 under remat or 2 microbatches, B1-B3 and B5 0;
            the step time and tokens/s; (d) TRAIN_STEPS steps through
            `launch.train` at the reference driver's TRAIN_LR on the
            kernel path and on impl="ref", loss for loss within
            TRAIN_TRACK_TOL, then TRAIN_STEPS steps at TRAIN_FALL_LR,
            every loss finite and the mean of the last 5 below the first
            5's by TRAIN_FALL; (e)
            RESUME_STEPS steps straight against RESUME_AT steps and a
            resume from the checkpoint directory for the rest: losses
            and final state bit for bit or within the bound printed.
            Then hymba-1.5b at full width (in the default run cut to
            HYMBA_TRAIN_LAYERS of 32), 1024 tokens after its 128 meta
            tokens x 2 rows, remat "block": (a) and HYMBA_TRAIN_STEPS
            steps of finite, falling loss.  `--train` runs the build and
            this phase only.
26. X1      the device mesh (`distributed/sharding.py`, `core/seqpar.py`,
            the engine's mesh path), on a single-process mesh of eight
            `cuda:0` entries: the sharded dataflow on one card.  First
            B1 and B2 through the sharded decode at (a)'s decode shape
            (data 2 x model 4: each shard 2 slots x 9 of 36 pages, or 36
            of the shared pool's 144 through a permuted table; f32 and
            kv8; one launch a shard) against the single-device kernel
            over the whole pool and the plain version (TOL), and the
            sharded call timed beside one whole-pool launch.  (a)
            full-width llama3.1-8b (32 / 8 heads x 128; in the default
            run cut to MESH_LAYERS of 32), f32 weights from seed 0, 4
            slots of 512-token prompts, T = 16: a one-shot prefill
            through the ring (B4 launched no time) and MESH_STEPS greedy
            decode steps on f32 pools, the same on kv8 pools, the same
            prefilled by `prefill_chunk` in 64-token chunks; each against
            the same engine with mesh=None on the card, fed that run's
            greedy tokens: every step's argmax equal, logits within
            MESH_F32_TOL / MESH_KV8_TOL of max |logit|, and B1 launched
            data shards x page shards x layers a decode step (printed
            beside the count).  (b) the shared pool on the mesh: 64
            decode steps from an empty cache whose tables scatter each
            slot's pages over the shards, against mesh=None, B2 launched
            8 x layers a step.  (c) full-width qwen1.5-0.5b on a (pod 2,
            data 2, model 2) mesh at batch 8 x 256: the exact step (ring
            attention over `model`) against the same step through B4
            without a mesh (MESH_RING_LOSS_TOL), one int8-compressed
            step against the exact step (the reference's bounds,
            MESH_TRAIN_LOSS_TOL, MESH_TRAIN_PARAM_TOL), and a second from
            each pod's own residual.  The mesh decode step's host wall is
            printed beside mesh=None's: shards that share one card show
            no link cost, so nothing is claimed from it.  `--mesh` runs
            the build and this phase only, at full depth.
27. F1      the dry-run's count held on the card (`launch/steps.py`,
            `launch/op_cost.py`, `launch/roofline.py`).  Two cells of
            full-width qwen1.5-0.5b are built through `launch/steps.py`:
            (a) the decode step at phase 4's serving shape (4 slots, a
            512-token context, T = 16, the stripe pool in bf16; B1) and
            (b) L1's training step at batch 8 x 256 (bf16 weights, f32
            AdamW moments, remat "block", its forward through B4).  For
            each: the dry-run's prediction from one run of the step on
            meta tensors (FLOPs, fused and raw bytes, argument bytes,
            peak, the eager program's terms), the bound of the step's
            function (`steps.function_cost`: the FLOPs and bytes the
            function needs, against one H100's peaks), and the count's
            fused bytes held between that function's bytes and
            F1_BYTES_CEILING times them; then the same cell on the card
            with seed-0 weights through the kernels: its argument bytes
            equal to the prediction exactly, `max_memory_allocated` over
            a warm step and F1_STEPS timed ones (after
            `reset_peak_memory_stats`) (less what earlier phases hold)
            inside F1_PEAK_BAND of the predicted peak, the median device
            time of the F1_STEPS steps by CUDA events, and the roofline
            share = the function's bound / time at most F1_SHARE_MAX (a
            share above it means the bound is wrong); B1 launched 24 a
            decode step, B4 48 a train step (the remat recompute reruns
            it).  `--dryrun` runs the build and this phase only.

It needs a CUDA card (exits non-zero without one, printing no result),
imports nothing of JAX, and prints the card's name and power limit, a
{"kernels": [...]} line and, last, {"ok": true, "device": {...}}.
"""
from __future__ import annotations

import contextlib
import functools
import json
import math
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

def server_config(device="cuda", scheduler="interleaved", server=None,
                  **engine):
    """The `ServerConfig` of the full-width qwen1.5-0.5b server: 4 slots,
    512 tokens of context, 64-token chunks; `server` adds ServerConfig
    fields (overlap, speculation_k, tier_prefetch)."""
    from repro_torch.configs import EngineConfig
    from repro_torch.serving.api import ServerConfig
    eng = EngineConfig(page_tokens=16, uniform_lengths=False, **engine)
    return ServerConfig(
        arch="qwen1.5-0.5b", reduced=False, engine=eng, batch_slots=4,
        max_context=512, prefill_chunk_tokens=64, device=device,
        scheduler=scheduler, **(server or {}))


def build_server(params=None, device="cuda", scheduler="interleaved",
                 server=None, layers=None, **engine):
    """The full-width qwen1.5-0.5b server on `device`: random weights from
    seed 0, or `params` (e.g. a quantized tree), and `layers` of its 24
    (default: all 24, or the depth of `params`; the default run cuts Q1 /
    Q2 and T1 / O1 / H1 in depth)."""
    import dataclasses
    import torch
    from repro_torch.configs import get_config
    from repro_torch.serving.api import KVNANDServer
    if layers is None:
        layers = 24 if params is None else params["layers"]["ln1"].shape[0]
    t0 = time.perf_counter()
    config = server_config(device, scheduler, server, **engine)
    eng = config.engine
    srv = KVNANDServer(config, cfg=dataclasses.replace(
        get_config("qwen1.5-0.5b"), n_layers=layers), params=params)
    cfg = srv.cfg
    check(cfg.n_layers == layers and cfg.d_model == 1024
          and cfg.n_heads == 16 and cfg.padded_vocab == 152064,
          "not the full-width qwen1.5-0.5b")
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
                         tol=LOGPROB_TOL, rt=None):
    """Every served token against the port's plain full forward on the
    card (kernel-free), teacher-forced on prompt + output, served
    logprobs within `tol`.  argmax=False reports the largest
    reference-logit gap instead of failing on it.  `rt`: the forward's
    Runtime (an MoE server's capacity factor)."""
    import torch
    from repro_torch.models.registry import Model
    cfg = srv.cfg
    model = Model(cfg, rt)
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
    gen = torch.Generator(device="cuda").manual_seed(3)
    max_abs, n = 0.0, 0
    for scheme in ("w4a16", "w8a8"):
        for M in gemv_rows():
            for label, D, F in GEMV_SHAPES:
                max_abs = max(max_abs, gemv_hold_case(scheme, M, label, D,
                                                      F, gen))
                n += 1
    print(f"B3 kernel phase: {n} cases within tolerance, each launched "
          f"twice with the same bits, max_abs_err={max_abs:.3e}")
    return max_abs


def gemv_hold_case(scheme, M, label, D, F, gen) -> float:
    """One B3 case of phase 7's sweep: against `quant_gemv_ref` (and W4A16
    against the TPU kernel's function), launched twice for the same bits;
    returns max |y - plain y|."""
    import torch
    from repro_torch.core.quant import unpack_int4
    from repro_torch.kernels.quant_gemv import quant_gemv, quant_gemv_ref
    from repro_torch.kernels.quant_gemv.kernel import choose_gemv_plan
    sms = torch.cuda.get_device_properties(0).multi_processor_count
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
    check(bool(torch.isfinite(got).all()) and got.shape == (M, F),
          f"{msg}: bad output")
    check(torch.equal(got, again), f"{msg}: a second launch gave other bits")
    if scheme == "w4a16":
        tpu = ((x.to(torch.bfloat16).double() @ unpack_int4(qw.q).double())
               * qw.scale.double())
        err_tpu = rel_err(got, tpu)
        msg += (f", vs the TPU kernel's function {err_tpu:.3e} (tol "
                f"{GEMV_TPU_TOL:.0e})")
        check(err_tpu <= GEMV_TPU_TOL, msg)
    print(msg)
    check(err <= GEMV_TOL[scheme], msg)
    return float((got - want).abs().max())


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
    words = qw.q.reshape(-1).view(torch.float32)
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


# Q1 / Q2's depth in the default run, cut from 24 for L1 (the CPU runs,
# 68 s of a fast host at 24 layers, scale with it; PERF.md, PR 27);
# `--quant-servers` runs all 24
QWEN_QUANT_LAYERS = 12


def quant_server_phase(label, scheme, kv_quant, shared, prompts_of):
    """A quantized deployment of full-width qwen1.5-0.5b on the card (the
    random model of the server phases at QWEN_QUANT_LAYERS of its 24 in
    the default run, quantized by `quantize_params`), then the same server
    on the CPU with the same params, both serving the same prompts.  Every
    copy-on-write is checked as it happens: the new page's codes and
    scales equal its source's."""
    import dataclasses
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core import paged_kv
    from repro_torch.core.quant import quantize_params
    from repro_torch.models.registry import Model
    layers = depth(QWEN_QUANT_LAYERS, 24)
    cfg = dataclasses.replace(get_config("qwen1.5-0.5b"), n_layers=layers)
    gen = torch.Generator(device="cuda").manual_seed(0)
    qparams = quantize_params(Model(cfg).init(gen), scheme)
    eng = dict(kv_quant=kv_quant, shared_pool=shared, layers=layers)
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


def flash_bound(B, S, H, K, dh, dtype, rate, Sk=None,
                causal=True) -> dict:
    """The least time the card could take for one causal prompt (Sq = Sk
    = S), or S queries against Sk keys without a mask (causal=False):
    4·dh FLOPs per visible (query, key) pair at the fastest exact route
    of the input type (f32: three TF32 products at the TF32 peak; bf16:
    the bf16 peak), against q, k, v and o moved once at the HBM rate; and
    the same FLOPs at the f32 CUDA-core peak beside it."""
    Sk = S if Sk is None else Sk
    pairs = S * (S + 1) // 2 if causal else S * Sk
    flops = 4 * B * H * dh * pairs
    f32 = dtype == "float32"
    nbytes = (4 if f32 else 2) * B * dh * (2 * H * S + 2 * K * Sk)
    t_ops = (3 * flops / TF32_FLOPS if f32 else flops / BF16_FLOPS) * 1e3
    t_bytes = nbytes / rate * 1e3
    return {"bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "bound_cuda_core_ms": flops / F32_FLOPS * 1e3,
            "flops": flops, "bytes": nbytes}


def flash_timing_shape(label, B, S, H, K, dh, dtype, rate, flush, gen, reps,
                       splits=(), Sk=None, causal=True):
    """B4 at one shape, causal over S positions, or S queries against Sk
    keys without a mask (causal=False: an encoder's self-attention, a
    decoder's cross-attention): the kernel under the host's plan (and,
    for each of `splits`, with S forced), the plain version, and one SDPA
    call in the same dtype on the same tensors (K/V expanded to H heads
    beforehand, [B, H, S, dh] copies)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import (flash_attention_cuda,
                                                     flash_attention_ref)
    dt = getattr(torch, dtype)
    Sk = S if Sk is None else Sk
    q, k, v = flash_inputs(B, S, Sk, H, K, dh, dt, gen)
    G = H // K
    qs = q.transpose(1, 2).contiguous()
    ks = k.repeat_interleave(G, dim=2).transpose(1, 2).contiguous()
    vs = v.repeat_interleave(G, dim=2).transpose(1, 2).contiguous()
    kw = dict(causal=causal, window=None, q_offset=0)
    plan = flash_plan(q, k, None, **kw)
    times = {
        "ms": time_ms(lambda: flash_attention_cuda(q, k, v, causal=causal),
                      reps, flush),
        "plain_ms": time_ms(lambda: flash_attention_ref(
            q, k, v, causal=causal), 3, flush),
        "library_ms": time_ms(lambda: F.scaled_dot_product_attention(
            qs, ks, vs, is_causal=causal), reps, flush),
    }
    for split in splits:
        forced = flash_plan(q, k, split, **kw)
        times[f"S{split}_ms"] = time_ms(
            lambda: flash_attention_cuda(q, k, v, causal=causal,
                                         plan=forced), reps, flush)
    res = {"shape": label, "B": B, "S": S, "Sk": Sk, "H": H, "K": K,
           "dh": dh, "dtype": dtype, "causal": causal, "split": plan.split,
           "library": f"scaled_dot_product_attention(is_causal={causal}), "
                      f"{dtype}",
           **flash_bound(B, S, H, K, dh, dtype, rate, Sk, causal)}
    for key, t in times.items():
        res[key] = statistics.median(t)
        res[f"{key}_min_max"] = [t[0], t[-1]]
    print(f"timing B4 {label} B={B} S={S} Sk={Sk} H={H} K={K} dh={dh} "
          f"{dtype} {'causal' if causal else 'non-causal'} "
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
# D1's depth (V1's and M1's, on the same weights), cut from 32 so that the
# whole run stays well inside its time limit (PERF.md, PR 25: 1173 s of
# command time with 16 layers here, 24 in G1 and 32 in Y1 on a card whose
# host ran the launch-bound phases 1.4-1.5x slower than another's)
LLAMA2_LAYERS = 8
# A call that runs one model's phase alone (--quant-servers, --dse,
# --window, --replicas, --hybrid, --moe, --vlm, --train, --mesh) runs that
# model at full depth; only the default run, which must fit every phase
# into its limit, takes the depth cuts (QWEN_QUANT_LAYERS, SERVING_LAYERS,
# LLAMA2_LAYERS, GEMMA_LAYERS, HYMBA_LAYERS, MIXTRAL_LAYERS,
# HYMBA_TRAIN_LAYERS, MESH_LAYERS) and the cuts of Y1's and P1's CPU sides
# (HYMBA_CPU_PROMPT_CUT, PIXTRAL_CPU_PROMPT_CUT).  Widths are never cut.
FULL_DEPTH = False


def depth(cut: int, full: int) -> int:
    """A model's layer count (or another size the default run cuts) in
    this run: `full` in a single-phase call, `cut` in the default run."""
    return full if FULL_DEPTH else cut


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


def llama2_cfg():
    """Full-width llama2-7b cut to LLAMA2_LAYERS layers."""
    import dataclasses
    from repro_torch.configs import get_config
    cfg = get_config("llama2-7b")
    check(cfg.n_layers == 32 and cfg.d_model == 4096 and cfg.n_heads == 32
          and cfg.n_kv_heads == 32 and cfg.d_head == 128
          and cfg.d_ff == 11008, "not the full-width llama2-7b")
    return dataclasses.replace(cfg, n_layers=depth(LLAMA2_LAYERS, 32))


def build_llama2_server(params=None, speculation_k=None, **over):
    """Full-width llama2-7b (LLAMA2_LAYERS deep) on the card under the
    design-space search's pick at max_context LLAMA2_CTX, with
    `launch/serve.py --use-dse`'s overrides (page_tokens 16, ragged
    appends, float weights) and `over`; random float32 weights from seed
    0, or `params`."""
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
        speculation_k=speculation_k), cfg=llama2_cfg(), params=params)
    cfg = srv.cfg
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
    Then the shared pool (B2 launches = decode steps x layers x 32, B1 0,
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
    may draft runs the discrete decode step, B1 = those steps x layers x
    32).
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


# ---------------------------------------------------------------------------
# phase 20: M1, multi-replica serving (a prefill replica, two decode ones)
# ---------------------------------------------------------------------------

M1_CTX = 512            # each replica: 4 slots x 512 tokens = 128 pages
M1_PAGES = 128
M1_HOT = 64             # the tiered runs' hot tier: half the pool
# (label, pool, hot pages, overlapped replicas)
M1_RUNS = (("f32 flat", {"kv_dtype": "float32"}, 0, False),
           ("f32 tiered", {"kv_dtype": "float32"}, M1_HOT, True),
           ("kv8 flat", {"kv_quant": "kv8"}, 0, True),
           ("kv8 tiered", {"kv_quant": "kv8"}, M1_HOT, False))


def m1_waves(V):
    """Two waves of 8 prompts: a common 32-token system prefix, then 5-60
    tokens of their own."""
    import numpy as np
    rng = np.random.default_rng(20)
    sysp = rng.integers(1, V, 32).tolist()

    def wave():
        return [sysp + rng.integers(1, V, int(n)).tolist()
                for n in rng.integers(5, 61, 8)]

    return wave(), wave()


def m1_params():
    """6 greedy requests and 2 seeded stochastic ones, 16 new tokens."""
    from repro_torch.serving.api import SamplingParams
    sps = [SamplingParams(max_new_tokens=16, logprobs=True)
           for _ in range(6)]
    sps.insert(2, SamplingParams(max_new_tokens=16, logprobs=True,
                                 temperature=0.8, top_k=20, seed=11))
    sps.append(SamplingParams(max_new_tokens=16, logprobs=True,
                              temperature=0.7, top_p=0.9, seed=12))
    return sps


def build_m1_replica(params, hot_pages, overlap, **engine):
    """One M1 replica: full-width llama2-7b on `params` (shared, not
    copied: `build_replica`), compact variant, its own shared pool of
    M1_PAGES pages (a hot tier of `hot_pages` of them when > 0)."""
    from repro_torch.configs import EngineConfig
    from repro_torch.serving.api import ServerConfig
    from repro_torch.serving.replica import build_replica
    eng = EngineConfig(page_tokens=16, uniform_lengths=False,
                       shared_pool=True, total_pages=M1_PAGES,
                       hot_pages=hot_pages, **engine)
    srv = build_replica(ServerConfig(
        arch="llama2-7b", reduced=False, engine=eng, batch_slots=4,
        max_context=M1_CTX, prefill_chunk_tokens=64, overlap=overlap),
        cfg=llama2_cfg(), params=params, device="cuda")
    check(srv.params["embedding"] is params["embedding"],
          "M1: a replica copied the weights")
    return srv


def m1_noise_check(V) -> dict:
    """The seeded streams on the card against the port's CPU ones for the
    same (seed, position): keys and random bits exactly, the uniform
    floats exactly, and the Gumbel noise -log(-log(u)) within 2^-22 (1 +
    |n|), what its two float32 logs allow when each is within 1 ulp of
    the exact value on either side (2 ulps apart); the share of equal
    elements and the largest difference, in units of 2^-23 (1 + |n|),
    are printed."""
    import numpy as np
    import torch
    from repro_torch.serving import sampler
    seeds = np.repeat(np.array([11, 12, 0x9E3779B1], np.uint32), 16)
    pos = np.tile(np.arange(16), 3)
    kc = sampler.fold_in(sampler.PRNGKey(seeds, "cuda"), pos)
    kh = sampler.fold_in(sampler.PRNGKey(seeds, "cpu"), pos)
    check(torch.equal(kc.cpu(), kh), "M1: card keys differ from the CPU's")
    check(torch.equal(sampler.random_bits(kc, V).cpu(),
                      sampler.random_bits(kh, V)),
          "M1: card random bits differ from the CPU's")
    tiny = float(torch.finfo(torch.float32).tiny)
    check(torch.equal(sampler.uniform(kc, V, tiny).cpu(),
                      sampler.uniform(kh, V, tiny)),
          "M1: card uniform floats differ from the CPU's")
    nc = sampler.request_noise(seeds, pos, V, "cuda").cpu().double()
    nh = sampler.request_noise(seeds, pos, V, "cpu").double()
    err = (nc - nh).abs()
    # in units of 2^-23 (1 + |n|): one float32 ulp of a log's output
    # carried through -log(-log(u)); the bound is 2 of them
    units = err / (2.0 ** -23 * (1.0 + nh.abs()))
    res = {"rows": len(seeds), "vocab": V,
           "noise_equal_fraction": float((err == 0).double().mean()),
           "noise_max_abs_diff": float(err.max()),
           "noise_max_units": float(units.max())}
    print(f"M1 noise: keys, bits and uniforms equal on the card and the "
          f"CPU over {len(seeds)} rows x {V}; Gumbel noise equal on "
          f"{res['noise_equal_fraction']:.6f} of elements, max |diff| "
          f"{res['noise_max_abs_diff']:.3e} = "
          f"{res['noise_max_units']:.3f} x 2^-23 (1 + |n|) (bound 2)")
    check(res["noise_max_units"] <= 2.0, "M1: card Gumbel noise beyond "
          "2^-22 (1 + |n|) of the CPU's")
    return res


def m1_sampled_gap(cfg, params, prompt, toks, n, sp, a, b) -> float:
    """At a seeded request's first differing token n: the gap between
    tokens a and b in the sampler's perturbed scores (logits / T plus the
    request's noise at position n), from the plain full forward
    teacher-forced on prompt + toks[:n]."""
    import torch
    from repro_torch.models.registry import Model
    from repro_torch.serving.sampler import request_noise
    with torch.no_grad():
        seq = torch.tensor(prompt + toks[:n], device="cuda")[None]
        logits = Model(cfg).forward(params, {"tokens": seq})[0, -1].float()
    noise = request_noise([sp.seed], [n], logits.shape[-1], "cuda")[0]
    s = logits / sp.temperature + noise
    return abs(float(s[a] - s[b]))


def m1_compare(label, cfg, params, outs, refs, prompts, sps, gap_tol):
    """Router against one server: equal tokens, or at a request's first
    differing token a near tie, the two tokens within `gap_tol` (greedy:
    in logprob; seeded: in the perturbed scores, scaled by 1/T); served
    logprobs before it within LOGPROB_TOL."""
    _, same, rows = compare_runs(outs, refs)
    before = max(b for _, b, _ in rows)
    gap = 0.0
    for o, r, p, sp, (n, _, at) in zip(outs, refs, prompts, sps, rows):
        if n is None:
            continue
        a, b = o.token_ids[n], r.token_ids[n]
        if sp.temperature > 0:
            g = m1_sampled_gap(cfg, params, p, o.token_ids, n, sp, a, b)
            tol = gap_tol / sp.temperature
        else:
            g, tol = at, gap_tol
        print(f"check {label}: request {o.uid} differs at token {n}: {a} "
              f"vs {b}, gap {g:.3e} (tol {tol:.0e})")
        check(g <= tol, f"{label}: router and server part where neither "
              "is a near tie")
        gap = max(gap, g)
    print(f"check {label}: {same} of {len(outs)} requests equal to one "
          f"server's; max |logprob difference| before a divergence "
          f"{before:.3e} (tol {LOGPROB_TOL:.0e}); max gap at one {gap:.3e}")
    check(before <= LOGPROB_TOL, f"{label}: logprobs disagree")
    return same, before, gap


def m1_run(label, params, waves, hot, overlap, **engine) -> dict:
    """One M1 run: both waves through one server, then through three
    replicas: wave 1 disaggregated (replica 0 prefills, 1 and 2 decode),
    wave 2 routed over the decode replicas, which the prefill replica's
    published prefix pages warm.  Launch counters reset just before the
    replicas' run and read just after."""
    import gc
    import torch
    import repro_torch.serving.router as router_mod
    from repro_torch.kernels import flash_attention, quant_gemv, wkv6
    from repro_torch.kernels.paged_attention import launches, launches_shared
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    sps = m1_params()
    solo = build_m1_replica(params, hot, False, **engine)
    cfg = solo.cfg
    t0 = time.perf_counter()
    refs = solo.generate(waves[0], sps) + solo.generate(waves[1], sps)
    torch.cuda.synchronize()
    solo_wall = time.perf_counter() - t0
    del solo
    gc.collect()
    reps = [build_m1_replica(params, hot, overlap, **engine)
            for _ in range(3)]
    router = router_mod.ReplicaRouter(reps, disaggregate=True)
    envs, mig = [], [0.0]
    real_export, pump = router_mod.export_request, router._pump_migrations

    def export(b, uid):
        env = real_export(b, uid)
        envs.append((env.meta["n_pages_g"], env.nbytes()))
        return env

    def timed_pump():
        t = time.perf_counter()
        pump()
        mig[0] += time.perf_counter() - t

    router._pump_migrations = timed_pump
    counters = {"B1": launches, "B2": launches_shared,
                "B3": quant_gemv.launches, "B4": flash_attention.launches,
                "B5": wkv6.launches}
    steps0 = [s.stats["decode_steps"] for s in reps]
    router_mod.export_request = export
    try:
        for c in counters.values():
            c.reset()
        t0 = time.perf_counter()
        uids = [router.submit(p, sp) for p, sp in zip(waves[0], sps)]
        router.run()
        outs = [router.output(u) for u in uids]
        homes = [router.replica_of(u) for u in uids]
        for u in uids:
            router.release(u)
        routed = router_mod.ReplicaRouter(reps[1:],
                                          prefix_index=router.index)
        uids = [routed.submit(p, sp) for p, sp in zip(waves[1], sps)]
        routed.run()
        outs += [routed.output(u) for u in uids]
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = {k: c.value for k, c in counters.items()}
    finally:
        router_mod.export_request = real_export
    steps = [s.stats["decode_steps"] - s0 for s, s0 in zip(reps, steps0)]
    L = cfg.n_layers
    st, st2 = router.stats, routed.stats
    print(f"M1 {label}: wave 1 migrated {st['migrations']} requests "
          f"({st['migration_bytes']} wire bytes, "
          f"{st['migration_bytes'] / max(st['migrations'], 1):.0f} a "
          f"request, {st['migration_retries']} retries; envelope payloads "
          f"{min(b for _, b in envs)}-{max(b for _, b in envs)} bytes over "
          f"{min(n for n, _ in envs)}-{max(n for n, _ in envs)} pages); "
          f"migration pump {mig[0]:.3f} s of host wall; wave 2 warmed "
          f"{st2['prefix_warmed_pages']} pages; decode steps per replica "
          f"{steps}; launches {counts}; replicas {wall:.3f} s, one server "
          f"{solo_wall:.3f} s; peak "
          f"{torch.cuda.max_memory_allocated() / 1e9:.3f} GB; on "
          f"{smi_line()}")
    check(st["migrations"] == len(waves[0]) and all(h in (1, 2)
                                                    for h in homes),
          f"M1 {label}: not every request migrated once to a decode "
          f"replica ({st['migrations']} migrations, replicas {homes})")
    check(steps[0] == 0, f"M1 {label}: the prefill replica decoded")
    check(st2["prefix_warmed_pages"] > 0,
          f"M1 {label}: wave 2 warmed no prefix page")
    check(counts["B2"] == sum(steps) * L
          and all(counts[k] == 0 for k in ("B1", "B3", "B4", "B5")),
          f"M1 {label}: launches {counts} != (B2 decode steps {sum(steps)}"
          f" x {L}, B1/B3-B5 0)")
    for k, s in enumerate(reps):
        b = s._batcher
        b.alloc.check()
        check(b.alloc.live_count == b.prefix_cache.evictable_pages(),
              f"M1 {label}: replica {k} has pages mapped after the drain")
        if b.tier is not None:
            b.tier.check()
            check(b.tier.pinned_count == 0,
                  f"M1 {label}: replica {k} has {b.tier.pinned_count} hot "
                  "pages pinned after the drain")
    fmt = "kv8" if engine.get("kv_quant") == "kv8" else "float32"
    same, before, gap = m1_compare(
        f"M1 {label}", cfg, params, outs, refs, waves[0] + waves[1],
        sps + sps, KV8_GAP_TOL if fmt == "kv8" else LOGIT_GAP_TOL)
    res = {"hot_pages": hot, "overlap": overlap,
           "migrations": st["migrations"],
           "migration_bytes": st["migration_bytes"],
           "migration_retries": st["migration_retries"],
           "envelope_payload_bytes": [b for _, b in envs],
           "migration_wall_s": mig[0], "wall_s": wall,
           "one_server_wall_s": solo_wall,
           "prefix_published_pages": st["prefix_published_pages"],
           "prefix_warmed_pages": st2["prefix_warmed_pages"],
           "prefix_hit_pages": [s.stats["prefix_hit_pages"] for s in reps],
           "decode_steps": steps, "launches_B2": counts["B2"],
           "same_as_one_server": same, "logprob_err": before,
           "max_gap_at_divergence": gap,
           "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9}
    del router, routed, reps
    return res


def replica_phase(params) -> dict:
    """Phase 20, M1 (see the module docstring)."""
    import gc
    import torch
    from repro_torch.configs import get_config
    cfg = get_config("llama2-7b")
    res = {"noise": m1_noise_check(cfg.vocab_size)}
    waves = m1_waves(cfg.vocab_size)
    for label, engine, hot, overlap in M1_RUNS:
        res[label] = m1_run(label, params, waves, hot, overlap, **engine)
    res["launches_B2"] = sum(res[label]["launches_B2"]
                             for label, *_ in M1_RUNS)
    gc.collect()        # the tiered replicas' release hooks make cycles
    torch.cuda.empty_cache()    # that would keep the weights alive
    return res


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
# G1's depth, cut from 48 so that the whole run stays well inside its time
# limit (see LLAMA2_LAYERS), and from 12 to 6 to make room for X1 (PR 28):
# 5 local layers over the window ring and 1 global one, the same 5:1
# pattern
GEMMA_LAYERS = 6
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
    """Full-width gemma3-12b cut to GEMMA_LAYERS layers, its random
    float32 weights on the card, seed 0."""
    import dataclasses
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models.registry import Model
    cfg = get_config("gemma3-12b")
    check(cfg.n_layers == 48 and cfg.d_model == 3840 and cfg.n_heads == 16
          and cfg.n_kv_heads == 8 and cfg.d_head == 256
          and cfg.d_ff == 15360 and cfg.window == 1024
          and cfg.global_every == 6 and cfg.vocab_size == 262144,
          "not the full-width gemma3-12b")
    cfg = dataclasses.replace(cfg, n_layers=depth(GEMMA_LAYERS, 48))
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


def arch_kernel_phase(tag, cfg, seed, lengths, page_tokens, ctx, ring,
                      formats, b4_cases, b3_cases=(), head_groups=(None,)):
    """B1 and B2, and B4 and B3 where cases are given, at the shapes a
    model's main path gives them, held against their plain versions before
    its servers run.  B1/B2: one query row a slot (`lengths` tokens each)
    over cfg's kv heads and head group, for each page size of
    `page_tokens`, over the window ring (`ring`: ring_pages(cfg, T) pages,
    the bases a ring leaves after `lengths` positions, rotated and -1e9
    where empty, cfg.window) and a global pool of ctx / T pages, in each
    of `formats`; for each of `head_groups` (None: all kv heads in one
    launch; h: the KVNAND-D group of kv head h alone); B2 through permuted
    tables of a larger pool.  bf16 pools are held besides to the f32
    tolerance against the plain version on the pools upcast to f32.  B4:
    causal, f32, cfg's heads, one draw of (S, windows) a case, each window
    in turn.  B3: W4A16 at each (label, D, F) of `b3_cases[1]` for each M
    of `b3_cases[0]`.  Returns each kernel's max |o - plain o|."""
    import torch
    from repro_torch.core import paged_kv
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import paged_attention as pa
    gen = torch.Generator(device="cuda").manual_seed(seed)
    B, K, G, dh = len(lengths), cfg.n_kv_heads, cfg.group_size, cfg.d_head
    errs = {"B1": 0.0, "B2": 0.0}
    length = torch.tensor(lengths, dtype=torch.int32, device="cuda")
    n = 0
    for T in page_tokens:
        pools = [("global", ctx // T, (torch.arange(
            ctx // T, dtype=torch.int32, device="cuda") * T)[None].repeat(
                B, 1), None)]
        if ring:
            NPw = paged_kv.ring_pages(cfg, T)
            pools.insert(0, ("ring", NPw, torch.stack([torch.as_tensor(
                paged_kv.window_page_positions(x, NPw, T))
                for x in lengths]).cuda(), cfg.window))
        for pool, NP, base, window in pools:
            P = B * NP + 7
            perm = torch.randperm(P, generator=torch.Generator()
                                  .manual_seed(NP))[:B * NP]
            table = perm.reshape(B, NP).to(torch.int32).cuda()
            for fmt in formats:
                q, kp, vp, _, _, ks, vs = make_inputs(B, K, G, NP, T, dh,
                                                      fmt, lengths, gen)
                kvq = kv_quant_of(fmt)

                def scatter(x):
                    """The stripe pages [B, K, NP, ...] moved to the
                    table's physical pages of a shared pool [K, P, ...]."""
                    out = x.new_zeros((K, P) + x.shape[3:])
                    out[:, table.long()] = x.movedim(1, 0)
                    return out
                sp = [None if a is None else scatter(a)
                      for a in (kp, vp, ks, vs)]
                for heads in head_groups:
                    qh = q if heads is None else q[:, heads * G:(heads + 1)
                                                   * G]
                    sel = {} if heads is None else {"kv_heads": (heads, 1)}

                    def narrow(a, ax):
                        return (a if heads is None or a is None
                                else a.narrow(ax, heads, 1))
                    sk = [narrow(a, 1) for a in (kp, vp, ks, vs)]
                    ss = [narrow(a, 0) for a in sp]
                    label = (f"{tag} kernels: T={T} {pool} {fmt} "
                             + ("all heads" if heads is None
                                else f"kv head {heads}"))
                    got = pa.paged_attention_partial(
                        qh, kp, vp, base, length, window=window,
                        kv_quant=kvq, k_scale=ks, v_scale=vs, **sel)
                    want = pa.paged_attention_partial_ref(
                        qh, sk[0], sk[1], base, length, window=window,
                        kv_quant=kvq, k_scale=sk[2], v_scale=sk[3])
                    want32 = None
                    if fmt == "bf16":
                        want32 = pa.paged_attention_partial_ref(
                            qh, sk[0].float(), sk[1].float(), base, length,
                            window=window)
                    errs["B1"] = max(errs["B1"], hold_case(
                        f"{label} B1", got, want, fmt, want32))
                    got = pa.paged_attention_partial(
                        qh, sp[0], sp[1], base, length, window=window,
                        kv_quant=kvq, k_scale=sp[2], v_scale=sp[3],
                        page_table=table, **sel)
                    want = pa.paged_attention_shared_ref(
                        qh, ss[0], ss[1], table, base, length,
                        window=window, kv_quant=kvq, k_scale=ss[2],
                        v_scale=ss[3])
                    if fmt == "bf16":
                        want32 = pa.paged_attention_shared_ref(
                            qh, ss[0].float(), ss[1].float(), table, base,
                            length, window=window)
                    errs["B2"] = max(errs["B2"], hold_case(
                        f"{label} B2", got, want, fmt, want32))
                    n += 2
    for S, windows in b4_cases:
        errs.setdefault("B4", 0.0)
        q, k, v = flash_inputs(1, S, S, cfg.n_heads, K, dh, torch.float32,
                               gen)
        for window in windows:
            got = fa.flash_attention(q, k, v, causal=True, window=window)
            want = fa.flash_attention_ref(q, k, v, causal=True,
                                          window=window)
            err = close_err(got, want, FLASH_TOL["f32"])
            abs_o = float((got - want).abs().max())
            print(f"{tag} kernels: B4 {S} positions {cfg.n_heads}/{K} heads "
                  f"x {dh} window {window}: max_abs_err {abs_o:.3e} "
                  f"rel_err={err:.3e} tol={FLASH_TOL['f32']:.0e}")
            check(err <= FLASH_TOL["f32"], f"{tag} kernels: B4 at {S} "
                  f"positions, window {window}, disagrees with its plain "
                  "version")
            errs["B4"] = max(errs["B4"], abs_o)
            n += 1
    if b3_cases:
        errs["B3"] = 0.0
        Ms, shapes = b3_cases
        for M in Ms:
            for label, D, F in shapes:
                errs["B3"] = max(errs["B3"], gemv_hold_case(
                    "w4a16", M, f"{cfg.name} {label}", D, F, gen))
                n += 1
    torch.cuda.synchronize()
    print(f"{tag} kernels: {n} cases within tolerance; max_abs_err {errs}")
    return errs


def arch_timing_phase(rate, seed, paged, flash, gemvs) -> dict:
    """Each kernel timed at a model's serving shapes: B1 and B2 at each
    (label, B, K, G, NP, T, dh) of `paged`, every slot NP x T tokens long
    (bf16 pages; B2 over a pool of B x NP + 8 pages), B4 at `flash`'s
    (label, S, H, K, dh) in f32, B3 W4A16 at each (label, M, D, F) of
    `gemvs`."""
    import torch
    gen = torch.Generator(device="cuda").manual_seed(seed)
    flush = torch.empty(64 * 2 ** 20, dtype=torch.float32, device="cuda")
    rows = {"B1": [], "B2": [], "B3": [], "B4": []}
    for label, B, K, G, NP, T, dh in paged:
        L = NP * T
        rows["B1"].append(timing_shape(label, B, K, G, NP, T, dh, [L] * B, 0,
                                       rate, flush, gen))
        rows["B2"].append(shared_timing_shape(label, B, K, G, NP, T, dh,
                                              [L] * B, B * NP + 8, 0, rate,
                                              flush, gen))
    label, S, H, K, dh = flash
    rows["B4"].append(flash_timing_shape(label, 1, S, H, K, dh, "float32",
                                         rate, flush, gen, 10))
    for label, M, D, F in gemvs:
        rows["B3"].append(quant_timing_shape(label, "w4a16", M, D, F, rate,
                                             flush, gen))
    return rows


def window_kernel_phase(cfg) -> dict:
    """B1, B2 and B4 at the shapes G1's main path gives them: the decode
    step's ring (4 slots x 8 kv heads x 2 queries x dh 256, 65 pages of
    16, the bases a ring leaves after 28, 83, 1053 and 1123 tokens; window
    1024) and global pool (128 pages) in kv8 and f32; and the splice
    admit's one-shot prefill (2047-token bucket, 16 heads / 8 kv x 256,
    f32) with the local layers' window and without."""
    return arch_kernel_phase("G1", cfg, 21, (28, 83, 1053, 1123), (16,),
                             GEMMA_CTX, True, ("kv8", "f32"),
                             ((2047, (cfg.window, None)),))


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
          f"{lp_tol:.2g}); max gap at one {gap:.3e} (tol {gap_tol:.2g})")
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


# ---------------------------------------------------------------------------
# phases 17-19: the tiered pool (T1), the overlapped schedule (O1), the
# HTTP front end (H1)
# ---------------------------------------------------------------------------

TIER_FLASH_PAGES = 512   # T1's flash pool (total_pages)
TIER_LP_TOL = {"float32": 1e-5, "kv8": KV8_GAP_TOL}


def tier_waves(V):
    """T1's three waves: A, 8 distinct 256-token prefixes plus 8-40-token
    suffixes; B, 8 unrelated prompts of 100-300 tokens, which demote A's
    cached pages; C, A's prefixes again with new suffixes."""
    import numpy as np
    rng = np.random.default_rng(7)
    prefixes = [rng.integers(0, V, 256).tolist() for _ in range(8)]

    def suffixed():
        return [p + rng.integers(0, V, int(rng.integers(8, 41))).tolist()
                for p in prefixes]

    wave_a = suffixed()
    wave_b = [rng.integers(0, V, int(rng.integers(100, 301))).tolist()
              for _ in range(8)]
    return wave_a, wave_b, suffixed()


def pool_gb(srv) -> float:
    c = srv._batcher.cache
    return sum(t.numel() * t.element_size()
               for t in (c.k_pages_g, c.v_pages_g, c.k_scale_g, c.v_scale_g)
               if t is not None) / 1e9


def tier_run(label, params, waves, hot_pages, prefetch, **engine):
    """One T1 run: the three waves through one server, the launch
    counters reset before and read after, the peak device memory over the
    run (weights included)."""
    import gc
    import torch
    from repro_torch.kernels.paged_attention import launches, launches_shared
    from repro_torch.serving.api import SamplingParams
    gc.collect()        # an earlier run's pool (the tier's release hook
    torch.cuda.synchronize()    # makes a cycle)
    torch.cuda.reset_peak_memory_stats()
    srv = build_server(params, shared_pool=True,
                       total_pages=TIER_FLASH_PAGES, hot_pages=hot_pages,
                       server={"tier_prefetch": prefetch}, **engine)
    b = srv._batcher
    launches.reset()
    launches_shared.reset()
    steps0 = srv.stats["decode_steps"]
    t0 = time.perf_counter()
    outs = []
    for wave in waves:
        outs += srv.generate(wave, SamplingParams(max_new_tokens=16,
                                                  logprobs=True))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    steps = srv.stats["decode_steps"] - steps0
    st = srv.stats
    L = srv.cfg.n_layers
    check(all(len(o.token_ids) == 16 and o.finish_reason == "length"
              for o in outs), f"T1 {label}: not every request answered")
    check(launches_shared.value == steps * L and launches.value == 0,
          f"T1 {label}: B2 launches {launches_shared.value} != decode "
          f"steps {steps} x {L} (B1 {launches.value})")
    b.alloc.check()
    res = {"hot_pages": hot_pages, "prefetch": prefetch,
           "decode_steps": steps, "launches_B2": launches_shared.value,
           "wall_s": wall, "pool_gb": pool_gb(srv),
           "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
           "prefix_hit_pages": st["prefix_hit_pages"],
           "cow_copies": st["cow_copies"]}
    if b.tier is not None:
        b.tier.check()
        check(b.tier.pinned_count == 0,
              f"T1 {label}: {b.tier.pinned_count} hot pages pinned after "
              "the drain")
        res.update({k: st[k] for k in st if k.startswith("tier_")})
    print(f"T1 {label}: {steps} decode steps, B2 {launches_shared.value}, "
          f"{wall:.3f} s, pool {res['pool_gb']:.3f} GB, peak "
          f"{res['peak_memory_gb']:.3f} GB; "
          + ", ".join(f"{k}={v}" for k, v in res.items()
                      if k.startswith("tier_")) + f"; on {smi_line()}")
    return res, outs


def tier_phase(params=None) -> dict:
    """Phase 17, T1: the tiered pool (hot tier + capacity store with
    queue-ahead prefetch) at full width, f32 and kv8, each tiered with and
    without prefetch and flat, on the same three waves."""
    from repro_torch.configs import get_config
    from repro_torch.core import dse, flashsim
    cfg = get_config("qwen1.5-0.5b")
    hot = dse.recommend_hot_pages(flashsim.kvnand_c(), cfg, 512, slots=4,
                                  page_tokens=16,
                                  total_pages=TIER_FLASH_PAGES)
    check(hot == 128, f"recommend_hot_pages gave {hot}, not the 4-slot "
          "working set of 128 pages")
    if params is None:
        params = build_server().params
    waves = tier_waves(cfg.vocab_size)
    res = {"hot_pages": hot, "flash_pages": TIER_FLASH_PAGES}
    for fmt, engine in (("float32", {"kv_dtype": "float32"}),
                        ("kv8", {"kv_quant": "kv8"})):
        runs = {}
        for name, h, pf in (("prefetch", hot, True),
                            ("no_prefetch", hot, False),
                            ("flat", 0, True)):
            runs[name] = tier_run(f"{fmt} {name}", params, waves, h, pf,
                                  **engine)
        flat = runs["flat"][1]
        for name in ("prefetch", "no_prefetch"):
            outs = runs[name][1]
            check([o.token_ids for o in outs] == [o.token_ids for o in flat],
                  f"T1 {fmt} {name}: other tokens than the flat pool")
            gap = max(abs(a - b) for o, f in zip(outs, flat)
                      for a, b in zip(o.logprobs, f.logprobs))
            check(gap <= TIER_LP_TOL[fmt], f"T1 {fmt} {name}: logprobs "
                  f"{gap:.3e} from the flat pool's (tol "
                  f"{TIER_LP_TOL[fmt]:.0e})")
            runs[name][0]["logprob_gap_to_flat"] = gap
        on, off = runs["prefetch"][0], runs["no_prefetch"][0]
        check(on["tier_demotes"] > 0 and on["tier_promotes"] > 0
              and on["tier_prefetch_pages"] > 0,
              f"T1 {fmt}: the tier never demoted, promoted or prefetched")
        check(on["tier_stall_tokens"] < off["tier_stall_tokens"],
              f"T1 {fmt}: prefetch did not cut the stall tokens "
              f"({on['tier_stall_tokens']} vs {off['tier_stall_tokens']})")
        res[fmt] = {k: v[0] for k, v in runs.items()}
    res["launches_B2"] = sum(r["launches_B2"] for fmt in ("float32", "kv8")
                             for r in res[fmt].values())
    return res


def mixed_params(stop):
    """O1's sampling params for the 6 stripe prompts: greedy with
    logprobs, seeded temperature, top-k, top-k/top-p, greedy with stop
    tokens, greedy."""
    from repro_torch.serving.api import SamplingParams
    return [SamplingParams(max_new_tokens=16, logprobs=True),
            SamplingParams(max_new_tokens=16, temperature=0.9, seed=3,
                           logprobs=True),
            SamplingParams(max_new_tokens=12, temperature=1.2, top_k=5,
                           seed=9),
            SamplingParams(max_new_tokens=16, temperature=0.8, top_p=0.9,
                           top_k=7, seed=11, logprobs=True),
            SamplingParams(max_new_tokens=16, stop_token_ids=stop,
                           logprobs=True),
            SamplingParams(max_new_tokens=14)]


O1_DEPLOYMENTS = (
    ("stripe bf16", {}, {}),
    ("shared f32", {"shared_pool": True, "kv_dtype": "float32"}, {}),
    ("tiered f32", {"shared_pool": True, "kv_dtype": "float32",
                    "total_pages": TIER_FLASH_PAGES, "hot_pages": 128}, {}),
    ("stripe spec4", {}, {"speculation_k": 4}),
)


def sync_probe(srv) -> str:
    """Drive 4 requests (O1's first 4 sampling params) into decode on
    `srv` (built with overlap=True), then run a decode-only dispatch, and
    a second one chained on it, under `set_sync_debug_mode("error")`:
    returns "none" when neither synchronizes the host with the card, else
    the first synchronizing call site in the port."""
    import traceback
    import torch
    prompts = stripe_prompts(srv.cfg.vocab_size)[:4]
    # greedy and seeded sampling rows, so the sampler's noise is drawn
    uids = [srv.submit(p, sp) for p, sp in zip(prompts, mixed_params(()))]
    b = srv._batcher
    while b.queue or b._prefill_live or not all(
            srv._requests[u].output for u in uids):
        srv.step()
    srv.step()                        # one decode step with every slot
    check(all(r is not None for r in b.slots), "a probe slot finished early")
    torch.cuda.synchronize()
    site = "none"
    torch.cuda.set_sync_debug_mode("error")
    try:
        srv.dispatch()
        srv.dispatch()
    except RuntimeError as e:
        frames = [f for f in traceback.extract_tb(e.__traceback__)
                  if "repro_torch" in f.filename]
        f = frames[-1] if frames else None
        site = (f"{Path(f.filename).name}:{f.lineno} {f.line}" if f
                else str(e).splitlines()[0])
    finally:
        torch.cuda.set_sync_debug_mode("default")
    return site


def overlap_phase(params=None) -> dict:
    """Phase 18, O1: each deployment served synchronously and overlapped
    on the stripe prompts under mixed sampling params; then the
    decode-only dispatch probed for host syncs."""
    import torch
    from repro_torch.kernels.paged_attention import launches, launches_shared
    from repro_torch.serving.api import SamplingParams
    from repro_torch.configs import get_config
    if params is None:
        params = build_server().params
    prompts = stripe_prompts(get_config("qwen1.5-0.5b").vocab_size)
    # a stop token that the greedy request first samples at index >= 3
    pre = build_server(params).generate(
        [prompts[4]], SamplingParams(max_new_tokens=16))[0].token_ids
    j = next((j for j in range(3, 16) if pre[j] not in pre[:j]), 15)
    params_list = mixed_params((pre[j],))
    res = {"stop_token": pre[j]}
    for name, engine, server in O1_DEPLOYMENTS:
        runs = {}
        for overlap in (False, True):
            srv = build_server(params, server=dict(server, overlap=overlap),
                               **engine)
            launches.reset()
            launches_shared.reset()
            t0 = time.perf_counter()
            outs = srv.generate(prompts, params_list)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            st = srv.stats
            L = srv.cfg.n_layers
            steps = st["decode_steps"]
            kernel = launches_shared if engine.get("shared_pool") else launches
            other = launches if engine.get("shared_pool") else launches_shared
            check(kernel.value == steps * L and other.value == 0,
                  f"O1 {name}: launches {kernel.value} / {other.value} != "
                  f"decode steps {steps} x {L} / 0")
            runs[overlap] = outs, {
                "wall_s": wall, "decode_steps": steps,
                "verify_steps": st["verify_steps"],
                "launches": kernel.value,
                "phantom_tokens": st["phantom_tokens"],
                "device_idle_s": st["device_idle_s"],
                "finish": [o.finish_reason for o in outs]}
        (o_sync, r_sync), (o_over, r_over) = runs[False], runs[True]
        for a, b in zip(o_sync, o_over):
            check((a.token_ids, a.logprobs, a.finish_reason)
                  == (b.token_ids, b.logprobs, b.finish_reason),
                  f"O1 {name}: the overlapped schedule served request "
                  f"{a.uid} otherwise")
        res[name] = {"sync": r_sync, "overlap": r_over}
        print(f"O1 {name}: sync {r_sync['wall_s']:.3f} s ({r_sync['decode_steps']}"
              f" steps, idle {r_sync['device_idle_s']:.3f} s), overlap "
              f"{r_over['wall_s']:.3f} s ({r_over['decode_steps']} steps, "
              f"idle {r_over['device_idle_s']:.3f} s, "
              f"{r_over['phantom_tokens']} phantom tokens); finishes "
              f"{r_sync['finish']}; on {smi_line()}")
    res["sync_probe"] = {}
    for name, engine, server in O1_DEPLOYMENTS[:3]:
        site = sync_probe(build_server(
            params, server=dict(server, overlap=True), **engine))
        res["sync_probe"][name] = site
        print(f"O1 {name}: decode-only dispatch under "
              f"set_sync_debug_mode('error'): first host sync {site}")
    check(res["sync_probe"]["stripe bf16"] == "none",
          "O1: a decode-only dispatch on the stripe pool synchronizes: "
          + res["sync_probe"]["stripe bf16"])
    res["launches_B1"] = sum(res[n][k]["launches"] for n, e, _ in
                             O1_DEPLOYMENTS if not e.get("shared_pool")
                             for k in ("sync", "overlap"))
    res["launches_B2"] = sum(res[n][k]["launches"] for n, e, _ in
                             O1_DEPLOYMENTS if e.get("shared_pool")
                             for k in ("sync", "overlap"))
    return res


def http_phase(params=None) -> dict:
    """Phase 19, H1: the HTTP front end around the full-width shared f32
    pool, overlapped engine loop: 6 concurrent completions (3 one-shot, 3
    SSE), each equal to the facade's `generate` on an identically
    configured server; GET /metrics reports the served counts."""
    import http.client
    import threading
    import torch
    from repro_torch.kernels.paged_attention import launches_shared
    from repro_torch.serving.api import KVNANDServer, SamplingParams
    from repro_torch.serving.async_server import (AsyncServerConfig,
                                                  BackgroundServer)
    if params is None:
        params = build_server().params
    from repro_torch.configs import get_config
    engine = {"shared_pool": True, "kv_dtype": "float32"}
    prompts = stripe_prompts(get_config("qwen1.5-0.5b").vocab_size)
    want = [o.token_ids for o in build_server(params, **engine).generate(
        prompts, SamplingParams(max_new_tokens=16))]
    got, errors = [None] * 6, []

    def fire(k):
        try:
            stream = k % 2 == 1
            conn = http.client.HTTPConnection(*srv.address, timeout=300)
            try:
                conn.request("POST", "/v1/completions", json.dumps(
                    {"prompt": prompts[k], "max_tokens": 16,
                     "stream": stream}))
                r = conn.getresponse()
                raw = r.read().decode()
            finally:
                conn.close()
            check(r.status == 200, f"H1 request {k}: HTTP {r.status}")
            if stream:
                got[k] = [json.loads(f[6:])["choices"][0]["token"]
                          for f in raw.split("\n\n")
                          if f.startswith("data: {")]
            else:
                got[k] = json.loads(raw)["choices"][0]["token_ids"]
        except Exception as e:       # noqa: BLE001 — reported below
            errors.append(f"request {k}: {e!r}")

    launches_shared.reset()
    import dataclasses
    L = params["layers"]["ln1"].shape[0]
    with BackgroundServer(server_config(**engine),
                          AsyncServerConfig(overlap=True),
                          cfg=dataclasses.replace(
                              get_config("qwen1.5-0.5b"), n_layers=L),
                          params=params) as srv:
        t0 = time.perf_counter()
        threads = [threading.Thread(target=fire, args=(k,))
                   for k in range(6)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
        wall = time.perf_counter() - t0
        check(not any(t.is_alive() for t in threads),
              "H1: a request did not finish within 300 s")
        conn = http.client.HTTPConnection(*srv.address, timeout=60)
        try:
            conn.request("GET", "/metrics")
            text = conn.getresponse().read().decode()
        finally:
            conn.close()
        inner = srv.server._server
        steps = inner.stats["decode_steps"]
    check(not errors, f"H1: {errors}")
    check(not srv._thread.is_alive(), "H1: the HTTP thread did not stop")
    check(got == want, "H1: the HTTP answers differ from generate()")
    counts = {line.split()[0]: float(line.split()[1])
              for line in text.splitlines()
              if line and not line.startswith("#")}
    check(counts.get('kvnand_requests_finished_total{reason="length"}') == 6
          and counts.get("kvnand_ttft_seconds_count") == 6
          and counts.get("kvnand_decode_tokens_total") == 6 * 15,
          f"H1: /metrics does not report the 6 served requests: "
          f"{ {k: v for k, v in counts.items() if 'total' in k} }")
    check(launches_shared.value == steps * L,
          f"H1: B2 launches {launches_shared.value} != decode steps "
          f"{steps} x {L}")
    print(f"H1: 6 concurrent completions (3 one-shot, 3 SSE) in {wall:.3f} "
          f"s, equal to generate(); {steps} decode steps, B2 "
          f"{launches_shared.value}; on {smi_line()}")
    return {"wall_s": wall, "decode_steps": steps,
            "launches_B2": launches_shared.value,
            "metrics": {k: v for k, v in counts.items()
                        if k.startswith("kvnand_") and "quantile" not in k}}


# ---------------------------------------------------------------------------
# phase 21: Y1, full-width hymba-1.5b (the hybrid family)
# ---------------------------------------------------------------------------

HYMBA_CTX = 2048         # --max-context at which the DSE picks kv8 pages
# Y1's depth, cut from 32 so that the whole run stays well inside its time
# limit (see LLAMA2_LAYERS): 23 local layers and the global layer 15
HYMBA_LAYERS = 24
HYMBA_NEW = 24           # new tokens a request
# with the 128 meta tokens: the 1100-token prompt wraps the 1040-token ring
# of 16-token pages in prefill (1228 positions), the 900-token one in
# decode (1028 + 24 > 1040)
HYMBA_PROMPT_LENS = (5, 17, 60, 200, 900, 1100)
# the longest prompt the CPU side of the DSE check prefills: 200 in
# `--hybrid`; the default run cuts it to HYMBA_CPU_PROMPT_CUT since L1
# came (the 200-token prompt took 54 s of the CPU side on a slow host, and
# its plain-GEMV control read lowest, 6.16e-2; PERF.md, PR 27)
HYMBA_CPU_PROMPT, HYMBA_CPU_PROMPT_CUT = 200, 60
# The DSE pick's prefill logits, the card against the CPU computing B3's
# function (`b3_function`), ||card - CPU|| / ||CPU|| at the last token.
# Hymba's random model amplifies the f32-level differences of a sound
# card run (2e-5 at f32 weights) through the bf16 rounding of x in 320
# projections a forward: on an H100 (PERF.md, Y1) B3 reads at most
# 3.29e-2 over the 4 short prompts, and the plain version on the card,
# which rounds each product to bf16, at most 1.10e-1 against B3.  The
# bound lies between the two, and the run checks that the plain version
# on the card reads above it.
HYMBA_PREFILL_TOL = 4.5e-2
# kv8 pages against f32 pages on the same model: the served tokens part
# where kv8's noise outweighs a logit margin.  On an H100 (PERF.md, Y1)
# the gap at a divergence reads at most 1.271e-2, the served logprobs
# before one 2.265e-2 and against the plain forward 2.931e-2; the bound
# is about twice the largest.  The tight check of the kv8 path is the
# second kv8 run (shared against stripe) within KV8_GAP_TOL, as G1's.
KV8_F32_TOL = 5e-2
# B3's projections a hybrid layer sends through the kernel: wo, gate, up,
# down and the SSM mixer's in_x, in_z, w_b, w_c, w_dt, out (wq/wk/wv are
# dequantized, as in the reference)
HYMBA_B3_PER_LAYER = 10
# B3 at hymba's projection shapes: (label, D, F); the kv projection's
# 1600 -> 320 beside the shapes the path launches
HYMBA_GEMV_SHAPES = (("w_dt", 1600, 1), ("w_b/w_c", 1600, 16),
                     ("wk/wv", 1600, 320),
                     ("in_x/in_z/out/wo", 1600, 1600),
                     ("gate/up", 1600, 5504), ("down", 5504, 1600))


def hymba_prompts(V):
    import numpy as np
    rng = np.random.default_rng(8)
    return [rng.integers(0, V, n).tolist() for n in HYMBA_PROMPT_LENS]


def hymba_params():
    """Full-width hymba-1.5b cut to HYMBA_LAYERS layers, its random
    float32 weights on the card, seed 0."""
    import dataclasses
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models.registry import Model
    cfg = get_config("hymba-1.5b")
    check(cfg.family == "hybrid" and cfg.n_layers == 32
          and cfg.d_model == 1600 and cfg.n_heads == 25
          and cfg.n_kv_heads == 5 and cfg.d_head == 64 and cfg.d_ff == 5504
          and cfg.vocab_size == 32001 and cfg.padded_vocab == 32256
          and not cfg.tie_embeddings and cfg.ssm_state == 16
          and cfg.window == 1024 and cfg.n_meta_tokens == 128
          and [i for i in range(32) if cfg.is_global_layer(i)] == [15, 31],
          "not the full-width hymba-1.5b")
    cfg = dataclasses.replace(cfg, n_layers=depth(HYMBA_LAYERS, 32))
    t0 = time.perf_counter()
    params = Model(cfg).init(torch.Generator(device="cuda").manual_seed(0))
    torch.cuda.synchronize()
    n = sum(t.numel() for t in _leaves(params))
    print(f"Y1: {cfg.name} weights, {n / 1e9:.3f}B params ({4 * n / 1e9:.2f}"
          f" GB float32), drawn on the card in {time.perf_counter() - t0:.2f}"
          " s")
    return cfg, params


def hymba_kernel_phase(cfg) -> dict:
    """B1, B2, B3 and B4 at the shapes Y1's main path gives them: B1/B2 at
    4 slots x 5 kv heads x G = 5 queries x dh 64, pages of 16 and 64 tokens
    (the DSE's), the ring (ceil(1024 / T) + 1 pages, the bases a ring
    leaves after 133, 1033, 1228 and 1252 positions; window 1024) and the
    global pool (HYMBA_CTX / T pages), in f32, bf16, kv8 and kv4.  B4: the
    one-shot prefill of the longest prompt with its meta tokens (1228
    positions, 25 / 5 heads x 64, f32), with the local layers' window and
    without.  B3: W4A16 at hymba's projection shapes, M = 4 (a decode
    step), 64 and 1228 (a whole-prompt chunk)."""
    check(cfg.group_size == 5, "Y1 kernels: hymba's head group is not 5")
    S = cfg.n_meta_tokens + max(HYMBA_PROMPT_LENS)
    return arch_kernel_phase(
        "Y1", cfg, 24, (133, 1033, 1228, 1252), (16, 64), HYMBA_CTX, True,
        ("f32", "bf16", "kv8", "kv4"), ((S, (cfg.window, None)),),
        ((4, 64, S), HYMBA_GEMV_SHAPES))


def hymba_timing_phase(rate) -> dict:
    """Each kernel timed at Y1's serving shapes: B1 and B2 over a full ring
    of the decode step (4 slots x 5 kv heads x G = 5, dh 64; 1040 tokens
    of 16-token pages, and 1088 of the DSE's 64-token ones), B4 on the
    longest admit (1228 positions), B3 at a decode step's M = 4 over each
    projection shape the path launches."""
    return arch_timing_phase(
        rate, 25, [(f"hymba ring T={T}", 4, 5, 5, NP, T, 64)
                   for T, NP in ((16, 65), (64, 17))],
        ("hymba admit", 128 + max(HYMBA_PROMPT_LENS), 25, 5, 64),
        [(f"hymba {label}, serving", 4, D, F)
         for label, D, F in HYMBA_GEMV_SHAPES if label != "wk/wv"])


def hymba_golden_phase(cfg, params):
    """Y1 golden: the 1100-token prompt as ONE whole-prompt chunk (the
    meta tokens first: 1228 positions, wrapping the ring) into an f32
    stripe pool, engine-level, then 8 greedy decode steps; every step's
    logits against the port's plain full forward on the card (kernel-free)
    over the prompt and the emitted tokens, within GOLDEN_TOL of max
    |logits|, and the same argmax at every step."""
    import torch
    from repro_torch.configs import EngineConfig
    from repro_torch.core.engine import KVNANDEngine
    from repro_torch.kernels.paged_attention import launches
    from repro_torch.models.registry import Model
    t0 = time.perf_counter()
    eng = KVNANDEngine(cfg, EngineConfig(page_tokens=16,
                                         uniform_lengths=False,
                                         kv_dtype="float32"), device="cuda")
    prompt = hymba_prompts(cfg.vocab_size)[-1]
    n, V = len(prompt), cfg.vocab_size
    cache = eng.init_cache(1, HYMBA_CTX)
    with torch.no_grad():
        toks = torch.tensor([prompt], device="cuda")
        lg, _ = eng.prefill_chunk(params, cache, {"tokens": toks}, 0, 0, n,
                                  first=True)
        check(int(cache.lengths[0]) == cfg.n_meta_tokens + n,
              "Y1 golden: the slot's length does not count the meta tokens")
        rows, out = [lg[0, :V]], [int(lg[0, :V].argmax())]
        launches.reset()
        for _ in range(8):
            lg, _ = eng.decode_step(params, cache, torch.tensor(
                [[out[-1]]], device="cuda"))
            rows.append(lg[0, :V])
            out.append(int(lg[0, :V].argmax()))
        b1 = launches.value
        ring = cache.page_pos_w[0].tolist()
        state = cache.ssm_state.abs().max().item()
        got = torch.stack(rows).float()
        full = Model(cfg).forward(params, {"tokens": torch.tensor(
            [prompt + out[:8]], device="cuda")})[0, n - 1:, :V].float()
    torch.cuda.synchronize()
    err = float((got - full).abs().max() / full.abs().max())
    want = full.argmax(-1).tolist()
    wall = time.perf_counter() - t0
    print(f"Y1 golden: 1100-token prompt (+128 meta) as one chunk + 8 decode"
          f" steps, f32 stripe pool: max |logits - plain forward| / max "
          f"|logits| = {err:.3e} (tol {GOLDEN_TOL:.0e}); argmax {out} vs "
          f"{want}; ring bases {sorted(ring)[:2]}..{sorted(ring)[-2:]}; max "
          f"|ssm_state| {state:.3e}; B1 launches {b1}; {wall:.3f} s")
    check(b1 == 8 * cfg.n_layers, f"Y1 golden: B1 launches {b1} != 8 x "
          f"{cfg.n_layers}")
    check(max(ring) >= ring_tokens(cfg) and min(ring) >= 0,
          "Y1 golden: the ring did not wrap")
    check(state > 0 and bool(torch.isfinite(cache.ssm_state).all()),
          "Y1 golden: the SSM state is zero or not finite")
    check(err <= GOLDEN_TOL, "Y1 golden: logits disagree with the plain "
          "forward")
    check(out == want, "Y1 golden: a greedy token differs from the plain "
          "forward's")
    del eng, cache, full
    torch.cuda.empty_cache()
    return {"rel_err": err, "tokens": out, "launches_B1": b1,
            "wall_s": wall}


def hymba_engine_config(**over):
    """f32 pages of 16 tokens, compact, as `launch/serve.py` serves
    without `--use-dse`, and `over`."""
    from repro_torch.configs import EngineConfig
    return EngineConfig(**{"page_tokens": 16, "uniform_lengths": False,
                           "kv_dtype": "float32", **over})


def hymba_dse_engine_config():
    """The design-space search's pick at HYMBA_CTX, asserted compact,
    64-token pages, W4A16, kv8, one partition, served as it is (its page
    size and ragged appends)."""
    from repro_torch.configs import EngineConfig
    from repro_torch.core.dse import recommend_engine_config
    pick = recommend_engine_config("hymba-1.5b", HYMBA_CTX)
    check(pick.variant == "compact" and not pick.hg_pipeline
          and pick.page_tokens == 64 and pick.quant == "w4a16"
          and pick.kv_quant == "kv8" and pick.attn_partitions == 1,
          f"the DSE's hymba-1.5b pick at {HYMBA_CTX} is not compact, "
          f"T=64, w4a16, kv8, one partition: {pick}")
    return EngineConfig(**{**pick.__dict__, "uniform_lengths": False})


def build_hymba_server(cfg, params, eng, scheduler="interleaved",
                       device="cuda", overlap=False):
    from repro_torch.serving.api import KVNANDServer, ServerConfig
    return KVNANDServer(ServerConfig(
        arch="hymba-1.5b", engine=eng, scheduler=scheduler, batch_slots=4,
        max_context=HYMBA_CTX, prefill_chunk_tokens=64, device=device,
        overlap=overlap), cfg=cfg, params=params)


def whole_prompt_logits(srv, prompt):
    """`prompt` prefilled as one whole-prompt chunk (its meta tokens
    first) into a fresh one-slot cache of the server's engine: its
    last-token logits over the vocabulary, on the CPU."""
    import torch
    b = srv._batcher
    cache = b.engine.init_cache(1, b.max_context)
    toks = torch.tensor([prompt], dtype=torch.long, device=b.device)
    with torch.no_grad():
        logits, _ = b.engine.prefill_chunk(b.params, cache, {"tokens": toks},
                                           0, 0, len(prompt), first=True)
    return logits.float().cpu()[..., :srv.cfg.vocab_size]


@contextlib.contextmanager
def b3_function():
    """W4A16 products computed as B3's own function, the TPU kernel's:
    f32(bf16(x) @ w4) x scale with a float64 accumulation (phase 7 holds
    B3 to it within GEMV_TPU_TOL), on whichever device x lies, in place
    of `layers.quant_gemv`.  The plain version differs from it: it rounds
    each product to bf16, as the reference's does."""
    import torch
    from repro_torch.core.quant import unpack_int4
    from repro_torch.models import layers

    def function(x, qw, impl="auto"):
        check(qw.scheme == "w4a16", "B3's function: W4A16 only")
        y = ((x.to(torch.bfloat16).double() @ unpack_int4(qw.q).double())
             * qw.scale.double())
        return y.to(x.dtype)

    plain = layers.quant_gemv
    layers.quant_gemv = function
    try:
        yield
    finally:
        layers.quant_gemv = plain


@contextlib.contextmanager
def plain_gemv():
    """`layers.quant_gemv` forced onto its plain version on every device."""
    from repro_torch.models import layers
    real = layers.quant_gemv
    layers.quant_gemv = lambda x, qw, impl="auto": real(x, qw, impl="ref")
    try:
        yield
    finally:
        layers.quant_gemv = real


def hymba_replica_run(cfg, params, prompts, solo_outs) -> dict:
    """Two replicas on Y1's weights (f32, 16-token pages, shared pools):
    replica 0 prefills every request, each migrates once through the
    envelope's wire bytes (window and global pages, the ring bases, the
    SSM state and conv tail rows) and decodes on replica 1; the tokens
    are one shared-pool server's (or part only at a near tie)."""
    import torch
    import repro_torch.serving.router as router_mod
    from repro_torch.kernels import flash_attention, quant_gemv, wkv6
    from repro_torch.kernels.paged_attention import launches, launches_shared
    from repro_torch.serving.api import SamplingParams, ServerConfig
    from repro_torch.serving.replica import build_replica
    eng = hymba_engine_config(shared_pool=True)
    reps = [build_replica(ServerConfig(
        arch="hymba-1.5b", engine=eng, batch_slots=4, max_context=HYMBA_CTX,
        prefill_chunk_tokens=64), cfg=cfg, params=params, device="cuda")
        for _ in range(2)]
    check(all(r.params["embedding"] is params["embedding"] for r in reps),
          "Y1 replicas: a replica copied the weights")
    router = router_mod.ReplicaRouter(reps, disaggregate=True)
    counters = {"B1": launches, "B2": launches_shared,
                "B3": quant_gemv.launches, "B4": flash_attention.launches,
                "B5": wkv6.launches}
    steps0 = [r.stats["decode_steps"] for r in reps]
    for c in counters.values():
        c.reset()
    t0 = time.perf_counter()
    sp = SamplingParams(max_new_tokens=HYMBA_NEW, logprobs=True)
    uids = [router.submit(p, sp) for p in prompts]
    router.run()
    outs = [router.output(u) for u in uids]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = {k: c.value for k, c in counters.items()}
    steps = [r.stats["decode_steps"] - s for r, s in zip(reps, steps0)]
    st = router.stats
    L = cfg.n_layers
    print(f"Y1 replicas: {st['migrations']} migrations "
          f"({st['migration_bytes']} wire bytes), decode steps per replica "
          f"{steps}, launches {counts}, {wall:.3f} s")
    check(st["migrations"] == len(prompts) and steps[0] == 0,
          "Y1 replicas: not every request migrated once to the decode "
          "replica")
    check(counts["B2"] == sum(steps) * L
          and all(counts[k] == 0 for k in ("B1", "B3", "B4", "B5")),
          f"Y1 replicas: launches {counts} != (B2 decode steps "
          f"{sum(steps)} x {L}, B1/B3-B5 0)")
    for r in reps:
        r._batcher.alloc.check()
        r._batcher.alloc_w.check()
    same, before, gap = near_tie_check("Y1 replicas vs one shared server",
                                       outs, solo_outs, LOGIT_GAP_TOL)
    res = {"migrations": st["migrations"],
           "migration_bytes": st["migration_bytes"], "decode_steps": steps,
           "launches_B2": counts["B2"], "wall_s": wall,
           "same_as_one_server": same, "logprob_err": before,
           "max_gap_at_divergence": gap}
    del router, reps
    return res


def hybrid_phases(rate) -> dict:
    """Phase 21, Y1 (see the module docstring)."""
    import gc
    import torch
    from repro_torch.core.quant import quantize_params
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    cfg, params = hymba_params()
    L, K = cfg.n_layers, cfg.n_kv_heads
    res = {"kernels": hymba_kernel_phase(cfg),
           "timing": hymba_timing_phase(rate),
           "golden": hymba_golden_phase(cfg, params)}
    prompts = hymba_prompts(cfg.vocab_size)
    runs = {}
    zero = {k: 0 for k in ("B1", "B2", "B3", "B4", "B5")}
    for key, label, over, sched, overlap, want in (
            ("stripe", "Y1 stripe f32", {}, "interleaved", False,
             lambda s, a: {"B1": s * L}),
            ("shared", "Y1 shared f32", {"shared_pool": True},
             "interleaved", False, lambda s, a: {"B2": s * L}),
            ("splice", "Y1 splice f32", {}, "splice", False,
             lambda s, a: {"B1": s * L, "B4": a * L}),
            ("discrete", "Y1 discrete (KVNAND-D) f32",
             {"variant": "discrete"}, "interleaved", False,
             lambda s, a: {"B1": s * L * K}),
            ("kv8", "Y1 stripe kv8", {"kv_quant": "kv8"}, "interleaved",
             False, lambda s, a: {"B1": s * L}),
            ("kv8_shared", "Y1 shared kv8",
             {"kv_quant": "kv8", "shared_pool": True}, "interleaved",
             False, lambda s, a: {"B2": s * L}),
            ("overlap", "Y1 overlapped stripe f32", {}, "interleaved", True,
             lambda s, a: {"B1": s * L})):
        srv = build_hymba_server(cfg, params, hymba_engine_config(**over),
                                 sched, overlap=overlap)
        outs, counts, steps, wall, tokens = serve(label, srv, prompts,
                                                  HYMBA_NEW)
        admits = counts["admits"]
        expect = {**zero, **want(steps, admits)}
        check(steps > 0 and counts == {**counts, **expect},
              f"{label}: launches {counts} != {expect} ({steps} decode "
              f"steps, {admits} admits x {L} layers)")
        if sched == "interleaved":
            check(counts["prefill_chunks"] == admits == len(prompts),
                  f"{label}: a prompt was not ONE whole-prompt chunk")
        if over.get("shared_pool"):
            b = srv._batcher
            check(b.prefix_cache is None, f"{label}: the prefix cache is on")
            b.alloc.check()
            b.alloc_w.check()
            check(b.alloc.live_count == 0 and b.alloc_w.live_count == 0,
                  f"{label}: pages still mapped after the drain")
        final = [cfg.n_meta_tokens + len(o.prompt) + len(o.token_ids) - 1
                 for o in outs]
        runs[key] = outs
        res[key] = {"decode_steps": steps, "admits": admits,
                    "launches": {k: counts[k] for k in zero}, "wall_s": wall,
                    "tokens": tokens, "final_lengths": final}
        if key == "stripe":
            print(f"{label}: final lengths {final} (meta tokens included; "
                  f"a ring holds {ring_tokens(cfg)} tokens)")
            check(final[4] > ring_tokens(cfg) > cfg.n_meta_tokens
                  + HYMBA_PROMPT_LENS[4], "Y1: no request wrapped its ring "
                  "during decode")
            lp, gap = teacher_forced_check(label, srv, outs)
            res[key].update(logprob_err_vs_plain_forward=lp, max_gap=gap)
        if key == "kv8":
            # kv8 codes against the plain forward's float K/V, as G1's
            # stripe run is held
            lp, gap = teacher_forced_check(label, srv, outs, argmax=False,
                                           tol=KV8_F32_TOL)
            res[key].update(logprob_err_vs_plain_forward=lp, max_gap=gap)
        del srv
    # the f32 runs differ in summation order only; the kv8 runs read their
    # K/V through kv8 codes, so they part from the f32 run where kv8's
    # noise outweighs a logit margin (KV8_F32_TOL), and from each other
    # only at a near tie (KV8_GAP_TOL)
    for key, ref, tols in (
            ("shared", "stripe", (LOGIT_GAP_TOL, LOGPROB_TOL)),
            ("splice", "stripe", (LOGIT_GAP_TOL, LOGPROB_TOL)),
            ("discrete", "stripe", (LOGIT_GAP_TOL, LOGPROB_TOL)),
            ("overlap", "stripe", (LOGIT_GAP_TOL, LOGPROB_TOL)),
            ("kv8", "stripe", (KV8_F32_TOL, KV8_F32_TOL)),
            ("kv8_shared", "kv8", (KV8_GAP_TOL, LOGPROB_TOL))):
        same, before, gap = near_tie_check(
            f"Y1 {key} vs {'stripe f32' if ref == 'stripe' else 'stripe kv8'}",
            runs[key], runs[ref], *tols)
        res[key].update(same_as_reference=same, logprob_err=before,
                        max_gap_at_divergence=gap)
    res["replicas"] = hymba_replica_run(cfg, params, prompts, runs["shared"])
    # the DSE's pick: W4A16 weights, kv8 pages of 64 tokens
    eng = hymba_dse_engine_config()
    qparams = quantize_params(params, "w4a16")
    srv = build_hymba_server(cfg, qparams, eng)
    label = "Y1 DSE pick (w4a16, kv8, T=64)"
    outs, counts, steps, wall, tokens = serve(label, srv, prompts, HYMBA_NEW)
    chunks = counts["prefill_chunks"]
    b3 = HYMBA_B3_PER_LAYER * L * (steps + chunks)
    check(steps > 0 and counts["B3"] == b3 and counts["B1"] == steps * L
          and all(counts[k] == 0 for k in ("B2", "B4", "B5")),
          f"{label}: launches {counts} != (B3 {HYMBA_B3_PER_LAYER} x {L} x "
          f"({steps} decode steps + {chunks} chunks), B1 {steps} x {L}, "
          "B2/B4/B5 0)")
    lp, _ = teacher_forced_check(label, srv, outs, argmax=False,
                                 tol=QUANT_LOGPROB_TOL)
    cpu = build_hymba_server(cfg, tree_to(qparams, "cpu"), eng,
                             device="cpu")
    longest = depth(HYMBA_CPU_PROMPT_CUT, HYMBA_CPU_PROMPT)
    short = [p for p in prompts if len(p) <= longest]
    t0 = time.perf_counter()
    cpu_logits = []
    with b3_function():
        for p in short:
            cpu_logits.append(whole_prompt_logits(cpu, p))
    cpu_wall = time.perf_counter() - t0
    gaps = {}
    for key, ctx in (("B3", contextlib.nullcontext),
                     ("function", b3_function), ("plain", plain_gemv)):
        with ctx():
            gaps[key] = [float((whole_prompt_logits(srv, p) - r).norm()
                               / r.norm())
                         for p, r in zip(short, cpu_logits)]
    for key, what in (("B3", "B3"), ("function", "B3's function in "
                      "float64 on the card too (the control of the gap's "
                      "cause)"), ("plain", "the plain version on the card "
                      "(the control of a B3 computing it)")):
        print(f"check {label}: {len(short)} prompts of <= "
              f"{longest} tokens prefilled through {what} against "
              f"the CPU computing B3's function ({cpu_wall:.3f} s), "
              f"||logit difference|| / ||CPU logits|| at the last token: "
              f"{', '.join(f'{g:.4e}' for g in gaps[key])} (tol "
              f"{HYMBA_PREFILL_TOL:.1e})")
    check(max(gaps["B3"]) <= HYMBA_PREFILL_TOL, f"{label}: prefill logits "
          "disagree with the CPU run")
    check(max(gaps["plain"]) > HYMBA_PREFILL_TOL, f"{label}: the gate "
          "cannot tell B3's function from the plain version's")
    res["dse"] = {"decode_steps": steps, "prefill_chunks": chunks,
                  "launches": {k: counts[k] for k in zero}, "wall_s": wall,
                  "tokens": tokens, "logprob_err_vs_plain_forward": lp,
                  "prefill_gaps": gaps["B3"],
                  "prefill_gaps_function_on_card": gaps["function"],
                  "prefill_gaps_plain_on_card": gaps["plain"],
                  "cpu_wall_s": cpu_wall}
    del srv, cpu, qparams, params
    gc.collect()
    res["peak_memory_gb"] = torch.cuda.max_memory_allocated() / 1e9
    torch.cuda.empty_cache()
    res["launches"] = {k: sum(r["launches"][k] for r in res.values()
                              if isinstance(r, dict) and "launches" in r
                              and isinstance(r["launches"], dict))
                       for k in zero}
    res["launches"]["B1"] += res["golden"]["launches_B1"]
    res["launches"]["B2"] += res["replicas"]["launches_B2"]
    print(f"Y1: launches on the main path {res['launches']}; peak memory "
          f"{res['peak_memory_gb']:.2f} GB; walls (s): "
          + ", ".join(f"{k} {v['wall_s']:.3f}" for k, v in res.items()
                      if isinstance(v, dict) and "wall_s" in v)
          + f"; on {smi_line()}")
    return res


# ---------------------------------------------------------------------------
# phase 22: E1, full-width mixtral-8x7b (the MoE family) at W4A16
# ---------------------------------------------------------------------------

MIXTRAL_CTX = 1024       # max_context of E1's servers
# E1's depth in the default run, cut from 32 to make room for P1 and W1
# (see LLAMA2_LAYERS), and from 16 to 8 for L1 (PERF.md, PR 27); at 4 its
# speculative run accepted no draft (PR 28); `--moe` runs all 32
MIXTRAL_LAYERS = 8
MIXTRAL_NEW = 16         # new tokens a request
# B3's launches a mixtral layer: wo only (wq/wk/wv are dequantized per
# head group and the experts by `moe`, as in the reference)
MIXTRAL_B3_PER_LAYER = 1
# `moe` on the card against the card machine's CPU, the same inputs and
# the same W4A16 layer (dequantized to float32 on each side): max |card -
# CPU| / max |CPU| of the output, with the kept / dropped sets equal
MOE_LAYER_TOL = 1e-4
# the golden run's logits (W4A16 weights, no drops) against the plain
# forward computing wo as B3's own function (`b3_function`), max |a - b| /
# max |b|.  The two differ by float32 summation order, which flips the
# bf16 rounding of wo's input where it crosses a rounding point, and the
# deep random model carries each flip on.  On an H100 (PERF.md, E1) the
# full width reads 5.797e-2 with every argmax equal, and the control run
# with wo dequantized to float32 on both sides (`float_wo`: no B3, no bf16
# rounding) reads 4.130e-6: so the noise is wo's rounding, and the control
# holds the engine within GOLDEN_TOL, far below this reading, where a
# routing flip or a chunk-padding fault in `moe` would show.  This bound,
# about twice the reading, only catches a wrong B3, whose error is O(1)
MIXTRAL_GOLDEN_TOL = 0.1
# two sound E1 runs whose float32 summation orders differ (KVNAND-D's head
# groups, the splice scheduler's one-shot prefill, a verify span, another
# replica) part where that noise, carried as above, outweighs a logit
# margin: the two tokens' logprobs at the first divergence, and the served
# logprobs before it, within this bound.  On an H100 (PERF.md, E1)
# KVNAND-D parted from the stripe run at a gap of 2.677e-2 after logprobs
# within 1.680e-2, and the no-drop stripe run's logprobs read 7.481e-2
# against the plain forward (wo as B3's function); the bound is twice the
# largest.  On `float_wo` the same pair serves equal tokens with logprobs
# within 9.537e-7, and the stripe run's logprobs read 4.768e-6 of the
# plain forward: the control pair is held within LOGIT_GAP_TOL
MIXTRAL_GAP_TOL = 0.15
# kv8 pages against f32 pages on E1's W4A16 model: kv8's noise on every K/V
# element moves the logits by more than the rounding flips above.  On an
# H100 (PERF.md, E1) the runs parted at gaps up to 1.132e-1 after served
# logprobs within 1.528e-1 (Y1's f32 hymba: 1.271e-2 and 2.265e-2, hence
# KV8_F32_TOL there); the bound is twice the largest.  Two kv8 runs are
# still held to each other within KV8_GAP_TOL
MIXTRAL_KV8_F32_TOL = 0.3


def mixtral_prompts(V):
    """6 prompts of 5-600 tokens; the first and the fifth share a 64-token
    prefix (one chunk, four pages), and the fifth is admitted after the
    first has registered it, so on the shared pool its prefill starts at
    the chunk boundary where the stripe run's second chunk starts."""
    import numpy as np
    rng = np.random.default_rng(9)
    prefix = rng.integers(0, V, 64).tolist()
    return [prefix + rng.integers(0, V, 40).tolist(),
            rng.integers(0, V, 5).tolist(),
            rng.integers(0, V, 600).tolist(),
            rng.integers(0, V, 200).tolist(),
            prefix + rng.integers(0, V, 300).tolist(),
            rng.integers(0, V, 17).tolist()]


def check_mixtral_widths(cfg):
    check(cfg.family == "moe" and cfg.n_layers == 32 and cfg.d_model == 4096
          and cfg.n_heads == 32 and cfg.n_kv_heads == 8
          and cfg.d_head == 128 and cfg.group_size == 4
          and cfg.n_experts == 8 and cfg.top_k == 2 and cfg.d_ff == 14336
          and cfg.vocab_size == 32000 and not cfg.tie_embeddings
          and cfg.rope_theta == 1e4, "not the full-width mixtral-8x7b")


def w4a16_params(cfg, tag):
    """Random W4A16 weights of `cfg`, built one layer at a time on the
    device: the port's `init_model` on a one-layer copy of the config,
    seeded with the layer's index, `quantize_params` on it, and its codes
    and scales copied into preallocated stacked leaves.  The float32
    transient is one layer's; the embedding, LM head and norms (layer 0's
    draw) stay float32, an MoE router too.  Returns (params, build
    info)."""
    import dataclasses
    import torch
    from repro_torch.core.quant import QuantizedWeight, quantize_params
    from repro_torch.models.transformer import init_model
    dev, L = "cuda", cfg.n_layers
    one = dataclasses.replace(cfg, n_layers=1)

    def empty(leaf):
        if isinstance(leaf, dict):
            return {k: empty(v) for k, v in leaf.items()}
        if isinstance(leaf, QuantizedWeight):
            return QuantizedWeight(empty(leaf.q), empty(leaf.scale),
                                   leaf.scheme, (L,) + leaf.orig_shape[1:])
        return torch.empty((L,) + tuple(leaf.shape[1:]), dtype=leaf.dtype,
                           device=dev)

    def put(dst, src, i):
        if isinstance(src, dict):
            for k in src:
                put(dst[k], src[k], i)
        elif isinstance(src, QuantizedWeight):
            put(dst.q, src.q, i)
            put(dst.scale, src.scale, i)
        else:
            dst[i].copy_(src[0])

    t0 = time.perf_counter()
    params = None
    for i in range(L):
        tree = quantize_params(
            init_model(one, torch.Generator(device=dev).manual_seed(i), dev),
            "w4a16")
        if params is None:
            params = {k: v for k, v in tree.items() if k != "layers"}
            params["layers"] = empty(tree["layers"])
        put(params["layers"], tree["layers"], i)
        del tree
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    n = code = 0
    for leaf in _leaves(params):
        if isinstance(leaf, QuantizedWeight):
            n += math.prod(leaf.orig_shape)
            code += (leaf.q.numel() * leaf.q.element_size()
                     + leaf.scale.numel() * 4)
        else:
            n += leaf.numel()
            code += leaf.numel() * leaf.element_size()
    print(f"{tag}: {cfg.name} W4A16 weights, {n / 1e9:.3f}B params "
          f"(config: {cfg.param_count() / 1e9:.3f}B), {code / 1e9:.2f} GB "
          f"of codes, scales and float leaves, built layer by layer on "
          f"{dev} in {wall:.2f} s")
    return params, {"params": n, "bytes": code, "build_wall_s": wall}


def mixtral_kernel_phase(cfg) -> dict:
    """B1, B2, B3 and B4 at the shapes E1's main path gives them: B1/B2 at
    4 slots x 8 kv heads x G = 4 queries x dh 128, pages of 16 and 64
    tokens over MIXTRAL_CTX tokens, ragged lengths, f32, bf16, kv8 and
    kv4; all heads in one launch and a KVNAND-D group (one kv head, first
    and last).  B4: causal one-shot prefill at 32 / 8 heads x 128, f32, 64
    and 600 positions.  B3: W4A16 at 4096 -> 4096 (wo), M = 4 (a decode
    step) and 64 (a chunk)."""
    return arch_kernel_phase(
        "E1", cfg, 26, (133, 600, 1000, MIXTRAL_CTX - 1), (16, 64),
        MIXTRAL_CTX, False, ("f32", "bf16", "kv8", "kv4"),
        ((64, (None,)), (600, (None,))),
        ((4, 64), (("wo", cfg.q_dim, cfg.d_model),)),
        head_groups=(None, 0, cfg.n_kv_heads - 1))


def mixtral_timing_phase(rate) -> dict:
    """Each kernel timed at E1's serving shapes: B1 and B2 over a full
    decode step's pool (4 slots x 8 kv heads x G = 4, dh 128, pages of 16
    tokens, MIXTRAL_CTX tokens), B4 on the 600-token admit, B3 on wo at a
    decode step's M = 4."""
    return arch_timing_phase(
        rate, 27, [("mixtral decode", 4, 8, 4, MIXTRAL_CTX // 16, 16, 128)],
        ("mixtral admit", 600, 32, 8, 128),
        [("mixtral wo, serving", 4, 4096, 4096)])


def moe_layer_phase(cfg, params) -> dict:
    """Layer 0's `moe` on the device and on the CPU, on the same inputs
    (a 64-token chunk, a 4-row decode, and the chunk at a capacity factor
    of 0.5): the routes (`layers.moe_route`: chosen experts, slots, kept
    pairs) equal, the outputs within MOE_LAYER_TOL."""
    import torch
    from repro_torch.models.layers import layer_slice, moe, moe_route
    dev_layer = layer_slice(params["layers"], 0)["moe"]
    cpu_layer = tree_to(dev_layer, "cpu")
    gen = torch.Generator().manual_seed(31)
    res = {}
    for label, B, S, cap in (("64-token chunk", 1, 64, 1.25),
                             ("4-row decode", 4, 1, 1.25),
                             ("64-token chunk, capacity 0.5", 1, 64, 0.5)):
        x = torch.randn(B, S, cfg.d_model, generator=gen)
        kw = dict(top_k=cfg.top_k, capacity_factor=cap)
        with torch.no_grad():
            t0 = time.perf_counter()
            got = moe(dev_layer, x.cuda(), **kw)
            torch.cuda.synchronize()
            dev_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            want = moe(cpu_layer, x, **kw)
            cpu_s = time.perf_counter() - t0
            rd = moe_route(dev_layer, x.cuda(), **kw)
            rc = moe_route(cpu_layer, x, **kw)
        err = float((got.cpu() - want).abs().max() / want.abs().max())
        same = all(torch.equal(a.cpu(), b) for a, b in zip(
            (rd.top_idx, rd.slot, rd.keep), (rc.top_idx, rc.slot, rc.keep)))
        kept = int(rc.keep.sum())
        print(f"E1 moe layer: {label} (B={B}, S={S}, C={rc.capacity}): "
              f"{kept} of {rc.keep.numel()} (token, expert) pairs kept, "
              f"routes equal {same}; max |device - CPU| / max |CPU| = "
              f"{err:.3e} (tol {MOE_LAYER_TOL:.0e}); device {dev_s:.3f} s, "
              f"CPU {cpu_s:.3f} s")
        check(same, f"E1 moe layer {label}: the device and the CPU route "
              "tokens apart")
        check(err <= MOE_LAYER_TOL and bool(torch.isfinite(got).all()),
              f"E1 moe layer {label}: outputs disagree")
        res[label] = {"capacity": rc.capacity, "kept": kept,
                      "pairs": rc.keep.numel(), "rel_err": err,
                      "device_s": dev_s, "cpu_s": cpu_s}
    half = res["64-token chunk, capacity 0.5"]
    check(half["kept"] < half["pairs"],
          "E1 moe layer: capacity 0.5 dropped no token")
    res["timing"] = moe_layer_timing(cfg, dev_layer)
    return res


def moe_layer_timing(cfg, layer) -> dict:
    """Where one layer's `moe` spends its device time (medians of
    `time_ms`): one expert stack dequantized to float32, its batched
    product at a decode step's rows (4 rows x top-2, C = 1) and a chunk's
    (C = 20), and the whole `moe` at a 4-row decode and a 64-token chunk."""
    import torch
    from repro_torch.core.quant import dequantize
    from repro_torch.models.layers import moe
    gen = torch.Generator(device="cuda").manual_seed(32)
    flush = torch.empty(64 * 2 ** 20, dtype=torch.float32, device="cuda")
    E, D, k = cfg.n_experts, cfg.d_model, cfg.top_k
    w = dequantize(layer["w_gate"], torch.float32)
    xs = {n: torch.randn(E, n, D, generator=gen, device="cuda")
          for n in (4, 20)}
    x_dec = torch.randn(4, 1, D, generator=gen, device="cuda")
    x_chunk = torch.randn(1, 64, D, generator=gen, device="cuda")
    times = {
        "dequantize_ms": time_ms(
            lambda: dequantize(layer["w_gate"], torch.float32), 5, flush),
        "bmm_decode_ms": time_ms(lambda: torch.bmm(xs[4], w), 5, flush),
        "bmm_chunk_ms": time_ms(lambda: torch.bmm(xs[20], w), 5, flush),
        "moe_decode_ms": time_ms(lambda: moe(layer, x_dec, top_k=k), 5,
                                 flush),
        "moe_chunk_ms": time_ms(lambda: moe(layer, x_chunk, top_k=k), 5,
                                flush)}
    res = {key: statistics.median(t) for key, t in times.items()}
    print("timing E1 moe layer (medians, ms): "
          + " ".join(f"{key}={v:.4f}" for key, v in res.items())
          + f"; a step's 32 layers of moe at decode "
          f"{cfg.n_layers * res['moe_decode_ms']:.1f} ms")
    return res


def mixtral_runtime(capacity):
    from repro_torch.models.transformer import Runtime
    return Runtime(moe_capacity=capacity)


def float_wo(params):
    """`params` with wo dequantized to float32 (the other leaves shared):
    wo is then a plain matrix product on every side, with no bf16 rounding
    of its input, so what parts two runs on this tree is their float32
    summation order alone."""
    import torch
    from repro_torch.core.quant import dequantize
    attn = dict(params["layers"]["attn"])
    attn["wo_w"] = dequantize(attn["wo_w"], torch.float32)
    return {**params, "layers": {**params["layers"], "attn": attn}}


def mixtral_golden_phase(cfg, params, control):
    """E1 golden: the 600-token prompt in 64-token chunks into an f32
    stripe pool, engine-level, then 8 greedy decode steps, at the no-drop
    capacity E / top_k; every step's logits against the port's plain full
    forward on the card (plain attention) over the prompt and the emitted
    tokens, with the same argmax.  Run twice: on the W4A16 weights, wo
    through B3 against the forward computing it as B3's own function,
    within MIXTRAL_GOLDEN_TOL; and on `control` (`float_wo`), where no B3
    runs and the bf16 rounding of wo's input is gone on both sides,
    within GOLDEN_TOL."""
    res = {}
    for key, tree, tol in (("w4a16", params, MIXTRAL_GOLDEN_TOL),
                           ("float_wo", control, GOLDEN_TOL)):
        res[key] = mixtral_golden_run(cfg, tree, key, tol)
    return res


def mixtral_golden_run(cfg, params, key, tol):
    import torch
    from repro_torch.configs import EngineConfig
    from repro_torch.core.engine import KVNANDEngine
    from repro_torch.kernels import quant_gemv
    from repro_torch.kernels.paged_attention import launches
    from repro_torch.models.registry import Model
    L = cfg.n_layers
    rt = mixtral_runtime(cfg.n_experts / cfg.top_k)
    t0 = time.perf_counter()
    eng = KVNANDEngine(cfg, EngineConfig(page_tokens=16,
                                         uniform_lengths=False,
                                         kv_dtype="float32"), rt,
                       device="cuda")
    prompt = mixtral_prompts(cfg.vocab_size)[2]
    n, V, C = len(prompt), cfg.vocab_size, 64
    cache = eng.init_cache(1, MIXTRAL_CTX)
    launches.reset()
    quant_gemv.launches.reset()
    with torch.no_grad():
        for pos in range(0, n, C):
            k = min(C, n - pos)
            toks = torch.zeros((1, C), dtype=torch.long, device="cuda")
            toks[0, :k] = torch.tensor(prompt[pos:pos + k])
            lg, _ = eng.prefill_chunk(params, cache, {"tokens": toks}, 0,
                                      pos, k, first=pos == 0)
        rows, out = [lg[0, :V]], [int(lg[0, :V].argmax())]
        for _ in range(8):
            lg, _ = eng.decode_step(params, cache, torch.tensor(
                [[out[-1]]], device="cuda"))
            rows.append(lg[0, :V])
            out.append(int(lg[0, :V].argmax()))
        b1, b3 = launches.value, quant_gemv.launches.value
        got = torch.stack(rows).float()
        with b3_function():
            full = Model(cfg, rt).forward(params, {"tokens": torch.tensor(
                [prompt + out[:8]], device="cuda")})[0, n - 1:, :V].float()
    torch.cuda.synchronize()
    err = float((got - full).abs().max() / full.abs().max())
    want = full.argmax(-1).tolist()
    wall = time.perf_counter() - t0
    chunks = -(-n // C)
    per_layer = MIXTRAL_B3_PER_LAYER if key == "w4a16" else 0
    print(f"E1 golden ({key} wo): {n}-token prompt in {chunks} chunks + 8 "
          f"decode steps, capacity {rt.moe_capacity} (no drops), f32 stripe "
          f"pool: max |logits - plain forward| / max |logits| = {err:.3e} "
          f"(tol {tol:.0e}); argmax {out} vs {want}; launches B1 {b1}, B3 "
          f"{b3}; {wall:.3f} s")
    check(b1 == 8 * L and b3 == per_layer * L * (chunks + 8),
          f"E1 golden ({key} wo): launches B1 {b1}, B3 {b3} != 8 x {L}, "
          f"{per_layer} x {L} x ({chunks} chunks + 8 steps)")
    check(err <= tol, f"E1 golden ({key} wo): logits disagree with the "
          "plain forward")
    check(out == want, f"E1 golden ({key} wo): a greedy token differs from "
          "the plain forward's")
    del eng, cache, full
    torch.cuda.empty_cache()
    return {"rel_err": err, "tokens": out, "launches_B1": b1,
            "launches_B3": b3, "wall_s": wall}


def mixtral_engine_config(**over):
    """f32 pages of 16 tokens, compact, as `launch/serve.py` serves
    without `--use-dse`, and `over`."""
    from repro_torch.configs import EngineConfig
    return EngineConfig(**{"page_tokens": 16, "uniform_lengths": False,
                           "kv_dtype": "float32", **over})


def mixtral_server_config(eng, **over):
    from repro_torch.serving.api import ServerConfig
    return ServerConfig(**{"arch": "mixtral-8x7b", "engine": eng,
                           "batch_slots": 4, "max_context": MIXTRAL_CTX,
                           "prefill_chunk_tokens": 64, "device": "cuda",
                           **over})


def mixtral_replica_run(cfg, params, prompts, solo_outs) -> dict:
    """Two replicas on E1's weights (f32 pages of 16 tokens, shared
    pools, capacity 1.25): replica 0 prefills every request in the
    stripe run's chunks, each migrates once through the envelope's wire
    bytes and decodes on replica 1; the tokens are one shared-pool
    server's (or part only at a near tie)."""
    import torch
    import repro_torch.serving.router as router_mod
    from repro_torch.kernels import flash_attention, quant_gemv, wkv6
    from repro_torch.kernels.paged_attention import launches, launches_shared
    from repro_torch.serving.api import SamplingParams
    from repro_torch.serving.replica import build_replica
    config = mixtral_server_config(mixtral_engine_config(shared_pool=True))
    reps = [build_replica(config, cfg=cfg, params=params,
                          rt=mixtral_runtime(1.25), device="cuda")
            for _ in range(2)]
    check(all(r.params["embedding"] is params["embedding"] for r in reps),
          "E1 replicas: a replica copied the weights")
    router = router_mod.ReplicaRouter(reps, disaggregate=True)
    counters = {"B1": launches, "B2": launches_shared,
                "B3": quant_gemv.launches, "B4": flash_attention.launches,
                "B5": wkv6.launches}
    steps0 = [r.stats["decode_steps"] for r in reps]
    chunks0 = [r.stats["prefill_chunks"] for r in reps]
    for c in counters.values():
        c.reset()
    t0 = time.perf_counter()
    sp = SamplingParams(max_new_tokens=MIXTRAL_NEW, logprobs=True)
    uids = [router.submit(p, sp) for p in prompts]
    router.run()
    outs = [router.output(u) for u in uids]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = {k: c.value for k, c in counters.items()}
    steps = [r.stats["decode_steps"] - s for r, s in zip(reps, steps0)]
    chunks = [r.stats["prefill_chunks"] - s for r, s in zip(reps, chunks0)]
    st = router.stats
    L = cfg.n_layers
    print(f"E1 replicas: {st['migrations']} migrations "
          f"({st['migration_bytes']} wire bytes), decode steps per replica "
          f"{steps}, prefill chunks {chunks}, launches {counts}, "
          f"{wall:.3f} s")
    check(st["migrations"] == len(prompts) and steps[0] == 0,
          "E1 replicas: not every request migrated once to the decode "
          "replica")
    want = {"B2": sum(steps) * L,
            "B3": MIXTRAL_B3_PER_LAYER * L * (sum(steps) + sum(chunks)),
            "B1": 0, "B4": 0, "B5": 0}
    check(counts == want, f"E1 replicas: launches {counts} != {want}")
    for r in reps:
        r._batcher.alloc.check()
    same, before, gap = near_tie_check("E1 replicas vs one shared server",
                                       outs, solo_outs, MIXTRAL_GAP_TOL,
                                       MIXTRAL_GAP_TOL)
    res = {"migrations": st["migrations"],
           "migration_bytes": st["migration_bytes"], "decode_steps": steps,
           "prefill_chunks": chunks, "launches": counts, "wall_s": wall,
           "same_as_one_server": same, "logprob_err": before,
           "max_gap_at_divergence": gap}
    del router, reps
    return res


def mixtral_server_runs(cfg, params, control) -> dict:
    """E1's servers on one set of W4A16 weights (see the module
    docstring), and the control pair on `control` (`float_wo`): stripe
    and KVNAND-D at the no-drop capacity on the first two prompts, where
    no B3 runs; returns each run's counts, walls and agreement."""
    import torch
    from repro_torch.serving.api import KVNANDServer
    L, K = cfg.n_layers, cfg.n_kv_heads
    B3 = MIXTRAL_B3_PER_LAYER * L
    nodrop = cfg.n_experts / cfg.top_k
    prompts = mixtral_prompts(cfg.vocab_size)
    zero = {k: 0 for k in ("B1", "B2", "B3", "B4", "B5")}
    runs, res = {}, {}
    for key, label, over, server, cap, want in (
            ("stripe", "E1 stripe f32", {}, {}, 1.25,
             lambda s, a, c, v: {"B1": s * L, "B3": B3 * (s + c)}),
            ("shared", "E1 shared f32", {"shared_pool": True}, {}, 1.25,
             lambda s, a, c, v: {"B2": s * L, "B3": B3 * (s + c)}),
            ("overlap", "E1 overlapped stripe f32", {}, {"overlap": True},
             1.25, lambda s, a, c, v: {"B1": s * L, "B3": B3 * (s + c)}),
            ("discrete", "E1 discrete (KVNAND-D) f32",
             {"variant": "discrete"}, {}, 1.25,
             lambda s, a, c, v: {"B1": s * L * K, "B3": B3 * (s + c)}),
            ("kv8", "E1 stripe kv8", {"kv_quant": "kv8"}, {}, 1.25,
             lambda s, a, c, v: {"B1": s * L, "B3": B3 * (s + c)}),
            ("kv8_shared", "E1 shared kv8",
             {"kv_quant": "kv8", "shared_pool": True}, {}, 1.25,
             lambda s, a, c, v: {"B2": s * L, "B3": B3 * (s + c)}),
            ("stripe_nodrop", "E1 stripe f32, no drops", {}, {}, nodrop,
             lambda s, a, c, v: {"B1": s * L, "B3": B3 * (s + c)}),
            ("splice_nodrop", "E1 splice f32, no drops", {},
             {"scheduler": "splice"}, nodrop,
             lambda s, a, c, v: {"B1": s * L, "B4": a * L,
                                 "B3": B3 * (s + a)}),
            ("spec_nodrop", "E1 speculative (k=4) f32, no drops", {},
             {"speculation_k": 4}, nodrop,
             lambda s, a, c, v: {"B1": s * L, "B3": B3 * (s + v + c)}),
            ("stripe_float_wo", "E1 stripe f32, float wo, no drops", {}, {},
             nodrop, lambda s, a, c, v: {"B1": s * L}),
            ("discrete_float_wo",
             "E1 discrete (KVNAND-D) f32, float wo, no drops",
             {"variant": "discrete"}, {}, nodrop,
             lambda s, a, c, v: {"B1": s * L * K})):
        srv = KVNANDServer(mixtral_server_config(
            mixtral_engine_config(**over), **server), cfg=cfg,
            params=control if key.endswith("float_wo") else params,
            rt=mixtral_runtime(cap))
        v0 = srv.stats.get("verify_steps", 0)
        # the control pair serves the first two prompts (where the W4A16
        # KVNAND-D run parts from stripe), to keep the script's time
        outs, counts, steps, wall, tokens = serve(
            label, srv, prompts[:2] if key.endswith("float_wo") else prompts,
            MIXTRAL_NEW)
        if key == "spec_nodrop":
            # a request with one token of its budget left cannot draft, so
            # the speculative server takes a sequential decode step for
            # it: a 2-token request drives that path whatever the six
            # above accepted (at the default run's depth they end on
            # verify steps only)
            _, more, s2, w2, t2 = serve(f"{label}, a 2-token request", srv,
                                        prompts[1:2], 2)
            counts = {k: counts[k] + more[k] for k in counts}
            steps, wall, tokens = steps + s2, wall + w2, tokens + t2
            check(s2 > 0, f"{label}: the 2-token request took no decode "
                  "step")
        verify = srv.stats.get("verify_steps", 0) - v0
        admits, chunks = counts["admits"], counts["prefill_chunks"]
        expect = {**zero, **want(steps, admits, chunks, verify)}
        check(steps > 0 and counts == {**counts, **expect},
              f"{label}: launches {counts} != {expect} ({steps} decode "
              f"steps, {verify} verify steps, {chunks} chunks, "
              f"{admits} admits x {L} layers)")
        if over.get("shared_pool"):
            b = srv._batcher
            b.alloc.check()
            check(srv.stats["prefix_hit_pages"] >= 4,
                  f"{label}: the shared prefix was not hit")
        runs[key] = outs
        res[key] = {"decode_steps": steps, "verify_steps": verify,
                    "prefill_chunks": chunks, "admits": admits,
                    "launches": {k: counts[k] for k in zero},
                    "wall_s": wall, "tokens": tokens}
        if key == "shared":
            res[key]["prefix_hit_pages"] = srv.stats["prefix_hit_pages"]
        if key == "spec_nodrop":
            check(verify > 0 and srv.stats["spec_accepted"] > 0,
                  f"{label}: no draft was accepted")
            res[key]["spec_accepted"] = srv.stats["spec_accepted"]
        if key in ("stripe_nodrop", "stripe_float_wo"):
            # without drops the plain forward is the served function, up
            # to the W4A16 rounding noise MIXTRAL_GOLDEN_TOL explains; with
            # float wo, up to float32 summation order
            control_run = key == "stripe_float_wo"
            with b3_function():
                lp, gap = teacher_forced_check(
                    label, srv, outs, argmax=control_run,
                    tol=LOGIT_GAP_TOL if control_run else QUANT_LOGPROB_TOL,
                    rt=mixtral_runtime(nodrop))
            res[key].update(logprob_err_vs_plain_forward=lp, max_gap=gap)
        del srv
    # the f32 runs differ in summation order only (MIXTRAL_GAP_TOL); kv8
    # reads its K/V through kv8 codes (KV8_F32_TOL against f32, KV8_GAP_TOL
    # between two kv8 runs); splice and speculation call `moe` at other
    # lengths, so they are held to the stripe run at the same no-drop
    # capacity
    w4 = (MIXTRAL_GAP_TOL, MIXTRAL_GAP_TOL)
    for key, ref, tols in (
            ("shared", "stripe", w4),
            ("overlap", "stripe", w4),
            ("discrete", "stripe", w4),
            ("kv8", "stripe", (MIXTRAL_KV8_F32_TOL, MIXTRAL_KV8_F32_TOL)),
            ("kv8_shared", "kv8", (KV8_GAP_TOL, LOGPROB_TOL)),
            ("splice_nodrop", "stripe_nodrop", w4),
            ("spec_nodrop", "stripe_nodrop", w4),
            ("discrete_float_wo", "stripe_float_wo",
             (LOGIT_GAP_TOL, LOGIT_GAP_TOL))):
        same, before, gap = near_tie_check(f"E1 {key} vs {ref}", runs[key],
                                           runs[ref], *tols)
        res[key].update(same_as_reference=same, logprob_err=before,
                        max_gap_at_divergence=gap)
    res["replicas"] = mixtral_replica_run(cfg, params, prompts,
                                          runs["shared"])
    # `moe` must leave the overlapped schedule's dispatch free of host
    # reads, as O1's probe holds the stripe pool's
    site = sync_probe(KVNANDServer(mixtral_server_config(
        mixtral_engine_config(), overlap=True), cfg=cfg, params=params,
        rt=mixtral_runtime(1.25)))
    print(f"E1 stripe: decode-only dispatch under "
          f"set_sync_debug_mode('error'): first host sync {site}")
    check(site == "none", "E1: a decode-only dispatch through `moe` "
          f"synchronizes: {site}")
    res["sync_probe"] = site
    return res


def moe_phases(rate) -> dict:
    """Phase 22, E1 (see the module docstring)."""
    import dataclasses
    import gc
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core.quant import QuantizedWeight
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    cfg = get_config("mixtral-8x7b")
    check_mixtral_widths(cfg)
    cfg = dataclasses.replace(cfg, n_layers=depth(MIXTRAL_LAYERS, 32))
    params, build = w4a16_params(cfg, "E1")
    moe_p = params["layers"]["moe"]
    check(all(isinstance(moe_p[k], QuantizedWeight)
              and tuple(moe_p[k].q.shape[:2]) == (cfg.n_layers,
                                                  cfg.n_experts)
              for k in ("w_gate", "w_up", "w_down"))
          and isinstance(moe_p["router_w"], torch.Tensor)
          and moe_p["router_w"].dtype == torch.float32,
          "E1: the experts are not W4A16 stacks beside a float router")
    res = {"build": build,
           "build_peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
           "kernels": mixtral_kernel_phase(cfg),
           "timing": mixtral_timing_phase(rate),
           "moe_layer": moe_layer_phase(cfg, params)}
    control = float_wo(params)
    res["golden"] = mixtral_golden_phase(cfg, params, control)
    res.update(mixtral_server_runs(cfg, params, control))
    del params, control
    gc.collect()
    res["peak_memory_gb"] = torch.cuda.max_memory_allocated() / 1e9
    torch.cuda.empty_cache()
    zero = ("B1", "B2", "B3", "B4", "B5")
    res["launches"] = {k: sum(r["launches"][k] for r in res.values()
                              if isinstance(r, dict) and "launches" in r
                              and isinstance(r["launches"], dict)
                              and k in r["launches"])
                       for k in zero}
    walls = {k: v["wall_s"] for k, v in res.items()
             if isinstance(v, dict) and "wall_s" in v}
    for key, g in res["golden"].items():
        res["launches"]["B1"] += g["launches_B1"]
        res["launches"]["B3"] += g["launches_B3"]
        walls[f"golden {key}"] = g["wall_s"]
    print(f"E1: launches on the main path {res['launches']}; build peak "
          f"memory {res['build_peak_memory_gb']:.2f} GB, peak memory "
          f"{res['peak_memory_gb']:.2f} GB; walls (s): "
          + ", ".join(f"{k} {v:.3f}" for k, v in walls.items())
          + f"; on {smi_line()}")
    return res


# ---------------------------------------------------------------------------
# phase 23: P1, full-width pixtral-12b (the VLM family)
# ---------------------------------------------------------------------------

PIXTRAL_CTX = 1024       # max_context of P1's servers (the DSE: compact,
#                          W4A16, 64-token pages, bf16 KV from 256 to 2048)
PIXTRAL_NEW = 16         # new tokens a request
# the stub frontend's patch prefix (`Runtime.vlm_patches`) and the golden
# run's prompt behind it
PIXTRAL_PATCHES = 256
PIXTRAL_GOLDEN_PROMPT = 64
# B3's launches a pixtral layer at W4A16: wo, gate, up, down (wq/wk/wv
# are dequantized, as in the reference; the LM head is float)
PIXTRAL_B3_PER_LAYER = 4
# B3 at pixtral's projection shapes: (label, D, F)
PIXTRAL_GEMV_SHAPES = (("wo", 5120, 5120), ("gate/up", 5120, 14336),
                       ("down", 14336, 5120))
# the longest prompt the CPU side of the DSE check prefills (a 12.8 B
# model on 8 cores, B3's function in float64): 17 in `--vlm`, the 5- and
# the 17-token prompts (the 17-token one takes B3's tile path); the default
# run cuts it to the 5-token prompt since L1 came (~73 s of a slow host
# for both; PERF.md, PR 27)
PIXTRAL_CPU_PROMPT, PIXTRAL_CPU_PROMPT_CUT = 17, 5
# The DSE pick's prefill logits, the card against the CPU computing B3's
# function (`b3_function`), ||card - CPU|| / ||CPU|| at the last token.
# pixtral's random model carries far less of the bf16 rounding of x than
# hymba's: on an H100 (PERF.md, P1) B3 reads 5.26e-3-5.31e-3, the card
# computing B3's function itself 5.27e-3-5.56e-3 (so the gap is the
# card's float32 order, not B3), and the plain version, which rounds each
# product to bf16, 9.59e-3-9.70e-3.  The bound lies between the two, and
# the run checks that the plain version reads above it, as Y1's does
PIXTRAL_PREFILL_TOL = 7.5e-3


def pixtral_prompts(V):
    """6 prompts of 5-600 tokens; the first and the fifth share a 64-token
    prefix (one chunk, four pages), which the shared pool's prefix cache
    hits (as E1's)."""
    import numpy as np
    rng = np.random.default_rng(10)
    prefix = rng.integers(0, V, 64).tolist()
    return [prefix + rng.integers(0, V, 40).tolist(),
            rng.integers(0, V, 5).tolist(),
            rng.integers(0, V, 600).tolist(),
            rng.integers(0, V, 200).tolist(),
            prefix + rng.integers(0, V, 300).tolist(),
            rng.integers(0, V, 17).tolist()]


def check_pixtral_widths(cfg):
    check(cfg.family == "vlm" and cfg.n_layers == 40 and cfg.d_model == 5120
          and cfg.n_heads == 32 and cfg.n_kv_heads == 8
          and cfg.d_head == 160 and cfg.group_size == 4
          and cfg.d_ff == 14336 and cfg.vocab_size == 131072
          and not cfg.tie_embeddings and cfg.rope_theta == 1e6,
          "not the full-width pixtral-12b")


def pixtral_params(cfg):
    """Full-width pixtral-12b at full depth, random float32 weights on the
    card, seed 0."""
    import torch
    from repro_torch.models.registry import Model
    t0 = time.perf_counter()
    params = Model(cfg).init(torch.Generator(device="cuda").manual_seed(0))
    torch.cuda.synchronize()
    n = sum(t.numel() for t in _leaves(params))
    print(f"P1: {cfg.name} weights, {n / 1e9:.3f}B params ({4 * n / 1e9:.2f}"
          f" GB float32), drawn on the card in {time.perf_counter() - t0:.2f}"
          " s")
    return params, n


def pixtral_kernel_phase(cfg) -> dict:
    """B1, B2, B3 and B4 at the shapes P1's main path gives them: B1/B2 at
    4 slots x 8 kv heads x G = 4 queries x dh 160, pages of 16 and 64
    tokens (the DSE's) over PIXTRAL_CTX tokens, ragged lengths, f32 and
    bf16; all heads and a KVNAND-D group (the first kv head, the last).
    B4: the golden admit (256 patches + 64 tokens) and the 600-token
    prompt, 32 / 8 heads x 160, causal, f32.  B3: W4A16 at pixtral's
    projections, M = 4 (a decode step) and 64 (a chunk)."""
    return arch_kernel_phase(
        "P1", cfg, 32, (69, 320, 616, PIXTRAL_CTX - 1), (16, 64),
        PIXTRAL_CTX, False, ("f32", "bf16"),
        ((PIXTRAL_PATCHES + PIXTRAL_GOLDEN_PROMPT, (None,)), (600, (None,))),
        ((4, 64), PIXTRAL_GEMV_SHAPES),
        head_groups=(None, 0, cfg.n_kv_heads - 1))


def pixtral_timing_phase(rate) -> dict:
    """Each kernel timed at P1's serving shapes: B1 and B2 over a decode
    step's pool (4 slots x 8 kv heads x G = 4, dh 160, PIXTRAL_CTX tokens
    of 16-token pages), B4 on the golden admit (256 patches + 64 tokens),
    B3 at a decode step's M = 4 over each projection shape."""
    return arch_timing_phase(
        rate, 33, [("pixtral decode", 4, 8, 4, PIXTRAL_CTX // 16, 16, 160)],
        ("pixtral admit", PIXTRAL_PATCHES + PIXTRAL_GOLDEN_PROMPT, 32, 8,
         160),
        [(f"pixtral {label}, serving", 4, D, F)
         for label, D, F in PIXTRAL_GEMV_SHAPES])


def pixtral_golden_phase(cfg, params):
    """P1 golden: 256 patch embeddings (standard normal, as the
    reference's golden test draws them) before a 64-token prompt, one-shot
    prefill into an f32 stripe pool (B4 = 40), then 8 greedy decode steps
    (B1 = 8 x 40); every step's logits against the port's plain full
    forward on the card over the same patches, the prompt and the emitted
    tokens, within GOLDEN_TOL of max |logits|, the same argmax at every
    step.  The slot's length counts the patches."""
    import torch
    from repro_torch.configs import EngineConfig
    from repro_torch.core.engine import KVNANDEngine
    from repro_torch.kernels import flash_attention
    from repro_torch.kernels.paged_attention import launches
    from repro_torch.models.registry import Model
    t0 = time.perf_counter()
    eng = KVNANDEngine(cfg, EngineConfig(page_tokens=16,
                                         uniform_lengths=False,
                                         kv_dtype="float32"), device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(34)
    prompt = pixtral_prompts(cfg.vocab_size)[2][:PIXTRAL_GOLDEN_PROMPT]
    n, P, V = len(prompt), PIXTRAL_PATCHES, cfg.vocab_size
    patches = torch.randn(1, P, cfg.d_model, generator=gen, device="cuda")
    with torch.no_grad():
        flash_attention.launches.reset()
        launches.reset()
        lg, cache = eng.prefill(params, {
            "tokens": torch.tensor([prompt], device="cuda"),
            "patches": patches}, PIXTRAL_CTX)
        b4 = flash_attention.launches.value
        check(int(cache.lengths[0]) == P + n,
              "P1 golden: the slot's length does not count the patches")
        rows, out = [lg[0, :V]], [int(lg[0, :V].argmax())]
        for _ in range(8):
            lg, _ = eng.decode_step(params, cache, torch.tensor(
                [[out[-1]]], device="cuda"))
            rows.append(lg[0, :V])
            out.append(int(lg[0, :V].argmax()))
        b1 = launches.value
        got = torch.stack(rows).float()
        full = Model(cfg).forward(params, {
            "tokens": torch.tensor([prompt + out[:8]], device="cuda"),
            "patches": patches})[0, n - 1:, :V].float()
    torch.cuda.synchronize()
    err = float((got - full).abs().max() / full.abs().max())
    want = full.argmax(-1).tolist()
    wall = time.perf_counter() - t0
    print(f"P1 golden: {P} patches + {n}-token prompt, one-shot prefill + 8 "
          f"decode steps, f32 stripe pool: max |logits - plain forward| / "
          f"max |logits| = {err:.3e} (tol {GOLDEN_TOL:.0e}); argmax {out} vs "
          f"{want}; B4 launches {b4}, B1 launches {b1}; {wall:.3f} s")
    check(b4 == cfg.n_layers and b1 == 8 * cfg.n_layers,
          f"P1 golden: B4 {b4} != {cfg.n_layers} or B1 {b1} != 8 x "
          f"{cfg.n_layers}")
    check(err <= GOLDEN_TOL, "P1 golden: logits disagree with the plain "
          "forward")
    check(out == want, "P1 golden: a greedy token differs from the plain "
          "forward's")
    del eng, cache, full
    torch.cuda.empty_cache()
    return {"rel_err": err, "tokens": out, "launches_B1": b1,
            "launches_B4": b4, "wall_s": wall}


def pixtral_dse_engine_config():
    """The design-space search's pick at PIXTRAL_CTX, asserted compact,
    64-token pages, W4A16, bf16 pages without kv quantization, one
    partition, served as it is (its page size, ragged appends)."""
    from repro_torch.configs import EngineConfig
    from repro_torch.core.dse import recommend_engine_config
    pick = recommend_engine_config("pixtral-12b", PIXTRAL_CTX)
    check(pick.variant == "compact" and not pick.hg_pipeline
          and pick.page_tokens == 64 and pick.quant == "w4a16"
          and pick.kv_quant == "none" and pick.kv_dtype == "bfloat16"
          and pick.attn_partitions == 1,
          f"the DSE's pixtral-12b pick at {PIXTRAL_CTX} is not compact, "
          f"T=64, w4a16, bf16 pages, one partition: {pick}")
    return EngineConfig(**{**pick.__dict__, "uniform_lengths": False})


def build_pixtral_server(cfg, params, eng, scheduler="interleaved",
                         device="cuda"):
    from repro_torch.serving.api import KVNANDServer, ServerConfig
    return KVNANDServer(ServerConfig(
        arch="pixtral-12b", engine=eng, scheduler=scheduler, batch_slots=4,
        max_context=PIXTRAL_CTX, prefill_chunk_tokens=64, device=device),
        cfg=cfg, params=params)


def pixtral_server_runs(cfg, params) -> dict:
    """P1's f32 servers (16-token pages): stripe (B1 = decode steps x 40,
    every token checked against the plain forward), shared (B2, the
    prefix cache hits the shared 64-token prefix), splice (B4 = admits x
    40) and KVNAND-D (B1 = steps x 40 x 8); the last three serve the
    stripe run's tokens or part only at a near tie (LOGIT_GAP_TOL)."""
    from repro_torch.configs import EngineConfig
    L, K = cfg.n_layers, cfg.n_kv_heads
    prompts = pixtral_prompts(cfg.vocab_size)
    zero = {k: 0 for k in ("B1", "B2", "B3", "B4", "B5")}
    res, runs = {}, {}
    for key, label, over, sched, want in (
            ("stripe", "P1 stripe f32", {}, "interleaved",
             lambda s, a: {"B1": s * L}),
            ("shared", "P1 shared f32", {"shared_pool": True},
             "interleaved", lambda s, a: {"B2": s * L}),
            ("splice", "P1 splice f32", {}, "splice",
             lambda s, a: {"B1": s * L, "B4": a * L}),
            ("discrete", "P1 discrete (KVNAND-D) f32",
             {"variant": "discrete"}, "interleaved",
             lambda s, a: {"B1": s * L * K})):
        eng = EngineConfig(page_tokens=16, uniform_lengths=False,
                           kv_dtype="float32", **over)
        srv = build_pixtral_server(cfg, params, eng, sched)
        outs, counts, steps, wall, tokens = serve(label, srv, prompts,
                                                  PIXTRAL_NEW)
        expect = {**zero, **want(steps, counts["admits"])}
        check(steps > 0 and counts == {**counts, **expect},
              f"{label}: launches {counts} != {expect} ({steps} decode "
              f"steps, {counts['admits']} admits x {L} layers)")
        runs[key] = outs
        res[key] = {"decode_steps": steps, "admits": counts["admits"],
                    "prefill_chunks": counts["prefill_chunks"],
                    "launches": {k: counts[k] for k in zero},
                    "wall_s": wall, "tokens": tokens}
        if key == "stripe":
            lp, gap = teacher_forced_check(label, srv, outs)
            res[key].update(logprob_err_vs_plain_forward=lp, max_gap=gap)
        if key == "shared":
            b = srv._batcher
            hits = srv.stats["prefix_hit_pages"]
            print(f"{label}: {hits} prompt pages from the prefix cache")
            check(b.prefix_cache is not None and hits > 0,
                  f"{label}: the prefix cache did not hit")
            b.alloc.check()
            check(b.alloc.live_count == b.prefix_cache.evictable_pages(),
                  f"{label}: pages other than the prefix cache's still "
                  "mapped after the drain")
            res[key]["prefix_hit_pages"] = hits
        del srv
    for key in ("shared", "splice", "discrete"):
        same, before, gap = near_tie_check(
            f"P1 {key} vs stripe", runs[key], runs["stripe"], LOGIT_GAP_TOL)
        res[key].update(same_as_reference=same, logprob_err=before,
                        max_gap_at_divergence=gap)
    return res


def pixtral_dse_run(cfg) -> dict:
    """The DSE's pick on W4A16 weights built layer by layer on the card
    (after the f32 tree is freed): stripe, 64-token bf16 pages, B3 = 4 x
    40 per decode step and prefill chunk, B1 = steps x 40; served
    logprobs against the plain forward within QUANT_LOGPROB_TOL; the
    prompts of at most PIXTRAL_CPU_PROMPT tokens (PIXTRAL_CPU_PROMPT_CUT
    in the default run) prefilled on the card and on the card machine's
    CPU computing B3's function, within PIXTRAL_PREFILL_TOL, beside the
    two controls of Y1."""
    import gc
    import torch
    L = cfg.n_layers
    qparams, build = w4a16_params(cfg, "P1")
    eng = pixtral_dse_engine_config()
    srv = build_pixtral_server(cfg, qparams, eng)
    label = "P1 DSE pick (w4a16, bf16 pages, T=64)"
    prompts = pixtral_prompts(cfg.vocab_size)
    outs, counts, steps, wall, tokens = serve(label, srv, prompts,
                                              PIXTRAL_NEW)
    chunks = counts["prefill_chunks"]
    b3 = PIXTRAL_B3_PER_LAYER * L * (steps + chunks)
    check(steps > 0 and counts["B3"] == b3 and counts["B1"] == steps * L
          and all(counts[k] == 0 for k in ("B2", "B4", "B5")),
          f"{label}: launches {counts} != (B3 {PIXTRAL_B3_PER_LAYER} x {L} "
          f"x ({steps} decode steps + {chunks} chunks), B1 {steps} x {L}, "
          "B2/B4/B5 0)")
    lp, _ = teacher_forced_check(label, srv, outs, argmax=False,
                                 tol=QUANT_LOGPROB_TOL)
    cpu = build_pixtral_server(cfg, tree_to(qparams, "cpu"), eng,
                               device="cpu")
    longest = depth(PIXTRAL_CPU_PROMPT_CUT, PIXTRAL_CPU_PROMPT)
    short = [p for p in prompts if len(p) <= longest]
    t0 = time.perf_counter()
    with b3_function():
        cpu_logits = [whole_prompt_logits(cpu, p) for p in short]
    cpu_wall = time.perf_counter() - t0
    gaps = {}
    for key, ctx in (("B3", contextlib.nullcontext),
                     ("function", b3_function), ("plain", plain_gemv)):
        with ctx():
            gaps[key] = [float((whole_prompt_logits(srv, p) - r).norm()
                               / r.norm())
                         for p, r in zip(short, cpu_logits)]
    for key, what in (("B3", "B3"), ("function", "B3's function in "
                      "float64 on the card too"), ("plain", "the plain "
                      "version on the card")):
        print(f"check {label}: {len(short)} prompts of <= "
              f"{longest} tokens prefilled through {what} against"
              f" the CPU computing B3's function ({cpu_wall:.3f} s), "
              f"||logit difference|| / ||CPU logits|| at the last token: "
              f"{', '.join(f'{g:.4e}' for g in gaps[key])} (tol "
              f"{PIXTRAL_PREFILL_TOL:.1e})")
    check(max(gaps["B3"]) <= PIXTRAL_PREFILL_TOL, f"{label}: prefill "
          "logits disagree with the CPU run")
    check(max(gaps["plain"]) > PIXTRAL_PREFILL_TOL, f"{label}: the gate "
          "cannot tell B3's function from the plain version's")
    del srv, cpu, qparams
    gc.collect()
    torch.cuda.empty_cache()
    return {"build": build, "decode_steps": steps, "prefill_chunks": chunks,
            "launches": {k: counts[k] for k in ("B1", "B2", "B3", "B4",
                                                "B5")},
            "wall_s": wall, "tokens": tokens,
            "logprob_err_vs_plain_forward": lp, "prefill_gaps": gaps["B3"],
            "prefill_gaps_function_on_card": gaps["function"],
            "prefill_gaps_plain_on_card": gaps["plain"],
            "cpu_wall_s": cpu_wall}


def vlm_phases(rate) -> dict:
    """Phase 23, P1 (see the module docstring)."""
    import gc
    import torch
    from repro_torch.configs import get_config
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    cfg = get_config("pixtral-12b")
    check_pixtral_widths(cfg)
    params, n = pixtral_params(cfg)
    res = {"params": n, "kernels": pixtral_kernel_phase(cfg),
           "timing": pixtral_timing_phase(rate),
           "golden": pixtral_golden_phase(cfg, params)}
    res.update(pixtral_server_runs(cfg, params))
    del params
    gc.collect()
    torch.cuda.empty_cache()
    res["f32_peak_memory_gb"] = torch.cuda.max_memory_allocated() / 1e9
    res["dse"] = pixtral_dse_run(cfg)
    res["peak_memory_gb"] = torch.cuda.max_memory_allocated() / 1e9
    zero = ("B1", "B2", "B3", "B4", "B5")
    res["launches"] = {k: sum(r["launches"][k] for r in res.values()
                              if isinstance(r, dict) and "launches" in r
                              and isinstance(r["launches"], dict))
                       for k in zero}
    res["launches"]["B1"] += res["golden"]["launches_B1"]
    res["launches"]["B4"] += res["golden"]["launches_B4"]
    print(f"P1: launches on the main path {res['launches']}; peak memory "
          f"{res['f32_peak_memory_gb']:.2f} GB (f32), "
          f"{res['peak_memory_gb']:.2f} GB (with the W4A16 build); walls "
          "(s): " + ", ".join(f"{k} {v['wall_s']:.3f}"
                              for k, v in res.items()
                              if isinstance(v, dict) and "wall_s" in v)
          + f"; on {smi_line()}")
    return res


# ---------------------------------------------------------------------------
# phase 24: W1, full-width whisper-base (the encoder-decoder family)
# ---------------------------------------------------------------------------

# whisper's 30 s window is 1500 encoder positions; the decode step walks
# the cross K/V as whole pages (in both packages), so W1 rounds it up to
# 96 pages of 16 tokens
WHISPER_FRAMES = 1536
WHISPER_PROMPT = 40      # decoder prompt tokens of the golden runs
WHISPER_STEPS = 8        # greedy decode steps after the prefill
# a bf16 run's cross and self K/V are rounded to bf16 in the cache, the
# plain forward's are not: its logits are held to the bf16 pools' kernel
# tolerance (TOL["bf16"]), its argmax reported
WHISPER_BF16_TOL = TOL["bf16"]


def check_whisper_widths(cfg):
    check(cfg.family == "audio" and cfg.is_encoder_decoder
          and cfg.encoder_layers == 6 and cfg.n_layers == 6
          and cfg.d_model == 512 and cfg.n_heads == 8
          and cfg.n_kv_heads == 8 and cfg.d_head == 64 and cfg.d_ff == 2048
          and not cfg.gated_mlp and cfg.vocab_size == 51865
          and cfg.tie_embeddings, "not the full-width whisper-base")


def whisper_kernel_phase(cfg) -> dict:
    """B1, B2 and B4 at the shapes W1's main path gives them, against
    their plain versions: B1/B2 over the decoder's self-attention pool (4
    rows x 8 kv heads x G = 1 x dh 64, ragged, 16-token pages, f32 and
    bf16); B1 over the encoder's 96 pages of 16 (length 1536 every row,
    f32 and bf16, one partition and 4); B4 non-causal on the encoder
    (1536 x 1536, 8 heads x 64) and the decoder's cross-attention
    (Sq != Sk: 40 and 1 prompt rows against 1536 encoder positions), f32
    and bf16, each under the host's plan and S forced to 1 and 8."""
    import torch
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import paged_attention as pa
    errs = arch_kernel_phase("W1", cfg, 40, (41, 45, 49, 130), (16,), 256,
                             False, ("f32", "bf16"), ())
    gen = torch.Generator(device="cuda").manual_seed(41)
    K, dh, T = cfg.n_kv_heads, cfg.d_head, 16
    NP, B = WHISPER_FRAMES // T, 4
    n = 0
    for fmt in ("f32", "bf16"):
        q, kp, vp, base, _, _, _ = make_inputs(
            B, K, 1, NP, T, dh, fmt, [WHISPER_FRAMES] * B, gen)
        length = torch.full((B,), WHISPER_FRAMES, dtype=torch.int32,
                            device="cuda")
        for parts in (1, 4):
            # the partitions' merged (o, m, l) against one whole walk
            got = pa.paged_attention_partial(q, kp, vp, base, length,
                                             partitions=parts)
            want = pa.paged_attention_partial_ref(q, kp, vp, base, length)
            want32 = (pa.paged_attention_partial_ref(
                q, kp.float(), vp.float(), base, length)
                if fmt == "bf16" else None)
            errs["B1"] = max(errs["B1"], hold_case(
                f"W1 kernels: B1 cross over {NP} encoder pages {fmt} "
                f"partitions {parts}", got, want, fmt, want32))
            n += 1
    errs.setdefault("B4", 0.0)
    for fmt, dt in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        for label, Sq in (("encoder", WHISPER_FRAMES),
                          ("cross, prompt", WHISPER_PROMPT),
                          ("cross, one row", 1)):
            q, k, v = flash_inputs(1, Sq, WHISPER_FRAMES, cfg.n_heads, K, dh,
                                   dt, gen)
            want = fa.flash_attention_ref(q, k, v, causal=False)
            for split in (None, 1, 8):
                plan = (None if split is None else
                        flash_plan(q, k, split, causal=False, window=None,
                                   q_offset=0))
                got = fa.flash_attention_cuda(q, k, v, causal=False,
                                              plan=plan)
                err = close_err(got, want, FLASH_TOL[fmt])
                abs_o = float((got.float() - want.float()).abs().max())
                print(f"W1 kernels: B4 {label} {Sq} x {WHISPER_FRAMES} "
                      f"non-causal {cfg.n_heads}/{K} heads x {dh} {fmt} "
                      f"split {split or 'host'}: max_abs_err {abs_o:.3e} "
                      f"rel_err={err:.3e} tol={FLASH_TOL[fmt]:.0e}")
                check(err <= FLASH_TOL[fmt], f"W1 kernels: B4 {label} "
                      f"{fmt} split {split} disagrees with its plain "
                      "version")
                errs["B4"] = max(errs["B4"], abs_o)
                n += 1
    torch.cuda.synchronize()
    print(f"W1 kernels: {n} more cases within tolerance; max_abs_err {errs}")
    return errs


def whisper_timing_phase(rate) -> dict:
    """Each kernel timed at W1's shapes: B1 over the encoder's pages at a
    decode step (4 rows x 8 kv heads x G = 1, dh 64, 96 pages of 16,
    bf16), B4 on the encoder (1536 x 1536 non-causal) and on the
    decoder's cross-attention (40 rows x 1536 non-causal), f32."""
    import torch
    gen = torch.Generator(device="cuda").manual_seed(42)
    flush = torch.empty(64 * 2 ** 20, dtype=torch.float32, device="cuda")
    NP = WHISPER_FRAMES // 16
    return {
        "B1": [timing_shape("whisper cross decode", 4, 8, 1, NP, 16, 64,
                            [WHISPER_FRAMES] * 4, 0, rate, flush, gen)],
        "B4": [flash_timing_shape("whisper encoder", 1, WHISPER_FRAMES, 8, 8,
                                  64, "float32", rate, flush, gen, 10,
                                  causal=False),
               flash_timing_shape("whisper cross", 1, WHISPER_PROMPT, 8, 8,
                                  64, "float32", rate, flush, gen, 10,
                                  Sk=WHISPER_FRAMES, causal=False)]}


def whisper_golden_run(cfg, params, variant, kv_dtype) -> dict:
    """One W1 golden run: 1536 frames (standard normal) and a 40-token
    prompt, one-shot prefill (the encoder once; B4 = 6 encoder + 6
    decoder self + 6 cross), then 8 greedy decode steps (B1 = 8 x (6 self
    + 6 cross) compact, 8 x (6 x 8 + 6) KVNAND-D: the cross-attention is
    one all-heads launch a layer in both variants); every step's logits
    against the port's plain forward on the card over the same frames,
    the prompt and the emitted tokens: within GOLDEN_TOL and the same
    argmax at f32, within WHISPER_BF16_TOL at bf16 (argmax reported)."""
    import torch
    from repro_torch.configs import EngineConfig
    from repro_torch.core.engine import KVNANDEngine
    from repro_torch.kernels import flash_attention
    from repro_torch.kernels.paged_attention import launches
    from repro_torch.models.registry import Model
    t0 = time.perf_counter()
    L, E, K = cfg.n_layers, cfg.encoder_layers, cfg.n_kv_heads
    eng = KVNANDEngine(cfg, EngineConfig(
        page_tokens=16, uniform_lengths=False, kv_dtype=kv_dtype,
        variant=variant), device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(43)
    frames = torch.randn(1, WHISPER_FRAMES, cfg.d_model, generator=gen,
                         device="cuda")
    prompt = torch.randint(0, cfg.vocab_size, (WHISPER_PROMPT,),
                           generator=gen, device="cuda").tolist()
    n, V = len(prompt), cfg.vocab_size
    with torch.no_grad():
        flash_attention.launches.reset()
        launches.reset()
        lg, cache = eng.prefill(params, {
            "tokens": torch.tensor([prompt], device="cuda"),
            "frames": frames}, 256)
        b4 = flash_attention.launches.value
        check(tuple(cache.cross_k.shape) == (L, 1, WHISPER_FRAMES, K,
                                             cfg.d_head)
              and cache.cross_k.dtype == getattr(torch, kv_dtype),
              "W1 golden: the cross K/V leaves are not [L, 1, Senc, K, dh] "
              "in the pool dtype")
        rows, out = [lg[0, :V]], [int(lg[0, :V].argmax())]
        for _ in range(WHISPER_STEPS):
            lg, _ = eng.decode_step(params, cache, torch.tensor(
                [[out[-1]]], device="cuda"))
            rows.append(lg[0, :V])
            out.append(int(lg[0, :V].argmax()))
        b1 = launches.value
        got = torch.stack(rows).float()
        full = Model(cfg).forward(params, {
            "tokens": torch.tensor([prompt + out[:WHISPER_STEPS]],
                                   device="cuda"),
            "frames": frames})[0, n - 1:, :V].float()
    torch.cuda.synchronize()
    err = float((got - full).abs().max() / full.abs().max())
    want = full.argmax(-1).tolist()
    wall = time.perf_counter() - t0
    f32 = kv_dtype == "float32"
    tol = GOLDEN_TOL if f32 else WHISPER_BF16_TOL
    same = sum(a == b for a, b in zip(out, want))
    label = f"W1 golden {variant} {kv_dtype}"
    print(f"{label}: {WHISPER_FRAMES} frames, {n}-token prompt, one-shot "
          f"prefill + {WHISPER_STEPS} decode steps: max |logits - plain "
          f"forward| / max |logits| = {err:.3e} (tol {tol:.0e}); argmax "
          f"{same} of {len(out)} equal ({out} vs {want}); B4 launches {b4}, "
          f"B1 launches {b1}; {wall:.3f} s")
    self_b1 = L * (K if variant == "discrete" else 1)
    check(b4 == E + 2 * L and b1 == WHISPER_STEPS * (self_b1 + L),
          f"{label}: B4 {b4} != {E} + 2 x {L} or B1 {b1} != "
          f"{WHISPER_STEPS} x ({self_b1} + {L})")
    check(err <= tol, f"{label}: logits disagree with the plain forward")
    check(out == want or not f32, f"{label}: a greedy token differs from "
          "the plain forward's")
    return {"rel_err": err, "argmax_equal": same, "tokens": out,
            "launches_B1": b1, "launches_B4": b4, "wall_s": wall}


def audio_phases(rate) -> dict:
    """Phase 24, W1 (see the module docstring)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models.registry import Model
    cfg = get_config("whisper-base")
    check_whisper_widths(cfg)
    t0 = time.perf_counter()
    params = Model(cfg).init(torch.Generator(device="cuda").manual_seed(0))
    torch.cuda.synchronize()
    n = sum(t.numel() for t in _leaves(params))
    print(f"W1: {cfg.name} weights, {n / 1e6:.2f}M params (config: "
          f"{cfg.param_count() / 1e6:.2f}M), drawn on the card in "
          f"{time.perf_counter() - t0:.2f} s")
    res = {"params": n, "kernels": whisper_kernel_phase(cfg),
           "timing": whisper_timing_phase(rate), "golden": {}}
    for variant in ("compact", "discrete"):
        for kv_dtype in ("float32", "bfloat16"):
            res["golden"][f"{variant} {kv_dtype}"] = whisper_golden_run(
                cfg, params, variant, kv_dtype)
    res["launches"] = {k: sum(g[f"launches_{k}"]
                              for g in res["golden"].values())
                       for k in ("B1", "B4")}
    print(f"W1: launches on the main path {res['launches']}; on "
          f"{smi_line()}")
    return res


# ---------------------------------------------------------------------------
# L1: training (qwen1.5-0.5b at full width and depth, hymba-1.5b)
# ---------------------------------------------------------------------------

# launch/train.py's defaults, the reference driver's
TRAIN_SEQ, TRAIN_BATCH, TRAIN_LR = 256, 8, 3e-3
TRAIN_STEPS = 40
# step 0 on the kernel path (B4 under autograd) against impl="ref" on the
# card: the loss (relative), the global gradient norm (relative), and
# every gradient leaf within TRAIN_LEAF_TOL of its own max |g|; the same
# bounds hold remat and microbatches against remat="none".  The k bias's
# gradient is 0 in exact arithmetic (the softmax cancels a shift of a
# row's scores), so both sides of it are float32 noise: that leaf is held
# to TRAIN_LEAF_TOL of the max |g| of its layers' wk_w instead
TRAIN_LOSS_TOL = 1e-4
TRAIN_NORM_TOL = 1e-3
TRAIN_LEAF_TOL = 2e-3
# (d): the mean of the last 5 of the 40 losses below the mean of the
# first 5 by at least TRAIN_FALL nats, at TRAIN_FALL_LR.  At the reference
# driver's lr 3e-3 full-width qwen1.5-0.5b does not learn SyntheticLM in 40
# steps (first 5 12.3639, last 5 12.3859 on the card; the successor table
# of 151936 tokens is barely seen and the normalized updates random-walk
# every embedding row); a CPU rehearsal at full width and vocab, 1 layer,
# fell 0.1117 at 3e-3 (spiking mid-run), 0.1162 at 1e-3 and 0.0248 at
# 3e-4 (PERF.md §4, PR 27)
TRAIN_FALL_LR = 1e-3
TRAIN_FALL = 0.05
# (d)'s witness at the reference driver's lr (TRAIN_LR): the same
# TRAIN_STEPS steps through launch.train on the kernel path and on the
# plain path (impl="ref", no B4), loss for loss within TRAIN_TRACK_TOL
# nats, so that what the kernel path does at 3e-3 is what the plain
# attention does too
TRAIN_TRACK_TOL = 2e-2
RESUME_STEPS, RESUME_AT = 6, 3
# hymba-1.5b: 1024 tokens after its 128 meta tokens, so the 1024-token
# window cuts in; 2 rows; remat="block" (each layer's SSM scan keeps ~4 GB
# of activations); the default run cuts it to HYMBA_TRAIN_LAYERS (15 is
# its first global layer), `--train` runs all 32
HYMBA_TRAIN_SEQ, HYMBA_TRAIN_BATCH, HYMBA_TRAIN_STEPS = 1024, 2, 5
HYMBA_TRAIN_LAYERS = 16
# B4 under autograd: FlashAttentionFn (B4 forward, torch-op backward)
# against autograd through the plain version, at the training shapes
FLASH_GRAD_SHAPES = (
    # label, B, Sq, Sk, H, K, dh, causal, window
    ("qwen1.5-0.5b", 2, 256, 256, 16, 16, 64, True, None),
    ("hymba-1.5b", 2, 1152, 1152, 25, 5, 64, True, 1024),
    ("GQA 32/8 x 128", 2, 600, 600, 32, 8, 128, True, None),
    ("whisper encoder", 2, 1536, 1536, 8, 8, 64, False, None),
    ("whisper cross", 2, 256, 1536, 8, 8, 64, False, None),
)


def flash_grad_phase() -> dict:
    """dq / dk / dv of `FlashAttentionFn` with B4's forward against
    autograd through the plain version on the card (FLASH_TOL of max
    |grad|, f32 and bf16), then fwd + bwd timed at qwen1.5-0.5b's
    training shape beside the plain version under autograd and SDPA's."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import (FlashAttentionFn,
                                                     flash_attention_cuda,
                                                     flash_attention_ref)
    gen = torch.Generator(device="cuda").manual_seed(27)
    worst = {}
    for label, B, Sq, Sk, H, K, dh, causal, window in FLASH_GRAD_SHAPES:
        for dtype in ("float32", "bfloat16"):
            q, k, v = (t.requires_grad_() for t in flash_inputs(
                B, Sq, Sk, H, K, dh, getattr(torch, dtype), gen))
            dout = torch.randn_like(q)
            got = torch.autograd.grad(FlashAttentionFn.apply(
                q, k, v, causal, window, 0, flash_attention_cuda),
                (q, k, v), dout)
            want = torch.autograd.grad(flash_attention_ref(
                q, k, v, causal=causal, window=window), (q, k, v), dout)
            tol = FLASH_TOL["f32" if dtype == "float32" else "bf16"]
            errs = [float((a.float() - b.float()).abs().max())
                    / float(b.float().abs().max()) for a, b in zip(got, want)]
            print(f"L1 B4 grad {label} B={B} Sq={Sq} Sk={Sk} {H}/{K} x {dh} "
                  f"{'causal' if causal else 'non-causal'} window={window} "
                  f"{dtype}: dq/dk/dv within "
                  + " / ".join(f"{e:.3e}" for e in errs)
                  + f" of max |grad| (tol {tol:.0e})")
            check(max(errs) <= tol, f"L1: B4's gradient at {label} {dtype} "
                  f"off by {max(errs):.3e} > {tol:.0e}")
            worst[f"{label} {dtype}"] = max(errs)
    B, S, H, K, dh = TRAIN_BATCH, TRAIN_SEQ, 16, 16, 64
    q, k, v = (t.requires_grad_() for t in flash_inputs(
        B, S, S, H, K, dh, torch.float32, gen))
    dout = torch.randn_like(q)
    qs, ks, vs = (t.detach().transpose(1, 2).contiguous().requires_grad_()
                  for t in (q, k, v))
    flush = torch.empty(64 * 2 ** 20, dtype=torch.float32, device="cuda")

    def fwd_bwd(fn, args, grad):
        return lambda: torch.autograd.grad(fn(*args), args, grad)
    times = {
        "ms": time_ms(fwd_bwd(lambda *a: FlashAttentionFn.apply(
            *a, True, None, 0, flash_attention_cuda), (q, k, v), dout),
            10, flush),
        "plain_ms": time_ms(fwd_bwd(lambda *a: flash_attention_ref(*a),
                                    (q, k, v), dout), 5, flush),
        "library_ms": time_ms(fwd_bwd(
            lambda *a: F.scaled_dot_product_attention(*a, is_causal=True),
            (qs, ks, vs), dout.transpose(1, 2).contiguous()), 10, flush)}
    timing = {k: statistics.median(t) for k, t in times.items()}
    print(f"L1 B4 under autograd, fwd + bwd at B={B} S={S} {H} x {dh} f32 "
          "causal (median): " + " ".join(f"{k}={t:.6f}"
                                         for k, t in timing.items())
          + " (library: SDPA forward and backward, f32)")
    return {"max_rel_err": worst, "timing": timing}


def grad_compare(label, got, want) -> dict:
    """Step-0 readings of one run against another: the loss, the global
    gradient norm, every leaf (TRAIN_* bounds; the k bias against its
    layers' wk_w, see TRAIN_LEAF_TOL)."""
    import torch
    from repro_torch.bridge import flatten_with_paths
    (gg, gm), (wg, wm) = got, want
    loss = abs(float(gm["loss"]) - float(wm["loss"])) / abs(float(wm["loss"]))
    norm = (lambda t: float(torch.sqrt(sum(torch.sum(x.double() ** 2)
                                           for x in _leaves(t)))))
    gnorm = abs(norm(gg) - norm(wg)) / norm(wg)
    gflat, wflat = flatten_with_paths(gg), flatten_with_paths(wg)
    leaf = {}
    for path, w in wflat.items():
        scale = float(wflat[path[:-1] + "w" if path.endswith("wk_b")
                            else path].abs().max())
        leaf[path] = float((gflat[path] - w).abs().max()) / scale
    worst = max(leaf, key=leaf.get)
    print(f"L1 {label}: loss {float(gm['loss']):.6f} vs "
          f"{float(wm['loss']):.6f} ({loss:.3e}), grad norm {gnorm:.3e}, "
          f"worst leaf {worst} {leaf[worst]:.3e} (k bias "
          + ", ".join(f"{leaf[p]:.3e}" for p in leaf if p.endswith("wk_b"))
          + ")")
    check(loss <= TRAIN_LOSS_TOL and gnorm <= TRAIN_NORM_TOL
          and leaf[worst] <= TRAIN_LEAF_TOL,
          f"L1 {label}: loss {loss:.3e} (tol {TRAIN_LOSS_TOL:.0e}), grad "
          f"norm {gnorm:.3e} ({TRAIN_NORM_TOL:.0e}), {worst} "
          f"{leaf[worst]:.3e} ({TRAIN_LEAF_TOL:.0e})")
    return {"loss_rel": loss, "grad_norm_rel": gnorm, "worst_leaf": worst,
            "worst_leaf_rel": leaf[worst]}


def train_batch(cfg, seq, batch, index=0):
    import torch
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    src = SyntheticLM(DataConfig(seq_len=seq, global_batch=batch,
                                 vocab_size=cfg.vocab_size, seed=0))
    return {k: torch.from_numpy(v).cuda() for k, v in
            src.batch(index).items()}


def grads_run(params, cfg, batch, rt, remat="none", microbatches=1):
    """Step 0's gradients and metrics, with the B1-B5 launches it made
    and its peak device memory."""
    import torch
    from repro_torch.kernels import flash_attention, paged_attention, \
        quant_gemv, wkv6
    from repro_torch.training.train_step import grads_and_metrics
    counters = {"B1": paged_attention.launches,
                "B2": paged_attention.launches_shared,
                "B3": quant_gemv.launches, "B4": flash_attention.launches,
                "B5": wkv6.launches}
    for c in counters.values():
        c.reset()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = grads_and_metrics(params, batch, cfg, rt, remat, microbatches)
    torch.cuda.synchronize()
    info = {"wall_s": time.perf_counter() - t0,
            "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
            "launches": {k: c.value for k, c in counters.items()}}
    check(all(n == 0 for k, n in info["launches"].items() if k != "B4"),
          f"L1: a kernel other than B4 ran in training: {info['launches']}")
    return out, info


def step_timing(cfg, params, batch, rt, acfg, remat, reps=5) -> dict:
    """Host wall of `reps` train steps after one warm-up (each ending in
    a synchronize), tokens a second over the batch's token positions,
    and the B4 launches of the reps + 1 steps.  Updates `params` in
    place."""
    import torch
    from repro_torch.configs import EngineConfig
    from repro_torch.kernels import flash_attention
    from repro_torch.training.train_step import (init_train_state,
                                                 make_train_step)
    step = make_train_step(cfg, rt, acfg, EngineConfig(remat=remat))
    state = init_train_state(params, acfg)
    flash_attention.launches.reset()
    walls, losses = [], []
    for i in range(reps + 1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = step(state, batch)
        losses.append(float(m["loss"]))
        walls.append(time.perf_counter() - t0)
    ms = statistics.median(walls[1:]) * 1e3
    tokens = batch["tokens"].numel()
    return {"step_ms": ms, "tokens_per_s": tokens / ms * 1e3,
            "losses": losses, "step_ms_all": [w * 1e3 for w in walls],
            "launches_B4": flash_attention.launches.value}


def qwen_train_phase() -> dict:
    """L1's qwen1.5-0.5b gates (a)-(e) (see the module docstring)."""
    import gc
    import shutil
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention
    from repro_torch.launch.train import train
    from repro_torch.models.registry import Model
    from repro_torch.models.transformer import Runtime
    from repro_torch.training.optimizer import AdamWConfig
    cfg = get_config("qwen1.5-0.5b")
    check(cfg.n_layers == 24 and cfg.d_model == 1024 and cfg.n_heads == 16
          and cfg.n_kv_heads == 16 and cfg.d_head == 64 and cfg.attn_bias
          and cfg.d_ff == 2816 and cfg.vocab_size == 151936
          and cfg.tie_embeddings, "not the full-width qwen1.5-0.5b")
    params = Model(cfg).init(torch.Generator(device="cuda").manual_seed(0))
    n = sum(t.numel() for t in _leaves(params))
    print(f"L1: {cfg.name}, {n / 1e9:.3f}B params ({4 * n / 1e9:.2f} GB "
          f"float32, AdamW state {12 * n / 1e9:.2f} GB), seq {TRAIN_SEQ} x "
          f"batch {TRAIN_BATCH}")
    batch = train_batch(cfg, TRAIN_SEQ, TRAIN_BATCH)
    res = {"params": n, "runs": {}}
    kern, info = grads_run(params, cfg, batch, Runtime())
    res["runs"]["kernel"] = info
    plain, pinfo = grads_run(params, cfg, batch, Runtime(attn_impl="ref"))
    res["runs"]["plain"] = pinfo
    check(pinfo["launches"]["B4"] == 0, "L1: impl='ref' launched B4")
    res["a"] = grad_compare("(a) kernel vs plain, step 0", kern, plain)
    del plain
    check(info["launches"]["B4"] == cfg.n_layers,
          f"L1: {info['launches']['B4']} B4 launches in a step, not "
          f"{cfg.n_layers}")
    res["b"] = {}
    for label, remat, mb in (("remat block", "block", 1),
                             ("remat full", "full", 1),
                             ("2 microbatches", "none", 2)):
        got, ginfo = grads_run(params, cfg, batch, Runtime(), remat, mb)
        res["runs"][label] = ginfo
        res["b"][label] = grad_compare(f"(b) {label} vs none", got, kern)
        del got
        check(ginfo["launches"]["B4"] == 2 * cfg.n_layers,
              f"L1: {label} launched B4 {ginfo['launches']['B4']} times, "
              f"not {2 * cfg.n_layers}")
    del kern
    for label, r in res["runs"].items():
        print(f"L1 (c) {label}: B4 {r['launches']['B4']} launches, peak "
              f"{r['peak_gb']:.2f} GB, {r['wall_s']:.2f} s")
    acfg = AdamWConfig(lr=TRAIN_LR, warmup_steps=2, total_steps=TRAIN_STEPS)
    res["timing"] = step_timing(cfg, params, batch, Runtime(), acfg, "none")
    print(f"L1 step time: {res['timing']['step_ms']:.1f} ms median of 5 "
          f"(after one), {res['timing']['tokens_per_s']:.0f} tokens/s, "
          f"remat none, on {smi_line()}")
    del params, batch
    gc.collect()
    torch.cuda.empty_cache()
    res["witness"] = lr_witness(cfg)
    flash_attention.launches.reset()
    t0 = time.perf_counter()
    losses = train(["--steps", str(TRAIN_STEPS), "--lr", str(TRAIN_FALL_LR),
                    "--log-every", "10"])
    res["d"] = {"losses": losses, "wall_s": time.perf_counter() - t0,
                "launches_B4": flash_attention.launches.value}
    first, last = np.mean(losses[:5]), np.mean(losses[-5:])
    print(f"L1 (d) {TRAIN_STEPS} steps through launch.train at lr "
          f"{TRAIN_FALL_LR}: first 5 mean "
          f"{first:.4f}, last 5 mean {last:.4f} (fall {first - last:.4f}, "
          f"gate {TRAIN_FALL}), B4 {res['d']['launches_B4']}, "
          f"{res['d']['wall_s']:.1f} s")
    check(all(np.isfinite(losses)) and last < first - TRAIN_FALL,
          f"L1: the loss did not fall by {TRAIN_FALL}: {first} -> {last}")
    check(res["d"]["launches_B4"] == TRAIN_STEPS * cfg.n_layers,
          f"L1: {res['d']['launches_B4']} B4 launches over {TRAIN_STEPS} "
          "steps")
    res["e"] = resume_phase(cfg)
    check(res["timing"]["launches_B4"] == 6 * cfg.n_layers,
          f"L1: {res['timing']['launches_B4']} B4 launches in 6 steps")
    res["launches_B4"] = (sum(r["launches"]["B4"]
                              for r in res["runs"].values())
                          + res["timing"]["launches_B4"]
                          + res["witness"]["launches_B4"]
                          + res["d"]["launches_B4"] + res["e"]["launches_B4"])
    gc.collect()
    torch.cuda.empty_cache()
    shutil.rmtree(ROOT / "build" / "train_ckpt", ignore_errors=True)
    return res


def lr_witness(cfg) -> dict:
    """(d)'s witness: TRAIN_STEPS steps of `launch.train` at the reference
    driver's lr on the kernel path and on the plain path (impl="ref"),
    held loss for loss within TRAIN_TRACK_TOL; each run's fall (the mean
    of the first 5 losses less that of the last 5) printed."""
    import numpy as np
    from repro_torch.kernels import flash_attention
    from repro_torch.launch.train import train
    from repro_torch.models.transformer import Runtime
    argv = ["--steps", str(TRAIN_STEPS), "--lr", str(TRAIN_LR),
            "--log-every", "10"]
    runs, launches = {}, {}
    for key, rt in (("kernel", Runtime()),
                    ("plain", Runtime(attn_impl="ref"))):
        flash_attention.launches.reset()
        runs[key] = np.array(train(argv, rt=rt))
        launches[key] = flash_attention.launches.value
    gap = np.abs(runs["kernel"] - runs["plain"])
    fall = {k: float(v[:5].mean() - v[-5:].mean()) for k, v in runs.items()}
    at = [*range(0, TRAIN_STEPS - 1, 10), TRAIN_STEPS - 1]
    print(f"L1 (d) witness at lr {TRAIN_LR}, {TRAIN_STEPS} steps: kernel "
          f"path fall {fall['kernel']:.4f}, plain path fall "
          f"{fall['plain']:.4f}; losses apart by at most {gap.max():.3e} "
          f"(step {int(gap.argmax())}; tol {TRAIN_TRACK_TOL:.0e}); kernel / "
          f"plain at steps {at}: " + ", ".join(
              f"{runs['kernel'][i]:.4f}/{runs['plain'][i]:.4f}" for i in at))
    check(all(np.isfinite(v).all() for v in runs.values())
          and gap.max() <= TRAIN_TRACK_TOL,
          f"L1: at lr {TRAIN_LR} the kernel path parts from the plain path "
          f"by {gap.max():.3e} nats")
    check(launches["kernel"] == TRAIN_STEPS * cfg.n_layers
          and launches["plain"] == 0,
          f"L1: witness B4 launches {launches}")
    return {"losses": {k: v.tolist() for k, v in runs.items()},
            "fall": fall, "max_gap": float(gap.max()),
            "launches_B4": launches["kernel"]}


def resume_phase(cfg) -> dict:
    """(e): RESUME_STEPS steps straight through launch.train, saving every
    RESUME_AT - 1 steps (the save after step RESUME_AT - 1 holds RESUME_AT
    updates); then its later checkpoints set aside and a resume from the
    step-RESUME_AT one for the remaining steps: its losses and final
    state against the straight run's, bit for bit or within the bound
    printed."""
    import shutil
    import numpy as np
    from repro_torch.checkpoint import checkpoint as ck
    from repro_torch.kernels import flash_attention
    from repro_torch.launch.train import train
    d = ROOT / "build" / "train_ckpt"
    shutil.rmtree(d, ignore_errors=True)
    d.mkdir(parents=True)
    free = shutil.disk_usage(d).free / 1e9
    print(f"L1 (e): {free:.1f} GB free beside {d}")
    argv = ["--steps", str(RESUME_STEPS), "--log-every", "1", "--ckpt-dir",
            str(d / "run")]
    flash_attention.launches.reset()
    t0 = time.perf_counter()
    straight = train(argv + ["--ckpt-every", str(RESUME_AT - 1)])
    walls = [time.perf_counter() - t0]
    steps = ck.list_steps(str(d / "run"))
    check(steps == [RESUME_AT, RESUME_STEPS - 1, RESUME_STEPS],
          f"L1: checkpoints {steps}")
    (d / "run" / f"step_{RESUME_STEPS:08d}").rename(d / "straight")
    shutil.rmtree(d / "run" / f"step_{RESUME_STEPS - 1:08d}")
    t0 = time.perf_counter()
    # no periodic save on the way: only the final one is compared
    resumed = train(argv + ["--ckpt-every", str(RESUME_STEPS)])
    walls.append(time.perf_counter() - t0)
    launches = flash_attention.launches.value
    want = np.load(d / "straight" / "arrays.npz")
    got = np.load(d / "run" / f"step_{RESUME_STEPS:08d}" / "arrays.npz")
    check(sorted(got.files) == sorted(want.files), "L1: resumed keys")
    worst, bitwise = 0.0, True
    for key in want.files:
        a, b = got[key], want[key]
        bitwise &= bool(np.array_equal(a, b))
        if a.dtype.kind == "f":
            worst = max(worst, float(np.max(np.abs(a - b))))
    loss_gap = max(abs(a - b) for a, b in zip(resumed,
                                              straight[RESUME_AT:]))
    print(f"L1 (e) resume: straight {['%.6f' % x for x in straight]}, "
          f"resumed {['%.6f' % x for x in resumed]}; losses "
          f"{'equal' if loss_gap == 0 else f'apart by {loss_gap:.3e}'}, "
          f"final state {'bit for bit' if bitwise else f'within {worst:.3e}'}"
          f"; walls {walls[0]:.1f} / {walls[1]:.1f} s (checkpoints of "
          f"params, m and v included)")
    check(len(resumed) == RESUME_STEPS - RESUME_AT
          and loss_gap <= 1e-5 * abs(straight[-1]) and worst <= 1e-5,
          f"L1: the resumed run parts from the straight one: losses "
          f"{loss_gap:.3e}, state {worst:.3e}")
    check(launches == (2 * RESUME_STEPS - RESUME_AT) * cfg.n_layers,
          f"L1: {launches} B4 launches over the resume runs")
    return {"straight": straight, "resumed": resumed, "bitwise": bitwise,
            "loss_gap": loss_gap, "state_gap": worst, "walls_s": walls,
            "launches_B4": launches}


def hymba_train_phase() -> dict:
    """L1's hymba-1.5b gates: step 0 on the kernel path against impl="ref"
    on the card, then HYMBA_TRAIN_STEPS steps of finite, falling loss."""
    import dataclasses
    import gc
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models.registry import Model
    from repro_torch.models.transformer import Runtime
    from repro_torch.training.optimizer import AdamWConfig
    cfg = get_config("hymba-1.5b")
    check(cfg.d_model == 1600 and cfg.n_heads == 25 and cfg.n_kv_heads == 5
          and cfg.d_head == 64 and cfg.n_meta_tokens == 128
          and cfg.window == 1024, "not the full-width hymba-1.5b")
    cfg = dataclasses.replace(cfg, n_layers=depth(HYMBA_TRAIN_LAYERS, 32))
    params = Model(cfg).init(torch.Generator(device="cuda").manual_seed(0))
    n = sum(t.numel() for t in _leaves(params))
    print(f"L1: {cfg.name} at {cfg.n_layers} layers, {n / 1e9:.3f}B params "
          f"({16 * n / 1e9:.2f} GB with grads and AdamW state), seq "
          f"{HYMBA_TRAIN_SEQ} + {cfg.n_meta_tokens} meta x batch "
          f"{HYMBA_TRAIN_BATCH}, remat block")
    batch = train_batch(cfg, HYMBA_TRAIN_SEQ, HYMBA_TRAIN_BATCH)
    kern, info = grads_run(params, cfg, batch, Runtime(), "block")
    plain, pinfo = grads_run(params, cfg, batch, Runtime(attn_impl="ref"),
                             "block")
    res = {"layers": cfg.n_layers, "params": n,
           "runs": {"kernel": info, "plain": pinfo},
           "a": grad_compare("hymba (a) kernel vs plain, step 0", kern,
                             plain)}
    del kern, plain
    check(info["launches"]["B4"] == 2 * cfg.n_layers,
          f"L1 hymba: {info['launches']['B4']} B4 launches in a step")
    acfg = AdamWConfig(lr=TRAIN_LR, warmup_steps=2,
                       total_steps=HYMBA_TRAIN_STEPS)
    res["timing"] = step_timing(cfg, params, batch, Runtime(), acfg, "block",
                                reps=HYMBA_TRAIN_STEPS - 1)
    losses = res["timing"]["losses"]
    print(f"L1 hymba: B4 {info['launches']['B4']} a step, peak "
          f"{info['peak_gb']:.2f} GB (plain {pinfo['peak_gb']:.2f}); losses "
          f"{['%.4f' % x for x in losses]}; step {res['timing']['step_ms']:.1f}"
          f" ms, {res['timing']['tokens_per_s']:.0f} tokens/s on "
          f"{smi_line()}")
    check(all(np.isfinite(losses)) and losses[-1] < losses[0],
          f"L1 hymba: the loss did not fall: {losses}")
    check(res["timing"]["launches_B4"]
          == HYMBA_TRAIN_STEPS * 2 * cfg.n_layers,
          f"L1 hymba: {res['timing']['launches_B4']} B4 launches in "
          f"{HYMBA_TRAIN_STEPS} steps")
    res["launches_B4"] = (info["launches"]["B4"]
                          + res["timing"]["launches_B4"])
    del params, batch
    gc.collect()
    torch.cuda.empty_cache()
    return res


def train_phases(rate) -> dict:
    """L1 (see the module docstring)."""
    import torch
    flash = flash_grad_phase()
    gen = torch.Generator(device="cuda").manual_seed(28)
    flush = torch.empty(64 * 2 ** 20, dtype=torch.float32, device="cuda")
    timing = [flash_timing_shape("L1 train qwen", TRAIN_BATCH, TRAIN_SEQ,
                                 16, 16, 64, "float32", rate, flush, gen, 10)]
    del flush
    qwen = qwen_train_phase()
    hymba = hymba_train_phase()
    res = {"flash_grad": flash, "timing": timing, "qwen": qwen,
           "hymba": hymba,
           "launches_B4": qwen["launches_B4"] + hymba["launches_B4"]}
    print(f"L1: B4 launches on the main path {res['launches_B4']}; on "
          f"{smi_line()}")
    return res


# ---------------------------------------------------------------------------
# phase 26: X1, the device mesh
# ---------------------------------------------------------------------------

# X1 runs on a single-process mesh of eight `cuda:0` entries: the sharded
# dataflow (per-shard pools, one B1 / B2 launch a shard, the combine) on
# one card.  llama3.1-8b's depth in the default run (`--mesh`: 32 layers)
MESH_LAYERS = 8
MESH_SHAPE = (2, 4)                         # (data, model)
MESH_PROMPT, MESH_SLOTS, MESH_STEPS, MESH_CHUNK = 512, 4, 16, 64
MESH_T = 16
# the mesh run against the same engine with mesh=None on the card, max
# |logit difference| / max |logit|: f32 pools differ in summation order
# only (the partials split over 4 page shards, the ring's blocks); kv8 is
# held to the reference's own kv8 mesh bound (tests/test_multidevice.py)
MESH_F32_TOL = 1e-4
MESH_KV8_TOL = 5e-3
# the compressed train step against the exact step: the reference's own
# bounds (tests/test_multidevice.py::test_compressed_train_step_close_to_exact)
MESH_TRAIN_LOSS_TOL = 1e-3
MESH_TRAIN_PARAM_TOL = 0.05
# the exact step under the ring (mesh) against the same step through B4
MESH_RING_LOSS_TOL = 1e-5


def card_mesh(shape, axes):
    """A mesh of `cuda:0` entries (the card named once per coordinate)."""
    from repro_torch.distributed.sharding import Mesh
    return Mesh(["cuda:0"] * math.prod(shape), axes, shape=shape)


def llama3_cfg():
    """Full-width llama3.1-8b (GQA 32 / 8 heads x 128, like the paper's
    70B) cut to MESH_LAYERS layers in the default run."""
    import dataclasses
    from repro_torch.configs import get_config
    cfg = get_config("llama3.1-8b")
    check(cfg.n_layers == 32 and cfg.d_model == 4096 and cfg.n_heads == 32
          and cfg.n_kv_heads == 8 and cfg.d_head == 128
          and cfg.d_ff == 14336 and cfg.vocab_size == 128256,
          "not the full-width llama3.1-8b")
    return dataclasses.replace(cfg, n_layers=depth(MESH_LAYERS, 32))


def mesh_counts() -> dict:
    from repro_torch.kernels import flash_attention as tfa
    from repro_torch.kernels import paged_attention as tpa
    return {"B1": tpa.launches.value, "B2": tpa.launches_shared.value,
            "B4": tfa.launches.value}


def mesh_reset():
    from repro_torch.kernels import flash_attention as tfa
    from repro_torch.kernels import paged_attention as tpa
    for c in (tpa.launches, tpa.launches_shared, tfa.launches):
        c.reset()


def mesh_engine_run(engine, params, toks, feed=None, chunked=False,
                    empty=False) -> dict:
    """Prefill toks [B, MESH_PROMPT] (one-shot, or MESH_CHUNK-token chunks
    slot by slot), then MESH_STEPS decode steps, each fed the previous
    step's argmax, or `feed` [B, steps] (teacher forcing: the mesh=None
    run's greedy tokens).  `empty`: no prefill, 4 x MESH_T decode steps
    from an empty shared-pool cache whose tables scatter every slot's
    pages over the pool (the same permutation in every run), fed
    toks[:, :steps].  Returns the logits of every step, the tokens, the
    host walls and the launch counts."""
    import numpy as np
    import torch
    from repro_torch.core import paged_kv
    B = toks.shape[0]
    ctx = MESH_PROMPT + MESH_STEPS
    steps = mesh_steps(empty)
    mesh_reset()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits = []
    if empty:
        cache = engine.init_cache(B, ctx)
        NP = cache.page_table_g.shape[1]
        perm = np.random.default_rng(11).permutation(
            cache.k_pages_g.shape[2])[:B * NP]
        paged_kv.write_page_table(cache.page_table_g,
                                  perm.reshape(B, NP).astype(np.int32))
    elif chunked:
        cache = engine.init_cache(B, ctx)
        last = []
        for b in range(B):
            for c0 in range(0, MESH_PROMPT, MESH_CHUNK):
                lg, cache = engine.prefill_chunk(
                    params, cache, {"tokens": toks[b:b + 1, c0:c0 + MESH_CHUNK]},
                    b, c0, MESH_CHUNK, first=c0 == 0)
            last.append(lg)
        logits.append(torch.cat(last))
    else:
        lg, cache = engine.prefill(params, {"tokens": toks}, ctx)
        logits.append(lg)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    prefill_counts = mesh_counts()
    walls = []
    for i in range(steps):
        if empty:
            nxt = toks[:, i:i + 1]
        elif feed is not None:
            nxt = feed[:, i:i + 1]
        else:
            nxt = logits[-1].argmax(-1)[:, None]
        t1 = time.perf_counter()
        lg, cache = engine.decode_step(params, cache, nxt)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t1)
        logits.append(lg)
    out = torch.stack(logits[1:] if empty else logits)
    counts = mesh_counts()
    return {"logits": out, "tokens": out.argmax(-1), "prefill_s": prefill_s,
            "step_ms": statistics.median(walls) * 1e3,
            "prefill_counts": prefill_counts,
            "decode_counts": {k: counts[k] - prefill_counts[k]
                              for k in counts},
            "finite": bool(torch.isfinite(out).all()), "cache": cache}


def mesh_steps(empty: bool) -> int:
    """Decode steps of a run: MESH_STEPS after a prefill, 4 pages' worth
    from an empty cache."""
    return 4 * MESH_T if empty else MESH_STEPS


def mesh_pair(label, cfg, params, eng, toks, tol, chunked=False,
              empty=False) -> dict:
    """One deployment on the mesh against the same engine with mesh=None
    on the card: greedy tokens identical at every step, logits within
    `tol` of max |logit|; B1 (stripe) or B2 (shared) launched once a
    page shard a layer a decode step."""
    import torch
    from repro_torch.core.engine import KVNANDEngine
    from repro_torch.distributed.sharding import ShardedTensor
    mesh = card_mesh(MESH_SHAPE, ("data", "model"))
    solo = mesh_engine_run(KVNANDEngine(cfg, eng, device="cuda"), params,
                           toks, chunked=chunked, empty=empty)
    feed = None if empty else solo["tokens"][:-1].t().contiguous()
    run = mesh_engine_run(KVNANDEngine(cfg, eng, mesh=mesh), params, toks,
                          feed=feed, chunked=chunked, empty=empty)
    cache = run.pop("cache")
    solo.pop("cache")
    pool = cache.k_pages_g
    check(isinstance(pool, ShardedTensor) and len(pool.shards) == mesh.size
          and len({t.data_ptr() for t in pool.shards}) == mesh.size,
          f"X1 {label}: the pool is not eight shard-local tensors")
    del cache
    check(run["finite"] and solo["finite"], f"X1 {label}: logits not finite")
    gap = float((run["logits"] - solo["logits"]).abs().max()
                / solo["logits"].abs().max())
    same = bool(torch.equal(run["tokens"], solo["tokens"]))
    kernel = "B2" if eng.shared_pool else "B1"
    shards = mesh.shape["data"] * mesh.shape["model"]
    steps = mesh_steps(empty)
    predicted = steps * shards * cfg.n_layers
    counted = run["decode_counts"][kernel]
    print(f"X1 {label}: logit gap {gap:.3e} (tol {tol:.0e}); greedy tokens "
          f"{'identical' if same else 'DIFFER'} over "
          f"{steps + (0 if empty else 1)} steps x {toks.shape[0]} slots; "
          f"{kernel} launches predicted {predicted} (data "
          f"{mesh.shape['data']} x page shards {mesh.shape['model']} x "
          f"{cfg.n_layers} layers x {steps} steps), counted {counted}; "
          f"mesh=None {solo['decode_counts'][kernel]}"
          f"; prefill counts {run['prefill_counts']}; host wall per decode "
          f"step {run['step_ms']:.1f} ms (mesh=None {solo['step_ms']:.1f} "
          f"ms), prefill {run['prefill_s']:.2f} s (mesh=None "
          f"{solo['prefill_s']:.2f} s)")
    check(same, f"X1 {label}: greedy tokens differ from mesh=None's")
    check(gap <= tol, f"X1 {label}: logit gap {gap:.3e} > {tol:.0e}")
    check(counted == predicted, f"X1 {label}: {kernel} launched {counted} "
          f"times, predicted {predicted}")
    other = "B1" if kernel == "B2" else "B2"
    check(run["decode_counts"][other] == 0 and run["prefill_counts"]["B1"]
          == 0 and run["prefill_counts"]["B2"] == 0,
          f"X1 {label}: unexpected launches {run['decode_counts']}")
    if not chunked and not empty:
        check(run["prefill_counts"]["B4"] == 0,
              f"X1 {label}: the mesh prefill took B4, not the ring")
    return {"logit_gap": gap, "tokens_identical": same,
            "launches": {kernel: counted}, "predicted": predicted,
            "step_ms": run["step_ms"], "step_ms_no_mesh": solo["step_ms"],
            "prefill_s": run["prefill_s"],
            "prefill_s_no_mesh": solo["prefill_s"]}


def mesh_kernel_holds(gen) -> dict:
    """B1 and B2 through the sharded decode at X1's shape (4 slots x 36
    pages of 16 tokens, 32 / 8 heads x 128; each of the 8 shards holds 2
    slots x 9 pages, or 36 of the shared pool's 144): the sharded call
    (one launch a shard, the combine) against the single-device kernel
    over the whole pool and against the plain version, f32 and kv8;
    ragged lengths, a permuted table."""
    import torch
    from repro_torch.core import seqpar
    from repro_torch.kernels import paged_attention as tpa
    from repro_torch.kernels.paged_attention import (
        paged_attention_partial, paged_attention_partial_ref,
        paged_attention_shared_ref)
    mesh = card_mesh(MESH_SHAPE, ("data", "model"))
    B, K, G, NP, T, dh = MESH_SLOTS, 8, 4, 36, MESH_T, 128
    lengths = [528, 301, 17, 576]
    errs = {"B1": 0.0, "B2": 0.0}
    times = {}
    flush = torch.empty(64 * 2 ** 20, dtype=torch.float32, device="cuda")
    for fmt in ("f32", "kv8"):
        fq = kv_quant_of(fmt)
        q, kp, vp, base, length, ks, vs = make_inputs(B, K, G, NP, T, dh,
                                                      fmt, lengths, gen)
        tpa.launches.reset()
        got = seqpar.paged_decode_attention_sharded(
            q, kp, vp, base, length, mesh, kv_quant=fq, k_scale=ks,
            v_scale=vs)
        torch.cuda.synchronize()
        check(tpa.launches.value == 8, "X1 hold: B1 not launched once a "
              f"shard: {tpa.launches.value}")
        whole = paged_attention_partial(q, kp, vp, base, length, kv_quant=fq,
                                        k_scale=ks, v_scale=vs)[0]
        plain = paged_attention_partial_ref(q, kp, vp, base, length,
                                            kv_quant=fq, k_scale=ks,
                                            v_scale=vs)[0]
        e1, e2 = close_err(got, whole, TOL[fmt]), close_err(got, plain,
                                                            TOL[fmt])
        errs["B1"] = max(errs["B1"], float((got - plain).abs().max()))
        print(f"X1 hold B1 {fmt}: sharded vs whole-pool kernel {e1:.3e}, vs "
              f"plain {e2:.3e} (tol {TOL[fmt]:.0e})")
        check(max(e1, e2) <= TOL[fmt], f"X1 hold B1 {fmt}: sharded decode "
              "disagrees")
        if fmt == "f32":
            times["B1_sharded_ms"] = statistics.median(time_ms(
                lambda: seqpar.paged_decode_attention_sharded(
                    q, kp, vp, base, length, mesh), 10, flush))
            times["B1_whole_ms"] = statistics.median(time_ms(
                lambda: paged_attention_partial(q, kp, vp, base, length),
                10, flush))
        Pt = B * NP
        q, kp, vp, table, base, length, ks, vs = make_shared_inputs(
            B, K, G, NP, T, dh, fmt, lengths, gen, Pt)
        tpa.launches_shared.reset()
        got = seqpar.paged_decode_attention_sharded_shared(
            q, kp, vp, table, base, length, mesh, kv_quant=fq, k_scale=ks,
            v_scale=vs)
        torch.cuda.synchronize()
        check(tpa.launches_shared.value == 8, "X1 hold: B2 not launched "
              f"once a shard: {tpa.launches_shared.value}")
        whole = paged_attention_partial(q, kp, vp, base, length, kv_quant=fq,
                                        k_scale=ks, v_scale=vs,
                                        page_table=table)[0]
        plain = paged_attention_shared_ref(q, kp, vp, table, base, length,
                                           kv_quant=fq, k_scale=ks,
                                           v_scale=vs)[0]
        e1, e2 = close_err(got, whole, TOL[fmt]), close_err(got, plain,
                                                            TOL[fmt])
        errs["B2"] = max(errs["B2"], float((got - plain).abs().max()))
        print(f"X1 hold B2 {fmt}: sharded vs whole-pool kernel {e1:.3e}, vs "
              f"plain {e2:.3e} (tol {TOL[fmt]:.0e})")
        check(max(e1, e2) <= TOL[fmt], f"X1 hold B2 {fmt}: sharded decode "
              "disagrees")
        if fmt == "f32":
            times["B2_sharded_ms"] = statistics.median(time_ms(
                lambda: seqpar.paged_decode_attention_sharded_shared(
                    q, kp, vp, table, base, length, mesh), 10, flush))
            times["B2_whole_ms"] = statistics.median(time_ms(
                lambda: paged_attention_partial(q, kp, vp, base, length,
                                                page_table=table),
                10, flush))
    print("X1 timing (device ms, median; the sharded call's 8 launches and "
          "its combine against one launch over the whole pool, f32): "
          + " ".join(f"{k}={v:.6f}" for k, v in times.items()))
    del flush
    return {"errs": errs, "times": times}


def mesh_train_phase() -> dict:
    """(c): full-width qwen1.5-0.5b on a (pod 2, data 2, model 2) mesh:
    the exact step (ring attention over `model`) against the same step
    without a mesh (B4), then two int8-compressed steps, the first held
    to the exact step with the reference's bounds."""
    import torch
    from repro_torch.bridge import tree_leaves, tree_map
    from repro_torch.configs import EngineConfig, get_config
    from repro_torch.models.registry import Model
    from repro_torch.models.transformer import Runtime
    from repro_torch.training.optimizer import AdamWConfig
    from repro_torch.training.train_step import (init_train_state,
                                                 make_compressed_train_step,
                                                 make_train_step)
    cfg = get_config("qwen1.5-0.5b")
    check(cfg.n_layers == 24 and cfg.d_model == 1024,
          "not the full-width qwen1.5-0.5b")
    mesh = card_mesh((2, 2, 2), ("pod", "data", "model"))
    rt, eng = Runtime(), EngineConfig()
    acfg = AdamWConfig(lr=1e-3, warmup_steps=0, total_steps=100,
                       min_lr_ratio=1.0)
    p0 = Model(cfg).init(torch.Generator(device="cuda").manual_seed(0))
    fresh = lambda: tree_map(lambda p: p.clone(), p0)          # noqa: E731
    b0 = train_batch(cfg, TRAIN_SEQ, TRAIN_BATCH, 0)
    b1 = train_batch(cfg, TRAIN_SEQ, TRAIN_BATCH, 1)
    t0 = time.perf_counter()
    mesh_reset()
    _, m_solo = make_train_step(cfg, rt, acfg, eng)(
        init_train_state(fresh(), acfg), b0)
    b4_solo = mesh_counts()["B4"]
    mesh_reset()
    with mesh:
        exact, m_ring = make_train_step(cfg, rt, acfg, eng)(
            init_train_state(fresh(), acfg), b0)
    cstep = make_compressed_train_step(cfg, rt, acfg, eng, mesh)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    comp, m_c1 = cstep(init_train_state(fresh(), acfg, compressed=True), b0)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    b4_mesh = mesh_counts()["B4"]
    scale = max(float(p.abs().max()) for p in tree_leaves(exact.params))
    param_gap = max(float((a - b).abs().max()) for a, b in zip(
        tree_leaves(exact.params), tree_leaves(comp.params))) / scale
    del exact
    comp, m_c2 = cstep(comp, b1)              # from each pod's residual
    torch.cuda.synchronize()
    ring_gap = abs(float(m_ring["loss"]) - float(m_solo["loss"])) / abs(
        float(m_solo["loss"]))
    norm_gap = abs(float(m_ring["grad_norm"]) - float(m_solo["grad_norm"])
                   ) / float(m_solo["grad_norm"])
    loss_gap = abs(float(m_ring["loss"]) - float(m_c1["loss"]))
    ef = [e.assemble() for e in tree_leaves(comp.ef)]
    pods_apart = any(not torch.equal(e[0], e[1]) for e in ef)
    res = {"ring_vs_B4_loss_rel": ring_gap,
           "ring_vs_B4_grad_norm_rel": norm_gap,
           "launches_B4_no_mesh": b4_solo, "launches_B4_mesh": b4_mesh,
           "loss_exact": float(m_ring["loss"]),
           "loss_compressed": float(m_c1["loss"]),
           "loss_compressed_step2": float(m_c2["loss"]),
           "loss_gap": loss_gap, "param_gap": param_gap,
           "exact_steps_s": t1 - t0, "compressed_step_s": t2 - t1,
           "pods_apart": pods_apart}
    print(f"X1 (c) qwen1.5-0.5b (pod 2, data 2, model 2), batch "
          f"{TRAIN_BATCH} x {TRAIN_SEQ}: exact step loss "
          f"{res['loss_exact']:.6f}, through B4 without a mesh "
          f"{float(m_solo['loss']):.6f} (rel {ring_gap:.3e}, tol "
          f"{MESH_RING_LOSS_TOL:.0e}; grad norm rel {norm_gap:.3e}, tol "
          f"{TRAIN_NORM_TOL:.0e}; B4 launches {b4_solo} without the mesh, "
          f"{b4_mesh} in the mesh's exact and compressed steps); "
          f"compressed {res['loss_compressed']:.6f}"
          f" (gap {loss_gap:.3e}, tol {MESH_TRAIN_LOSS_TOL:.0e}), max param "
          f"gap / max |param| {param_gap:.3e} (tol {MESH_TRAIN_PARAM_TOL}); "
          f"step 2 from each pod's residual {res['loss_compressed_step2']:.6f}"
          f"; the pods' residuals {'differ' if pods_apart else 'EQUAL'}; "
          f"walls: the two exact steps {t1 - t0:.2f} s, one compressed "
          f"step {t2 - t1:.2f} s")
    check(ring_gap <= MESH_RING_LOSS_TOL and norm_gap <= TRAIN_NORM_TOL,
          "X1 (c): the ring's step disagrees with B4's")
    # without a mesh every layer's attention is B4, again in the
    # rematerialized backward; on the mesh the ring replaces it
    check(b4_solo == 2 * cfg.n_layers and b4_mesh == 0,
          f"X1 (c): B4 launches {b4_solo} / {b4_mesh}, not "
          f"{2 * cfg.n_layers} / 0")
    check(loss_gap <= MESH_TRAIN_LOSS_TOL and param_gap
          <= MESH_TRAIN_PARAM_TOL, "X1 (c): the compressed step strays "
          "from the exact step")
    check(math.isfinite(res["loss_compressed_step2"]) and pods_apart,
          "X1 (c): the second compressed step")
    return res


def mesh_phases(rate) -> dict:
    """X1 (see the module docstring)."""
    import gc
    import numpy as np
    import torch
    from repro_torch.configs import EngineConfig
    from repro_torch.models.registry import Model
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    holds = mesh_kernel_holds(torch.Generator(device="cuda").manual_seed(26))
    cfg = llama3_cfg()
    t0 = time.perf_counter()
    params = Model(cfg).init(torch.Generator(device="cuda").manual_seed(0))
    torch.cuda.synchronize()
    n = sum(t.numel() for t in _leaves(params))
    print(f"X1: {cfg.name} at {cfg.n_layers} of 32 layers, {n / 1e9:.3f}B "
          f"params ({4 * n / 1e9:.1f} GB float32) in "
          f"{time.perf_counter() - t0:.2f} s; mesh {dict(zip(('data', 'model'), MESH_SHAPE))}"
          " of cuda:0 entries")
    toks = torch.from_numpy(np.random.default_rng(7).integers(
        0, cfg.vocab_size, (MESH_SLOTS, MESH_PROMPT))).cuda()
    base = dict(page_tokens=MESH_T, kv_dtype="float32")
    runs = {
        "f32": mesh_pair("(a) f32, one-shot prefill through the ring", cfg,
                         params, EngineConfig(**base), toks, MESH_F32_TOL),
        "kv8": mesh_pair("(a) kv8, one-shot prefill through the ring", cfg,
                         params, EngineConfig(**base, kv_quant="kv8"), toks,
                         MESH_KV8_TOL),
        "chunked": mesh_pair("(a) f32, prefill_chunk in 64-token chunks",
                             cfg, params, EngineConfig(**base), toks,
                             MESH_F32_TOL, chunked=True),
        "shared": mesh_pair("(b) shared pool, decode from an empty cache "
                            "over a permuted table", cfg, params,
                            EngineConfig(**base, shared_pool=True,
                                         uniform_lengths=False), toks,
                            MESH_F32_TOL, empty=True),
    }
    del params
    gc.collect()
    torch.cuda.empty_cache()
    peak_serve = torch.cuda.max_memory_allocated() / 1e9
    torch.cuda.reset_peak_memory_stats()
    train = mesh_train_phase()
    peak_train = torch.cuda.max_memory_allocated() / 1e9
    launches = {"B1": sum(runs[k]["launches"]["B1"]
                          for k in ("f32", "kv8", "chunked")),
                "B2": runs["shared"]["launches"]["B2"]}
    print(f"X1: launches on the main path B1 {launches['B1']}, B2 "
          f"{launches['B2']}; peak memory {peak_serve:.2f} GB ((a), (b)), "
          f"{peak_train:.2f} GB ((c)); on {smi_line()}")
    gc.collect()
    torch.cuda.empty_cache()
    return {"kernels": holds["errs"], "timing": holds["times"], **runs,
            "train": train, "launches": launches, "layers": cfg.n_layers,
            "peak_memory_gb": {"serve": peak_serve, "train": peak_train}}


# T1 / O1 / H1's depth in the default run (their weights' layers), cut from
# 24 to make room for X1 (PR 28); `--tier`, `--overlap` and `--http` run
# all 24.  Their gates compare schedules and pools on one set of weights
# ---------------------------------------------------------------------------
# phase 27: F1, the dry-run's count on the card
# ---------------------------------------------------------------------------

F1_ARCH = "qwen1.5-0.5b"
F1_STEPS = 5             # timed steps after one warm step
F1_SHARE_MAX = 1.05      # bound / time above this: the bound is wrong
# the card's peak against the meta count's (arguments + the storages the
# step holds at once): sound runs read 0.987x (decode) and 1.0014x
# (train), a port fault 0.667x; the slack is the caching allocator's
# rounding and cuBLAS's workspace (PERF.md §4)
F1_PEAK_BAND = (0.93, 1.07)
F1_PEAK_SLACK = 64 * 2**20
# the eager count's fused bytes over the function's bytes (its floor):
# 1.85 (decode) and 38.1 (train, the stacked layers' gradients) when the
# ceilings were set (PERF.md §4)
F1_BYTES_CEILING = {"decode": 2.3, "train": 48.0}


def f1_cells():
    """(label, shape, engine overrides, card runtime) of F1's two
    cells."""
    import dataclasses
    from repro_torch.configs import ShapeConfig, get_config
    from repro_torch.launch.steps import runtime_for
    cfg = get_config(F1_ARCH)
    return (("decode", ShapeConfig("serve_512", 512, 4, "decode"),
             {"page_tokens": 16}, None),
            ("train", ShapeConfig("train_256", 256, 8, "train"), None,
             dataclasses.replace(runtime_for(cfg, "train"),
                                 attn_impl="auto")))


def f1_predict(label, shape, overrides) -> dict:
    """The dry-run's numbers of one cell: its step run once on meta."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch import op_cost
    from repro_torch.launch import roofline as rl
    from repro_torch.launch.mesh import mesh_from_devices
    from repro_torch.launch.steps import build_cell, function_cost
    t0 = time.perf_counter()
    cell = build_cell(F1_ARCH, shape, mesh_from_devices(
        [torch.device("meta")]), multi_pod=False, eng_overrides=overrides)
    cost = op_cost.count(cell.jitted, *cell.abstract_args,
                         fusible_last2=cell.fusible_last2)
    mem = rl.memory_summary(cost, cell.argument_bytes)
    roof = rl.analyze(cost, 1, rl.model_flops_estimate(
        get_config(F1_ARCH), shape))
    bound = rl.function_bound(*function_cost(cell, cost))
    pred = {"flops": cost.flops, "bytes_fused": cost.bytes_accessed,
            "bytes_raw": cost.bytes_accessed + cost.fusible_bytes,
            "argument_bytes": mem["argument_bytes"],
            "peak_bytes": mem["total_bytes"], "temp_bytes":
            mem["temp_bytes"], "eager_compute_ms": roof.compute_s * 1e3,
            "eager_memory_ms": roof.memory_s * 1e3,
            "eager_memory_raw_ms": roof.memory_raw_s * 1e3,
            "function_flops": bound.flops, "function_bytes": bound.bytes,
            "bound_ms": bound.bound_s * 1e3, "bound_by": bound.bound_by,
            "compute_ms": bound.compute_s * 1e3,
            "memory_ms": bound.memory_s * 1e3,
            "count_s": time.perf_counter() - t0}
    ratio = cost.bytes_accessed / bound.bytes
    pred["bytes_over_function"] = ratio
    print(f"F1 {label}: predicted {pred['flops']:.6e} FLOP, "
          f"{pred['bytes_fused']:.6e} B fused ({pred['bytes_raw']:.6e} "
          f"raw), arguments {pred['argument_bytes']:.0f} B, peak "
          f"{pred['peak_bytes']:.6e} B; the eager program's terms: "
          f"compute {pred['eager_compute_ms']:.6f} ms, memory "
          f"{pred['eager_memory_ms']:.6f} (raw "
          f"{pred['eager_memory_raw_ms']:.6f}); the function: "
          f"{bound.flops:.6e} FLOP, {bound.bytes:.6e} B (the fused count "
          f"is {ratio:.4f}x), bound {pred['bound_ms']:.6f} ms set by "
          f"{pred['bound_by']} (operations {pred['compute_ms']:.6f}, bytes "
          f"{pred['memory_ms']:.6f}); counted in {pred['count_s']:.2f} s")
    check(1.0 <= ratio <= F1_BYTES_CEILING[label],
          f"F1 {label}: the count's fused bytes are {ratio:.4f}x the "
          f"function's, outside [1, {F1_BYTES_CEILING[label]}]")
    return pred


def f1_card(label, shape, overrides, rt, pred, card) -> dict:
    """The same cell on the card through the kernels, held to `pred`."""
    import torch
    from repro_torch.kernels import flash_attention, paged_attention, \
        quant_gemv, wkv6
    from repro_torch.launch import op_cost
    from repro_torch.launch.steps import build_cell
    from repro_torch.launch.mesh import mesh_from_devices
    cell = build_cell(F1_ARCH, shape, mesh_from_devices(
        [torch.device("cuda")]), multi_pod=False, eng_overrides=overrides,
        rt=rt)
    gen = torch.Generator(device="cuda").manual_seed(0)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()     # what earlier phases hold
    args = cell.args_on(torch.device("cuda"), gen)
    arg_bytes = sum(t.numel() * t.element_size()
                    for t in op_cost.tensor_leaves(args))
    check(arg_bytes == pred["argument_bytes"],
          f"F1 {label}: the card's arguments hold {arg_bytes} B, the "
          f"dry-run predicted {pred['argument_bytes']:.0f}")
    if cell.kind == "decode":
        args[1].lengths.fill_(shape.seq_len)      # a 512-token context
    counters = {"B1": paged_attention.launches,
                "B2": paged_attention.launches_shared,
                "B3": quant_gemv.launches, "B4": flash_attention.launches,
                "B5": wkv6.launches}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for c in counters.values():
        c.reset()
    step = cell.jitted
    if cell.kind == "train":
        state, batch = args

        def run():
            nonlocal state
            state, m = step(state, batch)
            return m
    else:
        def run():
            return step(*args)
    run()                                          # warm
    events = [(torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True))
              for _ in range(F1_STEPS)]
    for a, b in events:
        a.record()
        out = run()
        b.record()
    torch.cuda.synchronize()
    launches = {k: c.value for k, c in counters.items()}
    peak = torch.cuda.max_memory_allocated() - base
    times = [a.elapsed_time(b) for a, b in events]
    ms = statistics.median(times)
    share = pred["bound_ms"] / ms
    want = ({"B1": 24 * (F1_STEPS + 1)} if cell.kind == "decode"
            else {"B4": 48 * (F1_STEPS + 1)})
    lo = F1_PEAK_BAND[0] * pred["peak_bytes"] - F1_PEAK_SLACK
    hi = F1_PEAK_BAND[1] * pred["peak_bytes"] + F1_PEAK_SLACK
    res = {"argument_bytes": arg_bytes, "peak_bytes": peak,
           "base_bytes": base,
           "peak_band": [lo, hi], "step_ms": ms, "step_ms_all": times,
           "roofline_share": share, "launches": launches,
           "want_launches": want}
    print(f"F1 {label}: card arguments {arg_bytes} B (= predicted), peak "
          f"{peak} B ({peak / pred['peak_bytes']:.4f}x the count) in "
          f"[{lo:.0f}, {hi:.0f}], step {ms:.6f} ms median of {F1_STEPS} "
          f"(CUDA events), the function's bound {pred['bound_ms']:.6f} ms, "
          f"roofline share {share:.6f}; launches {launches}; {card}")
    check(lo <= peak <= hi, f"F1 {label}: peak {peak} B outside the "
          f"band [{lo:.0f}, {hi:.0f}] of the predicted "
          f"{pred['peak_bytes']:.0f}")
    check(share <= F1_SHARE_MAX, f"F1 {label}: roofline share "
          f"{share:.4f} > {F1_SHARE_MAX}: the bound is wrong")
    for k, n in want.items():
        check(launches[k] == n, f"F1 {label}: {k} launched "
              f"{launches[k]} times, want {n}")
    check(sum(launches.values()) == sum(want.values()),
          f"F1 {label}: other kernels launched: {launches}")
    check(all(bool(torch.isfinite(t).all()) for t in
              op_cost.tensor_leaves(out) if t.is_floating_point()),
          f"F1 {label}: the step's outputs are not finite")
    del args, out
    return res


def dryrun_phase(card: str) -> dict:
    """Phase 27, F1 (see the module docstring)."""
    import gc
    import torch
    t0 = time.perf_counter()
    res = {"launches": {"B1": 0, "B4": 0}}
    for label, shape, overrides, rt in f1_cells():
        pred = f1_predict(label, shape, overrides)
        got = f1_card(label, shape, overrides, rt, pred, card)
        res[label] = {"predicted": pred, "card": got}
        for k in ("B1", "B4"):
            res["launches"][k] += got["launches"][k]
        gc.collect()
        torch.cuda.empty_cache()
    res["wall_s"] = time.perf_counter() - t0
    print(f"F1: {res['wall_s']:.1f} s; {card}")
    return res


SERVING_LAYERS = 12


def serving_phases() -> dict:
    """Phases 17-19 on one set of full-width weights, SERVING_LAYERS
    deep."""
    import gc
    import torch
    params = build_server(layers=depth(SERVING_LAYERS, 24)).params
    res = {"T1": tier_phase(params), "O1": overlap_phase(params),
           "H1": http_phase(params)}
    del params
    gc.collect()        # the tiered servers' release hooks make cycles
    torch.cuda.empty_cache()
    return res


def dse_phases(rate, replicas=False) -> dict:
    """Phases 13-15, in the order `--dse` runs them; with `replicas`,
    phase 20 (M1) after them on D1's weights, before they are freed."""
    head = head_range_phase()
    group_rows = group_timing_phase(rate)
    d1, params, prompts, d1_outs = dse_server_phase()
    v1 = spec_server_phase(params, prompts, d1_outs)
    res = {"head_range": head, "group_timing": group_rows, "D1": d1,
           "V1": v1}
    if replicas:
        res["M1"] = replica_phase(params)
    return res


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
                     ["--window"], ["--tier"], ["--overlap"], ["--http"],
                     ["--replicas"], ["--hybrid"], ["--moe"], ["--vlm"],
                     ["--audio"], ["--train"], ["--mesh"], ["--dryrun"])
            and not (len(argv) == 2
                     and argv[0] in ("--gemv-ab", "--flash-ab", "--wkv-ab"))):
        print(__doc__, file=sys.stderr)
        return 2
    quant_only = argv == ["--quant-servers"]
    global FULL_DEPTH
    FULL_DEPTH = argv in (["--dse"], ["--window"], ["--replicas"],
                          ["--hybrid"], ["--moe"], ["--vlm"], ["--train"],
                          ["--quant-servers"], ["--mesh"])
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

    def lap(done: str):
        """The wall since the build started, after each stage of the run
        (the script must finish well inside its time limit)."""
        print(f"clock: {done} done at {time.perf_counter() - t0:.1f} s")
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
    if argv == ["--replicas"]:
        params = build_llama2_server().params
        m1 = replica_phase(params)
        print(card)
        print(json.dumps({"replicas": m1}))
        return 0
    if argv == ["--window"]:
        g1 = window_phases()
        print(card)
        print(json.dumps({"window": g1}))
        return 0
    if argv == ["--hybrid"]:
        y1 = hybrid_phases(rate)
        print(card)
        print(json.dumps({"hybrid": y1}))
        return 0
    if argv == ["--moe"]:
        e1 = moe_phases(rate)
        print(card)
        print(json.dumps({"moe": e1}))
        return 0
    if argv == ["--vlm"]:
        p1 = vlm_phases(rate)
        print(card)
        print(json.dumps({"vlm": p1}))
        return 0
    if argv == ["--audio"]:
        w1 = audio_phases(rate)
        print(card)
        print(json.dumps({"audio": w1}))
        return 0
    if argv == ["--train"]:
        l1 = train_phases(rate)
        print(card)
        print(json.dumps({"train": l1}))
        return 0
    if argv == ["--mesh"]:
        x1 = mesh_phases(rate)
        print(card)
        print(json.dumps({"mesh": x1}))
        return 0
    if argv == ["--dryrun"]:
        f1 = dryrun_phase(card)
        print(card)
        print(json.dumps({"dryrun": f1}))
        return 0
    one = {"--tier": ("tier", tier_phase), "--overlap": ("overlap",
                                                         overlap_phase),
           "--http": ("http", http_phase)}.get(argv[0] if argv else None)
    if one is not None:
        out = one[1]()
        print(card)
        print(json.dumps({one[0]: out}))
        return 0

    if not quant_only:
        b1_err = kernel_phase()
        b2_err = shared_kernel_phase()
        split_err = split_phase()
        b1_err = max(b1_err, split_err["B1"])
        b2_err = max(b2_err, split_err["B2"])
        b1_shapes, b2_shapes = timing_phase(rate)
        lap("phases 2-3 (B1/B2)")
        stripe = server_phase()
        shared = shared_server_phase("bfloat16")
        shared32 = shared_server_phase("float32")
        same = sum(x == y for x, y in zip(shared["token_ids"],
                                          shared32["token_ids"]))
        print(f"server (shared): {same} of 6 requests served the same "
              "tokens from the bf16 and the f32 pool")
        for r in (shared, shared32):
            del r["token_ids"]
        lap("phases 4-6 (servers)")
        b3_err = quant_kernel_phase()
        b3_shapes, b3_crossover = quant_timing_phase(rate)
        b4_err = flash_kernel_phase()
        b4_shapes = flash_timing_phase(rate)
        s1 = splice_server_phase()
        lap("phases 7, 9-10 (B3, B4, S1)")
        b5_err = wkv_kernel_phase()
        b5_shapes = wkv_timing_phase(rate)
        r1 = rwkv_server_phase()
        lap("phases 11-12 (B5, R1)")
        tier_served = serving_phases()
        lap("phases 17-19 (T1, O1, H1)")
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
    lap("phase 8 (Q1, Q2)")
    dse = dse_phases(rate, replicas=True)
    lap("phases 13-15, 20 (D1, V1, M1)")
    d1, v1, head, m1 = dse["D1"], dse["V1"], dse["head_range"], dse["M1"]
    b1_err = max(b1_err, head["B1"])
    b2_err = max(b2_err, head["B2"])
    g1 = window_phases()
    b1_err = max(b1_err, g1["kernels"]["B1"])
    b2_err = max(b2_err, g1["kernels"]["B2"])
    b4_err = max(b4_err, g1["kernels"]["B4"])
    g1_b1 = sum(g1[k]["launches"] for k in ("stripe", "splice", "discrete",
                                            "speculative"))
    g1_b1 += g1["golden"]["launches_B1"]
    lap("phase 16 (G1)")
    y1 = hybrid_phases(rate)
    lap("phase 21 (Y1)")
    for k in ("B1", "B2", "B3", "B4"):
        check(y1["launches"][k] > 0, f"Y1 launched {k} no time")
    b1_err = max(b1_err, y1["kernels"]["B1"])
    b2_err = max(b2_err, y1["kernels"]["B2"])
    b3_err = max(b3_err, y1["kernels"]["B3"])
    b4_err = max(b4_err, y1["kernels"]["B4"])
    y1_runs = {k: y1[k] for k in ("stripe", "shared", "splice", "discrete",
                                  "kv8", "overlap", "replicas", "dse")}
    e1 = moe_phases(rate)
    lap("phase 22 (E1)")
    for k in ("B1", "B2", "B3", "B4"):
        check(e1["launches"][k] > 0, f"E1 launched {k} no time")
    b1_err = max(b1_err, e1["kernels"]["B1"])
    b2_err = max(b2_err, e1["kernels"]["B2"])
    b3_err = max(b3_err, e1["kernels"]["B3"])
    b4_err = max(b4_err, e1["kernels"]["B4"])
    e1_runs = {k: e1[k] for k in ("stripe", "shared", "overlap", "discrete",
                                  "kv8", "kv8_shared", "stripe_nodrop",
                                  "splice_nodrop", "spec_nodrop",
                                  "stripe_float_wo", "discrete_float_wo",
                                  "replicas", "golden", "moe_layer")}
    p1 = vlm_phases(rate)
    lap("phase 23 (P1)")
    for k in ("B1", "B2", "B3", "B4"):
        check(p1["launches"][k] > 0, f"P1 launched {k} no time")
    w1 = audio_phases(rate)
    lap("phase 24 (W1)")
    for k in ("B1", "B4"):
        check(w1["launches"][k] > 0, f"W1 launched {k} no time")
    l1 = train_phases(rate)
    lap("L1 (training)")
    check(l1["launches_B4"] > 0, "L1 launched B4 no time")
    x1 = mesh_phases(rate)
    lap("phase 26 (X1)")
    for k in ("B1", "B2"):
        check(x1["launches"][k] > 0, f"X1 launched {k} no time")
    f1 = dryrun_phase(card)
    lap("phase 27 (F1)")
    for k in ("B1", "B4"):
        check(f1["launches"][k] > 0, f"F1 launched {k} no time")
    b1_err = max(b1_err, x1["kernels"]["B1"])
    b2_err = max(b2_err, x1["kernels"]["B2"])
    b1_err = max(b1_err, p1["kernels"]["B1"], w1["kernels"]["B1"])
    b2_err = max(b2_err, p1["kernels"]["B2"], w1["kernels"]["B2"])
    b3_err = max(b3_err, p1["kernels"]["B3"])
    b4_err = max(b4_err, p1["kernels"]["B4"], w1["kernels"]["B4"])
    p1_runs = {k: p1[k] for k in ("stripe", "shared", "splice", "discrete",
                                  "golden", "dse")}
    t1, o1, h1 = (tier_served[k] for k in ("T1", "O1", "H1"))
    kernels = [
        kernel_entry("paged_attention", "src/repro_torch/csrc/"
                     "paged_attention.cu",
                     "src/repro/kernels/paged_attention/kernel.py:311",
                     stripe["launches"] + d1["launches_B1"]
                     + v1["launches_B1"] + g1_b1 + o1["launches_B1"]
                     + y1["launches"]["B1"] + e1["launches"]["B1"]
                     + p1["launches"]["B1"] + w1["launches"]["B1"]
                     + x1["launches"]["B1"] + f1["launches"]["B1"], b1_err,
                     list(b1_shapes) + dse["group_timing"][:1]
                     + y1["timing"]["B1"] + e1["timing"]["B1"]
                     + p1["timing"]["B1"] + w1["timing"]["B1"],
                     [stripe, {"D1": d1, "V1": v1, "G1": g1, "O1": o1,
                               "Y1": y1_runs, "E1": e1_runs, "P1": p1_runs,
                               "W1": w1["golden"], "X1": x1,
                               "F1": f1["decode"]}]),
        kernel_entry("paged_attention_shared", "src/repro_torch/csrc/"
                     "paged_attention_shared.cu",
                     "src/repro/kernels/paged_attention/kernel.py:209",
                     shared["launches"] + d1["shared_launches_B2"]
                     + g1["shared"]["launches"] + t1["launches_B2"]
                     + o1["launches_B2"] + h1["launches_B2"]
                     + m1["launches_B2"] + y1["launches"]["B2"]
                     + e1["launches"]["B2"] + p1["launches"]["B2"]
                     + x1["launches"]["B2"], b2_err,
                     list(b2_shapes) + dse["group_timing"][1:]
                     + y1["timing"]["B2"] + e1["timing"]["B2"]
                     + p1["timing"]["B2"],
                     [shared, shared32, {"D1 shared": d1,
                                         "G1 shared": g1["shared"],
                                         "T1": t1, "H1": h1, "M1": m1,
                                         "Y1 shared": y1["shared"],
                                         "Y1 shared kv8": y1["kv8_shared"],
                                         "Y1 replicas": y1["replicas"],
                                         "E1 shared": e1["shared"],
                                         "E1 shared kv8": e1["kv8_shared"],
                                         "E1 replicas": e1["replicas"],
                                         "P1 shared": p1["shared"],
                                         "X1 shared": x1["shared"]}]),
        kernel_entry("quant_gemv", "src/repro_torch/csrc/quant_gemv.cu",
                     "src/repro/kernels/quant_gemv/kernel.py:68",
                     q1["launches"] + q2["launches"] + y1["launches"]["B3"]
                     + e1["launches"]["B3"] + p1["launches"]["B3"], b3_err,
                     list(b3_shapes) + y1["timing"]["B3"]
                     + e1["timing"]["B3"] + p1["timing"]["B3"],
                     [q1, q2, {"Y1 DSE pick": y1["dse"], "E1": e1_runs,
                               "P1 DSE pick": p1["dse"]}]) | {
            "design": "tensor-core mma.sync (bf16 / s8) with the weights "
                      "dequantized into the A operand; stream path (M <= "
                      "STREAM_MAX_M, 8 or 16 rows a CTA) and tile path (64 "
                      "rows) over a 4-stage cp.async ring; ordered split-D "
                      "sum", "crossover": b3_crossover},
        kernel_entry("flash_attention",
                     "src/repro_torch/csrc/flash_attention.cu",
                     "src/repro/kernels/flash_attention/kernel.py:82",
                     s1["launches"] + g1["splice"]["launches_B4"]
                     + y1["launches"]["B4"] + e1["launches"]["B4"]
                     + p1["launches"]["B4"] + w1["launches"]["B4"]
                     + l1["launches_B4"] + f1["launches"]["B4"], b4_err,
                     list(b4_shapes) + y1["timing"]["B4"]
                     + e1["timing"]["B4"] + p1["timing"]["B4"]
                     + w1["timing"]["B4"] + l1["timing"],
                     [s1, {"G1 splice": g1["splice"],
                           "Y1 splice": y1["splice"],
                           "E1 splice": e1["splice_nodrop"],
                           "P1 splice": p1["splice"],
                           "W1": w1["golden"], "L1": l1,
                           "F1": f1["train"]}]) | {
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
