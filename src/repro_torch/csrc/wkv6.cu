// RWKV6 wkv recurrence for Hopper (sm_90a), kernel B5, with a plain C entry
// point bound by ctypes.
//
// Replaces the TPU kernel `wkv6_pallas` (src/repro/kernels/wkv6/kernel.py,
// body `_kernel`).  It computes the function of the token-by-token
// recurrence (`wkv_recurrent`), per (batch row b, head h), from the state
// S_0 = s0[b, h]:
//
//     out_t = r_t · (S_{t-1} + u ⊙ k_t v_tᵀ)
//     S_t   = diag(e^{logw_t}) S_{t-1} + k_t v_tᵀ        (S is [dh_k, dh_v])
//
// and writes the state after the last token to sT.  Per chunk c of T <= 32
// tokens, with cum the inclusive cumulative log-decay inside the chunk,
// ce = cum - logw the exclusive one and tot the chunk's total:
//
//     out_c   = intra_c + rs_c S_c       rs_c = r e^{ce}
//     intra_c = (A ⊙ tril) v + diag(r·u·k) v,  A[t, s] = Σ_i r_t k_s e^{ce_t - cum_s}
//     S_{c+1} = diag(e^{tot_c}) S_c + dS_c,     dS_c = (k e^{tot - cum})ᵀ v
//
// intra_c, rs_c, dS_c and tot_c depend on chunk c's own inputs only.  So
// the TPU kernel's sequential grid axis (one core walking the chunks with
// the state in VMEM) becomes a local pass over every chunk at once and a
// short carry:
//   * the local pass, one CTA per (b, h, chunk): it writes intra_c into out
//     and rs_c, dS_c and e^{tot_c} into scratch.  A prompt of one chunk
//     (S <= T) is done here: the CTA folds s0 in itself (out += rs s0,
//     sT = e^{tot} s0 + dS), and no second launch is issued;
//   * the carry, one CTA per (b, h, block of kCarryCols = 16 value
//     columns), walking the chunks from s0 with its slice of the state in
//     registers: out_c += rs_c S_c (one product), then S <- e^{tot_c} ⊙ S +
//     dS_c.  The state's value columns are independent, so the columns
//     split over CTAs at no repeated cost (the state-independent work has
//     left the chain).  The loads of the next chunks (rs, dS, e^{tot} and
//     the intra rows of out) stream through a 4-stage cp.async ring, so no
//     step waits on memory; a step's time is its product's latency;
// All of it is deterministic: no atomics, every sum in a fixed order.
//
// Layouts (element strides, the head dim contiguous):
//   r, k, v, logw  [B, S, H, dh] float32, strides (x_b, x_s, x_h, 1)
//   u              [H, dh] float32, contiguous
//   s0, sT         [B, H, dh, dh] float32, contiguous
//   out            [B, S, H, dh] float32, contiguous
//   scratch (n = ceil(S / T) chunks, unused when n == 1):
//     rs [B, H, n, T, dh], dS [B, H, n, dh, dh], etot [B, H, n, dh]
// dh is 16, 32 or 64; the chunk T is 1..32; S is any length (the tail of
// the last chunk is masked here: rows past S read as zero, which is no
// decay and no value, so sT is the state after the last valid token).
//
// The factorization.  The TPU kernel (and the plain `wkv_chunked`) splits
// e^{ce_t - cum_s} into e^{ce_t} · e^{-cum_s}, and e^{-cum_s} overflows
// float32 once the chunk's summed decay passes ~88: at T = 32 that happens
// for |logw| above ~2.8, inside the model's range (-4.05, -0.05).  This
// kernel splits it around a per-channel pivot p = cum at row T/2 - 1:
// e^{ce_t - p} · e^{p - cum_s}.  Each factor then spans at most 16 tokens
// of decay, |exponent| <= 16 · 4.05 ≈ 65 < 88 over the model's whole range
// (finite for |logw| < 5.5), and the product is the same number.  Score
// tiles wholly above the diagonal are never formed; inside the diagonal
// tiles the pairs s >= t, whose product may overflow, are discarded by a
// select, so an inf there never reaches a result.  rs and e^{tot - cum}
// have exponents <= 0.  The decay is scanned in float64 and taken relative
// to the pivot before it is rounded, d = f32(cum - p): a float32 scan would
// carry ~eps·|cum| (|cum| up to 130) into every exponent, which the
// near-diagonal scores take as a relative error of up to ~1e-4 against the
// recurrence; rounded once, chip_smoke.py's sweep stays within 3e-5 at the
// drawn decays and 6e-5 at logw -0.05 (`wkv_chunk_parallel` in
// kernels/wkv6/ref.py is this arithmetic in plain torch).
//
// What bounds it on this card: the function moves 4·dh float32 inputs and
// dh outputs a token and head and costs 4·dh·(T + dh) FLOPs of the chunked
// form, ~30 FLOPs a byte, where float32 CUDA-core arithmetic (67 TFLOP/s)
// and HBM (3.35 TB/s) meet.  The split adds its intermediates: dS is
// dh²·4 bytes a chunk and head (16 KB at dh 64, 40% of the chunk's own
// r, k, v, logw and out), written once and read once, and rs and the
// intra rows of out once more each: 2.6x the function's bytes in all
// (chip_smoke.py prints them beside the bound).  The products (scores,
// A·v, dS, and rs·S in the carry) run on the tensor cores as 3xTF32
// (mma.sync m16n8k8, `mma3`), float32-exact; the exps (four a (token,
// channel)) on the CUDA cores.
//
// The local pass, 256 threads: cp.async stages r, k, logw and v (16-byte
// copies where every row is 16-byte aligned, else 4-byte ones); two
// threads a channel scan the decay in float64, outwards from the pivot;
// every thread forms the factors ra = r e^{ce - p}, kb = k e^{p - cum},
// rs = r e^{ce} and kl = k e^{tot - cum} of 8 channels of one row (all
// loads before any store, so they overlap) and its share of the diagonal
// r·u·k; warps form the lower score tiles (6 of 8 at T = 32), then the
// intra output (each m-tile's k-steps stop at the diagonal) and dS (k-steps
// stop at the last valid row).  Rows are padded so the fragment loads are
// bank-conflict-free.  The carry: two warps an 8-column n-tile, one a row
// m-tile, so a step is one m-tile's 8 k-steps of 3xTF32 in 4 chains.  Its
// width, 16 columns a CTA (160 CTAs at rwkv6-3b's B=1, H=40, dh=64), was
// the fastest of 8/16/32/64 at 8192 tokens on an H100 and within 1% of the
// fastest at 256 and 500 tokens (PERF.md §6).
// What it leaves on the table (PERF.md §6): every step of the carry and
// every phase of the local pass waits on its own latency (a step ~0.7 µs,
// a local CTA ~10 µs, few warps an SM), not on bytes or FLOPs.

#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_tf32.cuh"

namespace {

constexpr int kMaxT = 32;          // chunk tokens (the local pass's rows)
constexpr int kLocalThreads = 256;
constexpr int kLocalWarps = kLocalThreads / 32;
constexpr int kStages = 4;         // the carry's ring
constexpr int kLdSc = kMaxT + 4;   // score block row stride
constexpr unsigned kFull = 0xffffffffu;

struct Args {
  const float* r;
  const float* k;
  const float* v;
  const float* lw;
  const float* u;
  const float* s0;
  float* out;
  float* sT;
  float* rs;     // scratch [B, H, n, T, dh]
  float* ds;     // scratch [B, H, n, dh, dh]
  float* etot;   // scratch [B, H, n, dh]
  long long r_b, r_s, r_h, k_b, k_s, k_h, v_b, v_s, v_h, w_b, w_s, w_h;
  int S, H, T, n;
  bool vec16;    // every row of r/k/v/logw starts 16-byte aligned
};

// The local pass's shared memory (floats).  Row strides: LA = DH + 4 for
// the operands read along a row (A fragments, and B fragments of kbᵀ: g·LA +
// q spans 32 banks), LB = DH + 8 for those read down a column (kl as a
// transposed A, v as B: q·LB + g spans 32 banks).  The scores reuse w once
// the factors are formed; s0 (a lone chunk only) reuses ra and kb once the
// scores are (at row stride LA: its B-fragment reads conflict 2-way, on one
// CTA a head).  55 KB at dh 64: four CTAs an SM.
template <int DH>
struct Local {
  static constexpr int LA = DH + 4;
  static constexpr int LB = DH + 8;
  static constexpr int kWFloats = kMaxT * (LA > kLdSc ? LA : kLdSc);
  static constexpr int kRa = 0;                       // r, then ra
  static constexpr int kKb = kRa + kMaxT * LA;        // k, then kb
  static constexpr int kW = kKb + kMaxT * LA;         // logw, d, the scores
  static constexpr int kRs = kW + kWFloats;           // rs
  static constexpr int kKl = kRs + kMaxT * LA;        // kl
  static constexpr int kV = kKl + kMaxT * LB;         // v
  static constexpr int kDg = kV + kMaxT * LB;         // diagonal r·u·k [T]
  static constexpr int kU = kDg + kMaxT;              // u
  static constexpr int kP = kU + DH;                  // p (f32)
  static constexpr int kTp = kP + DH;                 // tot - p (f32)
  static constexpr int kEt = kTp + DH;                // e^{tot}
  static constexpr int kP64 = kEt + DH;               // p, tot - p (f64)
  static constexpr int kFloats = kP64 + 4 * DH;
  static constexpr int kS0 = kRa;                     // s0 [DH][LA]
  static_assert(DH <= 2 * kMaxT && kP64 % 2 == 0
                && kLocalThreads % kMaxT == 0, "layout");
};

// rows [0, kMaxT) of a [*, DH] float32 operand from global (row stride
// `stride` elements) into shared memory at `dst` (row stride LD floats);
// rows at or past `valid` are zero-filled by the copy's source size.  Each
// thread's share is a fixed, unrolled count of copies.
template <int DH, int LD, int THREADS>
__device__ __forceinline__ void stage_rows(float* dst, const float* src,
                                           long long stride, int valid,
                                           bool vec16) {
  if (vec16) {
    constexpr int kPer = DH / 4, kAll = kMaxT * kPer;
#pragma unroll
    for (int p = 0; p < (kAll + THREADS - 1) / THREADS; ++p) {
      const int e = threadIdx.x + p * THREADS;
      if (kAll % THREADS != 0 && e >= kAll) break;
      const int t = e / kPer, c = (e % kPer) * 4;
      const bool ok = t < valid;
      cp_async16(smem_u32(dst + t * LD + c), ok ? src + t * stride + c : src,
                 ok ? 16 : 0);
    }
  } else {
    constexpr int kAll = kMaxT * DH;
#pragma unroll
    for (int p = 0; p < (kAll + THREADS - 1) / THREADS; ++p) {
      const int e = threadIdx.x + p * THREADS;
      if (kAll % THREADS != 0 && e >= kAll) break;
      const int t = e / DH, c = e % DH;
      const bool ok = t < valid;
      cp_async4(smem_u32(dst + t * LD + c), ok ? src + t * stride + c : src,
                ok ? 4 : 0);
    }
  }
}

// A fragment (16 x 8) of a row-major operand at `m` (row stride LD)
template <int LD>
__device__ __forceinline__ void load_a(const float* m, int g, int q,
                                       uint32_t (&hi)[4], uint32_t (&lo)[4]) {
  split_tf32(m[g * LD + q], hi[0], lo[0]);
  split_tf32(m[(g + 8) * LD + q], hi[1], lo[1]);
  split_tf32(m[g * LD + q + 4], hi[2], lo[2]);
  split_tf32(m[(g + 8) * LD + q + 4], hi[3], lo[3]);
}

// A fragment of the transpose of a row-major operand: A[i][s] = m[s][i]
template <int LD>
__device__ __forceinline__ void load_at(const float* m, int g, int q,
                                        uint32_t (&hi)[4], uint32_t (&lo)[4]) {
  split_tf32(m[q * LD + g], hi[0], lo[0]);
  split_tf32(m[q * LD + g + 8], hi[1], lo[1]);
  split_tf32(m[(q + 4) * LD + g], hi[2], lo[2]);
  split_tf32(m[(q + 4) * LD + g + 8], hi[3], lo[3]);
}

template <int DH>
__global__ void __launch_bounds__(kLocalThreads) wkv6_local(Args a) {
  using L = Local<DH>;
  constexpr int LA = L::LA;
  constexpr int LB = L::LB;
  constexpr int KS = DH / 8;                 // k-steps over channels
  constexpr int kS0Regs = DH * DH / kLocalThreads;
  extern __shared__ __align__(16) float smem[];
  float* ra = smem + L::kRa;
  float* kb = smem + L::kKb;
  float* w = smem + L::kW;
  float* sc = smem + L::kW;
  float* rsm = smem + L::kRs;
  float* kl = smem + L::kKl;
  float* vv = smem + L::kV;
  float* diag = smem + L::kDg;
  float* su = smem + L::kU;
  float* sp = smem + L::kP;
  float* stp = smem + L::kTp;
  float* set = smem + L::kEt;
  double* p64 = reinterpret_cast<double*>(smem + L::kP64);
  double* tp64 = p64 + DH;

  const int c = blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int lane = tid % 32, warp = tid / 32;
  const int g = lane / 4, q = lane % 4;
  const int T = a.T;
  const int t0 = c * T;
  const int n = min(T, a.S - t0);            // valid rows of this chunk
  const int pivot = T / 2 - 1 > 0 ? T / 2 - 1 : 0;
  const long long bh = (long long)b * a.H + h;
  const bool vec16 = a.vec16;
  const bool fold = a.n == 1;                // a lone chunk folds s0 in

  stage_rows<DH, LA, kLocalThreads>(
      ra, a.r + b * a.r_b + t0 * a.r_s + h * a.r_h, a.r_s, n, vec16);
  stage_rows<DH, LA, kLocalThreads>(
      kb, a.k + b * a.k_b + t0 * a.k_s + h * a.k_h, a.k_s, n, vec16);
  stage_rows<DH, LA, kLocalThreads>(
      w, a.lw + b * a.w_b + t0 * a.w_s + h * a.w_h, a.w_s, n, vec16);
  stage_rows<DH, LB, kLocalThreads>(
      vv, a.v + b * a.v_b + t0 * a.v_s + h * a.v_h, a.v_s, n, vec16);
  cp_async_commit();
  for (int i = tid; i < DH; i += kLocalThreads) su[i] = a.u[h * DH + i];
  // a lone chunk folds s0 in: its loads go out now, beside the staging
  const float* s0 = a.s0 + bh * DH * DH;
  float s0r[kS0Regs];
  if (fold) {
#pragma unroll
    for (int e = 0; e < kS0Regs; ++e) s0r[e] = s0[tid + kLocalThreads * e];
  }
  cp_async_wait<0>();
  __syncthreads();

  // the decay in float64, two threads a channel: d_t = f32(cum_t - p) in
  // place of logw, as suffix sums down to row 0 from the pivot (p itself is
  // the last) and prefix sums up from the row after it (tot - p the last);
  // rows past n add nothing
  if (tid < 2 * DH) {
    const int i = tid % DH;
    double acc = 0.0;
    if (tid < DH) {
#pragma unroll 4
      for (int t = pivot; t >= 0; --t) {
        const float x = w[t * LA + i];
        w[t * LA + i] = static_cast<float>(-acc);
        acc += x;
      }
      p64[i] = acc;
      sp[i] = static_cast<float>(acc);
    } else {
#pragma unroll 4
      for (int t = pivot + 1; t < kMaxT; ++t) {
        acc += w[t * LA + i];
        w[t * LA + i] = static_cast<float>(acc);
      }
      tp64[i] = acc;
      stp[i] = static_cast<float>(acc);
    }
  }
  __syncthreads();

  // the factors: a thread takes one row and every kGrp-th channel, so its
  // share of the diagonal r·u·k sums in registers and over kGrp lanes; all
  // of its loads are issued before any store (the stores may alias them)
  {
    constexpr int kGrp = kLocalThreads / kMaxT;
    constexpr int kEl = DH / kGrp;
    const int t = tid / kGrp, grp = tid % kGrp;
    float d[kEl], de[kEl], rv[kEl], kv[kEl];
#pragma unroll
    for (int jj = 0; jj < kEl; ++jj) {
      const int i = kGrp * jj + grp;
      d[jj] = w[t * LA + i];
      de[jj] = t > 0 ? w[(t - 1) * LA + i] : -sp[i];          // ce - p
      rv[jj] = ra[t * LA + i];
      kv[jj] = kb[t * LA + i];
    }
    float dg = 0.f;
#pragma unroll
    for (int jj = 0; jj < kEl; ++jj) {
      const int i = kGrp * jj + grp;
      ra[t * LA + i] = rv[jj] * expf(de[jj]);
      kb[t * LA + i] = kv[jj] * expf(-d[jj]);
      kl[t * LB + i] = kv[jj] * expf(stp[i] - d[jj]);
      rsm[t * LA + i] = rv[jj] * expf(de[jj] + sp[i]);
      dg = fmaf(rv[jj] * su[i], kv[jj], dg);
    }
#pragma unroll
    for (int o = 1; o < kGrp; o <<= 1) dg += __shfl_xor_sync(kFull, dg, o);
    if (grp == 0) diag[t] = dg;
    for (int i = tid; i < DH; i += kLocalThreads)
      set[i] = expf(static_cast<float>(p64[i] + tp64[i]));
  }
  __syncthreads();
  if (!fold) {                    // rs to the carry's scratch, rows 0..T-1
    float* rs_g = a.rs + ((bh * a.n + c) * T) * DH;
    for (int e = tid; e < T * DH / 4; e += kLocalThreads) {
      const int t = e / (DH / 4), i = (e % (DH / 4)) * 4;
      *reinterpret_cast<float4*>(rs_g + t * DH + i) =
          *reinterpret_cast<const float4*>(rsm + t * LA + i);
    }
  }

  // score tiles (m-tile mt of rows, n-tile nt of keys) at or below the
  // diagonal: (0,0) (0,1) (1,0) (1,1) (1,2) (1,3); A[t][s] = ra_t · kb_s for
  // s < t, the diagonal r·u·k at s == t, 0 above
  const int MT = (T + 15) / 16;              // row m-tiles of the chunk
  const int NT = (T + 7) / 8;                // 8-row key groups
  for (int tile = warp; tile < 6; tile += kLocalWarps) {
    const int mt = tile < 2 ? 0 : 1;
    const int nt = tile < 2 ? tile : tile - 2;
    if (mt >= MT || nt >= NT) continue;
    float acc[2][4] = {};          // even and odd k-steps: two short chains
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      uint32_t ah[4], al[4], bh0, bh1, bl0, bl1;
      load_a<LA>(ra + 16 * mt * LA + 8 * ks, g, q, ah, al);
      const float* kr = kb + (8 * nt + g) * LA + 8 * ks;
      split_tf32(kr[q], bh0, bl0);
      split_tf32(kr[q + 4], bh1, bl1);
      mma3(acc[ks % 2], ah, al, bh0, bh1, bl0, bl1);
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int t = 16 * mt + g + (e / 2) * 8;
      const int s = 8 * nt + 2 * q + (e % 2);
      sc[t * kLdSc + s] = s < t ? acc[0][e] + acc[1][e]
                                : (s == t ? diag[t] : 0.f);
    }
  }
  __syncthreads();

  float* s0s = smem + L::kS0;
  if (fold) {                                // ra and kb are free now
#pragma unroll
    for (int e = 0; e < kS0Regs; ++e) {
      const int x = tid + kLocalThreads * e;
      s0s[(x / DH) * LA + x % DH] = s0r[e];
    }
    __syncthreads();
  }

  // intra: out[t][j] = Σ_s A[t][s] v[s][j] (k-steps up to the diagonal),
  // + Σ_i rs[t][i] s0[i][j] for a lone chunk; warp w takes value n-tiles
  // w, w + kLocalWarps; both row m-tiles at once, sharing the B fragments
  {
    constexpr int NTD = DH / 8;
    constexpr int kPerWarp = (NTD + kLocalWarps - 1) / kLocalWarps;
    float* og = a.out + (((long long)b * a.S + t0) * a.H + h) * DH;
    const long long o_s = (long long)a.H * DH;
    float acc[2][kPerWarp][4] = {};
    for (int ks = 0; ks < NT; ++ks) {
      uint32_t ah[2][4], al[2][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
        if (mt < MT && ks < 2 * mt + 2)
          load_a<kLdSc>(sc + 16 * mt * kLdSc + 8 * ks, g, q, ah[mt], al[mt]);
#pragma unroll
      for (int jn = 0; jn < kPerWarp; ++jn) {
        const int nt = warp + kLocalWarps * jn;
        if (nt >= NTD) continue;
        uint32_t bh0, bh1, bl0, bl1;
        split_tf32(vv[(8 * ks + q) * LB + 8 * nt + g], bh0, bl0);
        split_tf32(vv[(8 * ks + q + 4) * LB + 8 * nt + g], bh1, bl1);
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
          if (mt < MT && ks < 2 * mt + 2)
            mma3(acc[mt][jn], ah[mt], al[mt], bh0, bh1, bl0, bl1);
      }
    }
    if (fold) {
      float accf[2][kPerWarp][4] = {};
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
        uint32_t ah[2][4], al[2][4];
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
          if (mt < MT)
            load_a<LA>(rsm + 16 * mt * LA + 8 * ks, g, q, ah[mt], al[mt]);
#pragma unroll
        for (int jn = 0; jn < kPerWarp; ++jn) {
          const int nt = warp + kLocalWarps * jn;
          if (nt >= NTD) continue;
          uint32_t bh0, bh1, bl0, bl1;
          split_tf32(s0s[(8 * ks + q) * LA + 8 * nt + g], bh0, bl0);
          split_tf32(s0s[(8 * ks + q + 4) * LA + 8 * nt + g], bh1, bl1);
#pragma unroll
          for (int mt = 0; mt < 2; ++mt)
            if (mt < MT)
              mma3(accf[mt][jn], ah[mt], al[mt], bh0, bh1, bl0, bl1);
        }
      }
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int jn = 0; jn < kPerWarp; ++jn)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[mt][jn][e] += accf[mt][jn][e];
    }
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int jn = 0; jn < kPerWarp; ++jn) {
        const int nt = warp + kLocalWarps * jn;
        if (mt >= MT || nt >= NTD) continue;
        const int t = 16 * mt + g;
        const int j = 8 * nt + 2 * q;
        if (t < n)
          *reinterpret_cast<float2*>(og + t * o_s + j) =
              make_float2(acc[mt][jn][0], acc[mt][jn][1]);
        if (t + 8 < n)
          *reinterpret_cast<float2*>(og + (t + 8) * o_s + j) =
              make_float2(acc[mt][jn][2], acc[mt][jn][3]);
      }
  }

  // dS[i][j] = Σ_s kl[s][i] v[s][j] over the valid rows, + e^{tot_i}
  // s0[i][j] at chunk 0, into the chunk's slot (sT itself for a lone chunk)
  {
    constexpr int MTD = DH / 16, NTD = DH / 8;
    constexpr int kTiles = MTD * NTD;
    constexpr int kPerWarp = kTiles / kLocalWarps > 0 ? kTiles / kLocalWarps
                                                      : 1;
    float* dst = a.n == 1 ? a.sT + bh * DH * DH
                          : a.ds + (bh * a.n + c) * DH * DH;
    const int first = warp * kPerWarp;
    if (first < kTiles) {
      const int mi = first / NTD;            // a warp's tiles share mi
      float acc[kPerWarp][4];
#pragma unroll
      for (int jn = 0; jn < kPerWarp; ++jn)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[jn][e] = 0.f;
      const int ksn = (n + 7) / 8;
      for (int ks = 0; ks < ksn; ++ks) {
        uint32_t ah[4], al[4];
        load_at<LB>(kl + 8 * ks * LB + 16 * mi, g, q, ah, al);
#pragma unroll
        for (int jn = 0; jn < kPerWarp; ++jn) {
          const int nj = (first + jn) % NTD;
          uint32_t bh0, bh1, bl0, bl1;
          split_tf32(vv[(8 * ks + q) * LB + 8 * nj + g], bh0, bl0);
          split_tf32(vv[(8 * ks + q + 4) * LB + 8 * nj + g], bh1, bl1);
          mma3(acc[jn], ah, al, bh0, bh1, bl0, bl1);
        }
      }
#pragma unroll
      for (int jn = 0; jn < kPerWarp; ++jn) {
        const int nj = (first + jn) % NTD;
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const int i = 16 * mi + g + 8 * hf;
          const int j = 8 * nj + 2 * q;
          float x0 = acc[jn][2 * hf], x1 = acc[jn][2 * hf + 1];
          if (fold) {
            x0 = fmaf(set[i], s0s[i * LA + j], x0);
            x1 = fmaf(set[i], s0s[i * LA + j + 1], x1);
          }
          *reinterpret_cast<float2*>(dst + i * DH + j) = make_float2(x0, x1);
        }
      }
    }
  }
  if (!fold)
    for (int i = tid; i < DH; i += kLocalThreads)
      a.etot[(bh * a.n + c) * DH + i] = set[i];
}

// The carry's CTA: NT n-tiles of 8 value columns (JC = kCarryCols), two
// warps each, one a row m-tile of the chunk (rows 0-15, 16-31): a warp's
// step is one m-tile's product, and both warps of an n-tile keep the same
// state columns.  Its ring stage (floats): rs [kMaxT][LA], dS [DH][LC],
// e^{tot} [DH], the intra rows of out [kMaxT][LC].  LC = JC + 8 keeps
// q·LC + g, the B-fragment reads of dS, on 32 distinct banks.
constexpr int kCarryCols = 16;
template <int DH>
struct Carry {
  static constexpr int JC = kCarryCols;
  static constexpr int NT = JC / 8;
  static constexpr int kThreads = 64 * NT;
  static constexpr int LA = DH + 4;
  static constexpr int LC = JC + 8;
  static constexpr int kRs = 0;
  static constexpr int kDs = kRs + kMaxT * LA;
  static constexpr int kEt = kDs + DH * LC;
  static constexpr int kOt = kEt + DH;
  static constexpr int kStage = kOt + kMaxT * LC;
  static constexpr int kFloats = kStages * kStage;
};

// 16-byte copies of `all` pieces from global `src` + goff(e) into shared
// `dst` + soff(e), a fixed, unrolled count a thread; `ok(e)` false
// zero-fills the piece
template <int ALL, int THREADS, class Off, class Ok>
__device__ __forceinline__ void copy16(float* dst, const float* src, Off off,
                                       Ok ok) {
#pragma unroll
  for (int p = 0; p < (ALL + THREADS - 1) / THREADS; ++p) {
    const int e = threadIdx.x + p * THREADS;
    if (ALL % THREADS != 0 && e >= ALL) break;
    int so;
    long long go;
    off(e, so, go);
    const bool y = ok(e);
    cp_async16(smem_u32(dst + so), y ? src + go : src, y ? 16 : 0);
  }
}

// chunk c's rs, dS slice, e^{tot} and intra rows into ring stage `st`
template <int DH>
__device__ __forceinline__ void carry_issue(const Args& a, float* st, int c,
                                            long long bh, int b, int h,
                                            int col0) {
  using K = Carry<DH>;
  constexpr int kThreads = K::kThreads;
  constexpr int kQ = K::JC / 4;              // 16-byte pieces a row slice
  const int t0 = c * a.T;
  const int n = min(a.T, a.S - t0);
  const long long slot = bh * a.n + c;
  copy16<kMaxT * DH / 4, kThreads>(
      st + K::kRs, a.rs + slot * a.T * DH,
      [](int e, int& so, long long& go) {
        so = (e / (DH / 4)) * K::LA + (e % (DH / 4)) * 4;
        go = (e / (DH / 4)) * DH + (e % (DH / 4)) * 4;
      },
      [n](int e) { return e / (DH / 4) < n; });
  copy16<DH * kQ, kThreads>(
      st + K::kDs, a.ds + slot * DH * DH + col0,
      [](int e, int& so, long long& go) {
        so = (e / kQ) * K::LC + (e % kQ) * 4;
        go = (e / kQ) * DH + (e % kQ) * 4;
      },
      [](int) { return true; });
  copy16<DH / 4, kThreads>(
      st + K::kEt, a.etot + slot * DH,
      [](int e, int& so, long long& go) { so = 4 * e; go = 4 * e; },
      [](int) { return true; });
  const long long o_s = (long long)a.H * DH;
  copy16<kMaxT * kQ, kThreads>(
      st + K::kOt, a.out + (((long long)b * a.S + t0) * a.H + h) * DH + col0,
      [o_s](int e, int& so, long long& go) {
        so = (e / kQ) * K::LC + (e % kQ) * 4;
        go = (e / kQ) * o_s + (e % kQ) * 4;
      },
      [n](int e) { return e / kQ < n; });
}

template <int DH>
__global__ void __launch_bounds__(Carry<DH>::kThreads) wkv6_carry(Args a) {
  using K = Carry<DH>;
  constexpr int KS = DH / 8;
  constexpr int LA = K::LA;
  constexpr int LC = K::LC;
  extern __shared__ __align__(16) float smem[];
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int col0 = blockIdx.x * K::JC;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int nt = warp / 2, mt = warp % 2;    // value n-tile, row m-tile
  const int g = lane / 4, q = lane % 4;
  const int j = col0 + 8 * nt + g;           // this thread's state column
  const long long bh = (long long)b * a.H + h;
  const int n = a.n;
  const bool rows = 16 * mt < a.T;           // the chunk reaches this m-tile

  for (int s = 0; s < kStages - 1; ++s) {
    if (s < n) carry_issue<DH>(a, smem + s * K::kStage, s, bh, b, h, col0);
    cp_async_commit();
  }

  // the state's B fragments: st[ks][0] = S[8ks + q][j], st[ks][1] =
  // S[8ks + q + 4][j], from s0
  float st[KS][2];
  {
    const float* s0 = a.s0 + bh * DH * DH;
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      st[ks][0] = s0[(8 * ks + q) * DH + j];
      st[ks][1] = s0[(8 * ks + q + 4) * DH + j];
    }
  }

  for (int c = 0; c < n; ++c) {
    cp_async_wait<kStages - 2>();
    __syncthreads();              // chunk c landed; chunk c - 1's slot free
    {
      const int cn = c + kStages - 1;
      if (cn < n)
        carry_issue<DH>(a, smem + (cn % kStages) * K::kStage, cn, bh, b, h,
                        col0);
      cp_async_commit();
    }
    const float* stg = smem + (c % kStages) * K::kStage;
    const float* ds = stg + K::kDs;
    const float* et = stg + K::kEt;
    const int t0 = c * a.T;
    const int nv = min(a.T, a.S - t0);

    if (rows) {       // out rows of this m-tile += rs_c · S_c, from intra
      const float* rs = stg + K::kRs + 16 * mt * LA;
      const int t = 16 * mt + g;
      const float* orow = stg + K::kOt + t * LC + 8 * nt + 2 * q;
      constexpr int kChains = KS < 4 ? KS : 4;   // short mma chains
      float part[kChains][4] = {};
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
        uint32_t ah[4], al[4], bh0, bh1, bl0, bl1;
        load_a<LA>(rs + 8 * ks, g, q, ah, al);
        split_tf32(st[ks][0], bh0, bl0);
        split_tf32(st[ks][1], bh1, bl1);
        mma3(part[ks % kChains], ah, al, bh0, bh1, bl0, bl1);
      }
      float acc[4] = {orow[0], orow[1], orow[8 * LC], orow[8 * LC + 1]};
#pragma unroll
      for (int ch = 0; ch < kChains; ++ch)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[e] += part[ch][e];
      float* og = a.out + (((long long)b * a.S + t0 + t) * a.H + h) * DH +
                  col0 + 8 * nt + 2 * q;
      const long long o_s = (long long)a.H * DH;
      if (t < nv) *reinterpret_cast<float2*>(og) = make_float2(acc[0], acc[1]);
      if (t + 8 < nv)
        *reinterpret_cast<float2*>(og + 8 * o_s) = make_float2(acc[2], acc[3]);
    }
    // S_{c+1} = e^{tot_c} S_c + dS_c
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      const int i = 8 * ks + q;
      st[ks][0] = fmaf(et[i], st[ks][0], ds[i * LC + 8 * nt + g]);
      st[ks][1] = fmaf(et[i + 4], st[ks][1], ds[(i + 4) * LC + 8 * nt + g]);
    }
  }
  cp_async_wait<0>();

  if (mt == 0) {
    float* sT = a.sT + bh * DH * DH;
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      sT[(8 * ks + q) * DH + j] = st[ks][0];
      sT[(8 * ks + q + 4) * DH + j] = st[ks][1];
    }
  }
}

template <typename Kernel>
int set_smem(Kernel kernel, int bytes, bool& done) {
  if (done) return 0;
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  done = true;
  return 0;
}

template <int DH>
int launch(const Args& a, int B, cudaStream_t stream) {
  constexpr int bytes = Local<DH>::kFloats * (int)sizeof(float);
  static bool attr = false;       // one attribute call per instance
  if (const int e = set_smem(wkv6_local<DH>, bytes, attr)) return e;
  wkv6_local<DH><<<dim3(a.n, a.H, B), kLocalThreads, bytes, stream>>>(a);
  if (const cudaError_t e = cudaGetLastError()) return static_cast<int>(e);
  if (a.n == 1) return 0;         // a lone chunk wrote sT itself
  using K = Carry<DH>;
  constexpr int cbytes = K::kFloats * (int)sizeof(float);
  static bool cattr = false;
  if (const int e = set_smem(wkv6_carry<DH>, cbytes, cattr)) return e;
  wkv6_carry<DH><<<dim3(DH / K::JC, a.H, B), K::kThreads, cbytes, stream>>>(
      a);
  return static_cast<int>(cudaGetLastError());
}

// rows of [B, S, H, dh] at `p` with strides (x_b, x_s, x_h, 1) all start
// 16-byte aligned
bool rows_16b(const void* p, long long x_b, long long x_s, long long x_h) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0 && x_b % 4 == 0 &&
         x_s % 4 == 0 && x_h % 4 == 0;
}

}  // namespace

// See the layouts above.  rs, ds and etot are the scratch of n = ceil(S /
// chunk) chunks (unread when n <= 1).  Returns cudaGetLastError() after the
// launches (or an attribute call's error), or -1 for a head dim other than
// 16 / 32 / 64 or a chunk outside 1..32.
extern "C" int kvnand_wkv6(
    const void* r, const void* k, const void* v, const void* lw,
    const void* u, const void* s0, void* out, void* sT, void* rs, void* ds,
    void* etot, long long r_b, long long r_s, long long r_h, long long k_b,
    long long k_s, long long k_h, long long v_b, long long v_s, long long v_h,
    long long w_b, long long w_s, long long w_h, int B, int S, int H, int dh,
    int chunk, void* stream) {
  if (chunk < 1 || chunk > kMaxT) return -1;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (S == 0)                     // no token: the state passes through
    return static_cast<int>(cudaMemcpyAsync(
        sT, s0, sizeof(float) * (size_t)B * H * dh * dh,
        cudaMemcpyDeviceToDevice, st));
  const Args a{static_cast<const float*>(r),  static_cast<const float*>(k),
               static_cast<const float*>(v),  static_cast<const float*>(lw),
               static_cast<const float*>(u),  static_cast<const float*>(s0),
               static_cast<float*>(out),      static_cast<float*>(sT),
               static_cast<float*>(rs),       static_cast<float*>(ds),
               static_cast<float*>(etot),
               r_b, r_s, r_h, k_b, k_s, k_h, v_b, v_s, v_h, w_b, w_s, w_h,
               S, H, chunk, (S + chunk - 1) / chunk,
               rows_16b(r, r_b, r_s, r_h) && rows_16b(k, k_b, k_s, k_h) &&
                   rows_16b(v, v_b, v_s, v_h) && rows_16b(lw, w_b, w_s, w_h)};
  if (dh == 16) return launch<16>(a, B, st);
  if (dh == 32) return launch<32>(a, B, st);
  if (dh == 64) return launch<64>(a, B, st);
  return -1;
}
