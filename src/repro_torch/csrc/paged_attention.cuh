// Paged decode attention for Hopper (sm_90a): one kernel body, two page
// layouts.  Included by paged_attention.cu (the per-slot stripe layout) and
// paged_attention_shared.cu (the shared pool reached through page tables);
// each source is built into its own library by its own nvcc process.
//
// Replaces the TPU kernels `paged_attention_pallas` (stripe) and
// `paged_attention_pallas_shared` (shared pool) of
// src/repro/kernels/paged_attention/kernel.py (bodies `_kernel` /
// `_kernel_shared`, loaders `_load_pages` / `_load_page_shared`).  Both
// compute the same function: one query token per slot and kv head (a group
// of G query heads) against the slot's pages, online softmax in float32,
// kv8/kv4 dequant fused (the K scale multiplies the scores after the QK
// dot, the V scale multiplies p before the PV dot), validity derived from
// page_base / length / window, and locally normalized partials (o, m, l)
// per page-walk partition for the caller's LSE merge.  The two layouts
// differ only in where a token's bytes live, which is the `Walk` policy:
//
//   StripeWalk  k, v [B, K, NP, Ts, DH], scales [B, K, NP]: token tok of
//               the (b, k) walk is storage row tok of the (b, k) stripe.
//   TableWalk   k, v [K, P_total, Ts, DH], scales [K, P_total], table
//               [B, NP]: token tok sits on physical page
//               table[b, tok / T], storage row tok % T.
//
// (Ts = T, except kv4: Ts = T/2, token 2i in the high nibble and 2i+1 in
// the low nibble of one packed row, offset 8.)  Other layouts (contiguous):
//   q      [B, K, G, DH] float32 (unscaled)
//   base   [B, NP] int32: absolute position of each (logical) page's slot
//          0, < 0 = unwritten; length [B] int32
//   o      [B, K, P, G, DH] float32, m / l [B, K, P, G] float32
//
// What bounds it: decode attention does ~4 flops per KV byte (bf16), far
// below the card's ~295 flops/byte balance point, so it is bound by the KV
// bytes it streams from HBM.  The design therefore reads each valid token's
// K and V exactly once and skips whole 32-token tiles (and single tokens)
// that the page bases, length and window mark invalid: a masked token costs
// no K/V bytes, and in the shared layout a masked token's table entry is
// read (it lies inside the table) but never used as an address, so stale
// entries past `length` are harmless.  The grid is
// one CTA per (partition, kv head, slot); the walk over a partition's pages
// is a loop inside the CTA, since nothing carries across CTAs.  Eight warps
// split the partition's 32-token tiles; each warp keeps its own online
// softmax (QK with one lane per token, PV with one lane per head-dim slice,
// p broadcast by warp shuffles) and the warps merge by log-sum-exp through
// shared memory at the end.  A lane issues all of its K row's loads at
// once, and the PV step loads V rows in groups of 8-16 tokens before their
// FMAs, so a tile costs a few memory round trips.  The table walk reads
// each token's table entry in the QK step, issued beside its page base
// (both are needed before the K row's address is known, so the table adds
// no memory round trip of its own), and the lane owning a token leaves the
// token's row offset in shared memory for the PV step, where every lane
// reads it.  (Handing the offsets over by 64-bit warp shuffles instead cost
// 1.6-2.2x the stripe walk's time on an H100; staged in shared memory the
// table walk runs as fast as the stripe walk: see PERF.md.)
//
// What this simple design leaves on the table: no cp.async/TMA pipelining
// across tiles (memory latency is hidden only by the other warps and CTAs
// in flight), CUDA-core FMAs instead of wgmma, lane-per-token K rows
// (uncoalesced within a load instruction, whole sectors used across the
// warp), and too few CTAs to fill 132 SMs at small batch unless the walk is
// partitioned.
//
// Masking follows the reference exactly: NEG_INF is the finite -1e30, an
// all-masked partial comes out as o = 0, m = -1e30, l = 0 (never NaN), and
// the output divides by max(l, 1e-30).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace kvnand {

constexpr float kNegInf = -1e30f;
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr unsigned kFull = 0xffffffffu;

enum Fmt { kF32 = 0, kBF16 = 1, kKV8 = 2, kKV4 = 3 };

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(kFull, v, off));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(kFull, v, off);
  return v;
}

// Storage rows: one row of DH elements per token, except kv4 (one packed
// row per token pair).
template <int FMT>
__device__ __forceinline__ long storage_row(long tok) {
  return FMT == kKV4 ? (tok >> 1) : tok;
}

template <int FMT>
struct StorageBytes {
  static constexpr int value = FMT == kF32 ? 4 : (FMT == kBF16 ? 2 : 1);
};

template <int BYTES> struct Vec;
template <> struct Vec<1> { using T = uint8_t; };
template <> struct Vec<2> { using T = uint16_t; };
template <> struct Vec<4> { using T = uint32_t; };
template <> struct Vec<8> { using T = uint2; };
template <> struct Vec<16> { using T = uint4; };

// 8 consecutive dims [d0, d0 + 8) of the storage row that starts at
// element `row` of `pool`, as float codes (unscaled); `odd` picks the low
// nibble (kv4: the token is the second of its pair).
template <int FMT>
__device__ __forceinline__ void load8(const void* pool, long row, bool odd,
                                      int d0, float out[8]) {
  const long idx = row + d0;
  if (FMT == kF32) {
    const float4* p = reinterpret_cast<const float4*>(
        static_cast<const float*>(pool) + idx);
    const float4 a = p[0], b = p[1];
    out[0] = a.x; out[1] = a.y; out[2] = a.z; out[3] = a.w;
    out[4] = b.x; out[5] = b.y; out[6] = b.z; out[7] = b.w;
  } else if (FMT == kBF16) {
    const uint4 u = *reinterpret_cast<const uint4*>(
        static_cast<const __nv_bfloat16*>(pool) + idx);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float2 f = __bfloat1622float2(h[j]);
      out[2 * j] = f.x;
      out[2 * j + 1] = f.y;
    }
  } else {
    const uint2 u = *reinterpret_cast<const uint2*>(
        static_cast<const uint8_t*>(pool) + idx);
    const uint8_t* c = reinterpret_cast<const uint8_t*>(&u);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      if (FMT == kKV8) {
        out[j] = static_cast<float>(static_cast<int8_t>(c[j]));
      } else {
        const int nib = odd ? (c[j] & 0xF) : (c[j] >> 4);
        out[j] = static_cast<float>(nib - 8);
      }
    }
  }
}

// N (= 1, 2 or 4) consecutive dims [d0, d0 + N) of the storage row at
// element `row`, as float codes, in one aligned vector load.
template <int FMT, int N>
__device__ __forceinline__ void load_n(const void* pool, long row, bool odd,
                                       int d0, float out[N]) {
  constexpr int EB = StorageBytes<FMT>::value;
  using V = typename Vec<N * EB>::T;
  const long idx = row + d0;
  const V raw = *reinterpret_cast<const V*>(
      static_cast<const uint8_t*>(pool) + idx * EB);
  const uint8_t* c = reinterpret_cast<const uint8_t*>(&raw);
#pragma unroll
  for (int j = 0; j < N; ++j) {
    if (FMT == kF32) {
      out[j] = reinterpret_cast<const float*>(c)[j];
    } else if (FMT == kBF16) {
      out[j] = __bfloat162float(reinterpret_cast<const __nv_bfloat16*>(c)[j]);
    } else if (FMT == kKV8) {
      out[j] = static_cast<float>(static_cast<int8_t>(c[j]));
    } else {
      const int nib = odd ? (c[j] & 0xF) : (c[j] >> 4);
      out[j] = static_cast<float>(nib - 8);
    }
  }
}

// ---- page-address policies ------------------------------------------------
// entry(): what the walk reads per page beside the page base (the table
// entry; nothing for a stripe); locate(): element offset of a VALID token's
// storage row and its page's scale index.  kStaged: the PV step reads the
// rows that the QK step's lanes located from shared memory; otherwise every
// lane computes a token's row itself with row_of().

template <int FMT, int DH>
struct StripeWalk {
  long row0, scale0;
  __device__ StripeWalk(const int* /*table*/, int b, int k, int K, int NP,
                        int Ts, long /*P_total*/)
      : row0((static_cast<long>(b) * K + k) * NP * Ts * DH),
        scale0((static_cast<long>(b) * K + k) * NP) {}
  __device__ __forceinline__ int entry(int /*page*/) const { return 0; }
  __device__ __forceinline__ void locate(long tok, int page, int /*entry*/,
                                         int /*T*/, long& row,
                                         long& sidx) const {
    row = row0 + storage_row<FMT>(tok) * DH;
    sidx = scale0 + page;
  }
  __device__ __forceinline__ long row_of(long tok) const {
    return row0 + storage_row<FMT>(tok) * DH;
  }
  static constexpr bool kStaged = false;
};

template <int FMT, int DH>
struct TableWalk {
  const int* table_b;
  long k0;
  int Ts;
  __device__ TableWalk(const int* table, int b, int k, int /*K*/, int NP,
                       int Ts_, long P_total)
      : table_b(table + static_cast<long>(b) * NP),
        k0(static_cast<long>(k) * P_total), Ts(Ts_) {}
  __device__ __forceinline__ int entry(int page) const {
    return table_b[page];
  }
  __device__ __forceinline__ void locate(long tok, int page, int entry,
                                         int T, long& row, long& sidx) const {
    const long phys = k0 + entry;
    row = (phys * Ts + storage_row<FMT>(tok - static_cast<long>(page) * T))
          * DH;
    sidx = phys;
  }
  static constexpr bool kStaged = true;
};

// One CTA per (partition p, kv head k, slot b).  GM >= G is the compile-time
// bound on the query group; rows g >= G are never touched.
template <int FMT, int DH, int GM, class Walk>
__global__ void __launch_bounds__(kThreads)
paged_attention_kernel(const float* __restrict__ q,
                       const void* __restrict__ kp,
                       const void* __restrict__ vp,
                       const float* __restrict__ ks,
                       const float* __restrict__ vs,
                       const int* __restrict__ table,
                       const int* __restrict__ base,
                       const int* __restrict__ length,
                       float* __restrict__ o_out,
                       float* __restrict__ m_out,
                       float* __restrict__ l_out,
                       int K, int NP, int T, int G, int P, long P_total,
                       int window, float scale) {
  constexpr int DPL = DH / 32;            // head dims owned per lane in PV
  constexpr int kVGroup = DH <= 64 ? 16 : 8;  // V rows loaded per batch
  constexpr bool kQuant = FMT == kKV8 || FMT == kKV4;
  __shared__ float q_s[GM][DH];
  __shared__ float m_s[kWarps][GM];
  __shared__ float l_s[kWarps][GM];
  __shared__ float acc_s[kWarps][GM][DH];
  __shared__ long row_s[kWarps][32];      // staged rows (Walk::kStaged)

  const int p = blockIdx.x, k = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long bk = static_cast<long>(b) * K + k;
  const int npp = NP / P;

  for (int i = threadIdx.x; i < G * DH; i += kThreads)
    q_s[i / DH][i % DH] = q[bk * G * DH + i] * scale;
  __syncthreads();

  const int Ts = FMT == kKV4 ? T / 2 : T;
  const Walk walk(table, b, k, K, NP, Ts, P_total);
  const int* base_b = base + static_cast<long>(b) * NP;
  const int len = length[b];
  const int tok0 = p * npp * T;           // first walk token of partition
  const int ntok = npp * T;

  float m_w[GM], l_w[GM], acc[GM][DPL];
#pragma unroll
  for (int g = 0; g < GM; ++g) {
    m_w[g] = kNegInf;
    l_w[g] = 0.f;
#pragma unroll
    for (int j = 0; j < DPL; ++j) acc[g][j] = 0.f;
  }

  for (int t0 = warp * 32; t0 < ntok; t0 += kWarps * 32) {
    // ---- QK: one lane per token ------------------------------------
    const int tl = t0 + lane;
    const long tok = static_cast<long>(tok0) + tl;
    const int page = static_cast<int>(tok / T);
    const int pb = tl < ntok ? base_b[page] : -1;
    const int entry = tl < ntok ? walk.entry(page) : 0;
    const int pos = pb + static_cast<int>(tok - static_cast<long>(page) * T);
    bool valid = tl < ntok && pb >= 0 && pos < len;
    if (window >= 0) valid = valid && pos > len - 1 - window;
    const unsigned vmask = __ballot_sync(kFull, valid);
    if (vmask == 0u) continue;            // whole tile masked: no bytes read

    long row = 0, sidx = 0;
    if (valid) walk.locate(tok, page, entry, T, row, sidx);
    if constexpr (Walk::kStaged) {
      __syncwarp();                       // the last tile's rows read
      row_s[warp][lane] = row;
      __syncwarp();
    }
    const bool odd = tok & 1;
    float s[GM];
#pragma unroll
    for (int g = 0; g < GM; ++g) s[g] = 0.f;
    if (valid) {
#pragma unroll
      for (int d0 = 0; d0 < DH; d0 += 8) {
        float kv[8];
        load8<FMT>(kp, row, odd, d0, kv);
#pragma unroll
        for (int g = 0; g < GM; ++g) {
          if (g < G) {
#pragma unroll
            for (int j = 0; j < 8; ++j) s[g] = fmaf(q_s[g][d0 + j], kv[j], s[g]);
          }
        }
      }
      if (kQuant) {
        const float kscale = ks[sidx];
#pragma unroll
        for (int g = 0; g < GM; ++g) s[g] *= kscale;
      }
    } else {
#pragma unroll
      for (int g = 0; g < GM; ++g) s[g] = kNegInf;
    }

    // ---- online softmax over the tile, per query row -------------------
    const float vscale = (kQuant && valid) ? vs[sidx] : 1.f;
    float pv[GM];
#pragma unroll
    for (int g = 0; g < GM; ++g) {
      if (g < G) {
        const float m_new = fmaxf(m_w[g], warp_max(s[g]));
        const float pg = valid ? expf(s[g] - m_new) : 0.f;
        const float alpha = expf(m_w[g] - m_new);
        l_w[g] = l_w[g] * alpha + warp_sum(pg);
#pragma unroll
        for (int j = 0; j < DPL; ++j) acc[g][j] *= alpha;
        m_w[g] = m_new;
        pv[g] = pg * vscale;
      } else {
        pv[g] = 0.f;
      }
    }

    // ---- PV: one lane per DPL head dims, p broadcast by shuffle --------
    // V rows are read in groups of kVGroup tokens, all loads of a group
    // issued before its FMAs, so a tile costs a few memory round trips
    // rather than one per token
#pragma unroll
    for (int tg = 0; tg < 32; tg += kVGroup) {
      const unsigned gmask = (vmask >> tg) & ((1u << kVGroup) - 1u);
      if (gmask == 0u) continue;          // warp-uniform
      // every token's row first, then the loads
      long vrow[kVGroup];
#pragma unroll
      for (int t = 0; t < kVGroup; ++t) {
        if constexpr (Walk::kStaged)
          vrow[t] = row_s[warp][tg + t];
        else
          vrow[t] = walk.row_of(static_cast<long>(tok0) + t0 + tg + t);
      }
      float vv[kVGroup][DPL];
#pragma unroll
      for (int t = 0; t < kVGroup; ++t) {
        if ((gmask >> t) & 1u) {          // warp-uniform
          load_n<FMT, DPL>(vp, vrow[t], (tok0 + t0 + tg + t) & 1,
                           lane * DPL, vv[t]);
        } else {
#pragma unroll
          for (int j = 0; j < DPL; ++j) vv[t][j] = 0.f;
        }
      }
#pragma unroll
      for (int t = 0; t < kVGroup; ++t) {
#pragma unroll
        for (int g = 0; g < GM; ++g) {
          if (g < G) {
            const float w = __shfl_sync(kFull, pv[g], tg + t);
#pragma unroll
            for (int j = 0; j < DPL; ++j)
              acc[g][j] = fmaf(w, vv[t][j], acc[g][j]);
          }
        }
      }
    }
  }

  // ---- merge the warps' partials (log-sum-exp) --------------------------
#pragma unroll
  for (int g = 0; g < GM; ++g) {
    if (g < G) {
      if (lane == 0) {
        m_s[warp][g] = m_w[g];
        l_s[warp][g] = l_w[g];
      }
#pragma unroll
      for (int j = 0; j < DPL; ++j) acc_s[warp][g][lane * DPL + j] = acc[g][j];
    }
  }
  __syncthreads();

  const long out_row = (bk * P + p) * G;
  for (int i = threadIdx.x; i < G * DH; i += kThreads) {
    const int g = i / DH, d = i % DH;
    float M = kNegInf;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) M = fmaxf(M, m_s[w][g]);
    float L = 0.f, O = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float e = expf(m_s[w][g] - M);
      L = fmaf(l_s[w][g], e, L);
      O = fmaf(acc_s[w][g][d], e, O);
    }
    o_out[(out_row + g) * DH + d] = O / fmaxf(L, 1e-30f);
    if (d == 0) {
      m_out[out_row + g] = M;
      l_out[out_row + g] = L;
    }
  }
}

// ---- host-side launch: dispatch on format, head dim and group -------------

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const void* ks;
  const void* vs;
  const void* table;      // TableWalk only
  const void* base;
  const void* length;
  void* o;
  void* m;
  void* l;
  int B, K, NP, T, G, P;
  long P_total;           // TableWalk only
  int window;             // < 0: no window
};

template <int FMT, int DH, int GM, template <int, int> class Walk>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  const dim3 grid(a.P, a.K, a.B);
  const float scale = 1.0f / sqrtf(static_cast<float>(DH));
  paged_attention_kernel<FMT, DH, GM, Walk<FMT, DH>>
      <<<grid, kThreads, 0, stream>>>(
          static_cast<const float*>(a.q), a.k, a.v,
          static_cast<const float*>(a.ks), static_cast<const float*>(a.vs),
          static_cast<const int*>(a.table), static_cast<const int*>(a.base),
          static_cast<const int*>(a.length), static_cast<float*>(a.o),
          static_cast<float*>(a.m), static_cast<float*>(a.l), a.K, a.NP, a.T,
          a.G, a.P, a.P_total, a.window, scale);
  return cudaGetLastError();
}

template <int FMT, int DH, template <int, int> class Walk>
cudaError_t launch_g(const Args& a, cudaStream_t stream) {
  if (a.G <= 1) return launch<FMT, DH, 1, Walk>(a, stream);
  if (a.G <= 2) return launch<FMT, DH, 2, Walk>(a, stream);
  if (a.G <= 4) return launch<FMT, DH, 4, Walk>(a, stream);
  return launch<FMT, DH, 8, Walk>(a, stream);
}

template <int FMT, template <int, int> class Walk>
cudaError_t launch_dh(int dh, const Args& a, cudaStream_t stream) {
  switch (dh) {
    case 32: return launch_g<FMT, 32, Walk>(a, stream);
    case 64: return launch_g<FMT, 64, Walk>(a, stream);
    case 128: return launch_g<FMT, 128, Walk>(a, stream);
    default: return cudaErrorInvalidValue;
  }
}

// fmt: 0 f32, 1 bf16, 2 kv8, 3 kv4.  Launches on `stream`, allocates
// nothing, and returns cudaGetLastError() after the launch (0 = success).
template <template <int, int> class Walk>
int dispatch(int fmt, int dh, const Args& a, void* stream) {
  if (a.B < 1 || a.K < 1 || a.NP < 1 || a.T < 1 || a.G < 1 || a.G > 8 ||
      a.P < 1 || a.NP % a.P != 0 || (fmt == kKV4 && a.T % 2 != 0) ||
      a.K > 65535 || a.B > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (fmt) {
    case kF32: return static_cast<int>(launch_dh<kF32, Walk>(dh, a, s));
    case kBF16: return static_cast<int>(launch_dh<kBF16, Walk>(dh, a, s));
    case kKV8: return static_cast<int>(launch_dh<kKV8, Walk>(dh, a, s));
    case kKV4: return static_cast<int>(launch_dh<kKV4, Walk>(dh, a, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace kvnand
