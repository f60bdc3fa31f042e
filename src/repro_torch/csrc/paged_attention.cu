// Paged decode attention over the per-slot stripe layout, for Hopper (sm_90a).
//
// Replaces the TPU kernel `paged_attention_pallas`
// (src/repro/kernels/paged_attention/kernel.py, body `_kernel`, loader
// `_load_pages`).  It computes the same function: one query token per slot
// and kv head (a group of G query heads) against the slot's pages, online
// softmax in float32, kv8/kv4 dequant fused (the K scale multiplies the
// scores after the QK dot, the V scale multiplies p before the PV dot),
// validity derived from page_base / length / window, and locally normalized
// partials (o, m, l) per page-walk partition for the caller's LSE merge.
//
// Layouts (all contiguous):
//   q      [B, K, G, DH] float32 (unscaled)
//   k, v   [B, K, NP, Ts, DH]  float32 | bf16 | int8 (kv8) |
//                              uint8 (kv4: Ts = T/2, token 2i in the high
//                              nibble, 2i+1 in the low nibble, offset 8)
//   ks, vs [B, K, NP] float32 (kv8/kv4 only)
//   base   [B, NP] int32 (absolute position of each page's slot 0, <0 =
//          unwritten), length [B] int32
//   o      [B, K, P, G, DH] float32, m / l [B, K, P, G] float32
//
// What bounds it: decode attention does ~4 flops per KV byte (bf16), far
// below the card's ~295 flops/byte balance point, so it is bound by the KV
// bytes it streams from HBM.  The design therefore reads each valid token's
// K and V exactly once and skips whole 32-token tiles (and single tokens)
// that the page bases, length and window mark invalid — a masked token costs
// no bytes.  The grid is one CTA per (partition, kv head, slot); the walk
// over a partition's pages is a loop inside the CTA, since nothing carries
// across CTAs.  Eight warps split the partition's 32-token tiles; each warp
// keeps its own online softmax (QK with one lane per token, PV with one lane
// per head-dim slice, p broadcast by warp shuffles) and the warps merge by
// log-sum-exp through shared memory at the end.  A lane issues all of its
// K row's loads at once, and the PV step loads V rows in groups of 8-16
// tokens before their FMAs, so a tile costs a few memory round trips.
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

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

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

// 8 consecutive dims [d0, d0 + 8) of token `tok` as float codes (unscaled).
template <int FMT, int DH>
__device__ __forceinline__ void load8(const void* stripe, long tok, int d0,
                                      float out[8]) {
  const long idx = storage_row<FMT>(tok) * DH + d0;
  if (FMT == kF32) {
    const float4* p = reinterpret_cast<const float4*>(
        static_cast<const float*>(stripe) + idx);
    const float4 a = p[0], b = p[1];
    out[0] = a.x; out[1] = a.y; out[2] = a.z; out[3] = a.w;
    out[4] = b.x; out[5] = b.y; out[6] = b.z; out[7] = b.w;
  } else if (FMT == kBF16) {
    const uint4 u = *reinterpret_cast<const uint4*>(
        static_cast<const __nv_bfloat16*>(stripe) + idx);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float2 f = __bfloat1622float2(h[j]);
      out[2 * j] = f.x;
      out[2 * j + 1] = f.y;
    }
  } else {
    const uint2 u = *reinterpret_cast<const uint2*>(
        static_cast<const uint8_t*>(stripe) + idx);
    const uint8_t* c = reinterpret_cast<const uint8_t*>(&u);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      if (FMT == kKV8) {
        out[j] = static_cast<float>(static_cast<int8_t>(c[j]));
      } else {
        const int nib = (tok & 1) ? (c[j] & 0xF) : (c[j] >> 4);
        out[j] = static_cast<float>(nib - 8);
      }
    }
  }
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

// N (= 1, 2 or 4) consecutive dims [d0, d0 + N) of token `tok` as float
// codes, in one aligned vector load.
template <int FMT, int DH, int N>
__device__ __forceinline__ void load_n(const void* stripe, long tok, int d0,
                                       float out[N]) {
  constexpr int EB = StorageBytes<FMT>::value;
  using V = typename Vec<N * EB>::T;
  const long idx = storage_row<FMT>(tok) * DH + d0;
  const V raw = *reinterpret_cast<const V*>(
      static_cast<const uint8_t*>(stripe) + idx * EB);
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
      const int nib = (tok & 1) ? (c[j] & 0xF) : (c[j] >> 4);
      out[j] = static_cast<float>(nib - 8);
    }
  }
}

// One CTA per (partition p, kv head k, slot b).  GM >= G is the compile-time
// bound on the query group; rows g >= G are never touched.
template <int FMT, int DH, int GM>
__global__ void __launch_bounds__(kThreads)
paged_attention_kernel(const float* __restrict__ q,
                       const void* __restrict__ kp,
                       const void* __restrict__ vp,
                       const float* __restrict__ ks,
                       const float* __restrict__ vs,
                       const int* __restrict__ base,
                       const int* __restrict__ length,
                       float* __restrict__ o_out,
                       float* __restrict__ m_out,
                       float* __restrict__ l_out,
                       int K, int NP, int T, int G, int P, int window,
                       float scale) {
  constexpr int DPL = DH / 32;            // head dims owned per lane in PV
  constexpr int kVGroup = DH <= 64 ? 16 : 8;  // V rows loaded per batch
  constexpr bool kQuant = FMT == kKV8 || FMT == kKV4;
  __shared__ float q_s[GM][DH];
  __shared__ float m_s[kWarps][GM];
  __shared__ float l_s[kWarps][GM];
  __shared__ float acc_s[kWarps][GM][DH];

  const int p = blockIdx.x, k = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long bk = static_cast<long>(b) * K + k;
  const int npp = NP / P;

  for (int i = threadIdx.x; i < G * DH; i += kThreads)
    q_s[i / DH][i % DH] = q[bk * G * DH + i] * scale;
  __syncthreads();

  // the (b, k) stripe: NP pages of Ts storage rows, contiguous
  const int Ts = FMT == kKV4 ? T / 2 : T;
  const long stripe_elems = static_cast<long>(NP) * Ts * DH;
  const void* k_stripe = static_cast<const uint8_t*>(kp) +
                         bk * stripe_elems * StorageBytes<FMT>::value;
  const void* v_stripe = static_cast<const uint8_t*>(vp) +
                         bk * stripe_elems * StorageBytes<FMT>::value;
  const float* ks_bk = kQuant ? ks + bk * NP : nullptr;
  const float* vs_bk = kQuant ? vs + bk * NP : nullptr;
  const int* base_b = base + static_cast<long>(b) * NP;
  const int len = length[b];
  const int tok0 = p * npp * T;           // first stripe token of partition
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
    const int pos = pb + static_cast<int>(tok - static_cast<long>(page) * T);
    bool valid = tl < ntok && pb >= 0 && pos < len;
    if (window >= 0) valid = valid && pos > len - 1 - window;
    const unsigned vmask = __ballot_sync(kFull, valid);
    if (vmask == 0u) continue;            // whole tile masked: no bytes read

    float s[GM];
#pragma unroll
    for (int g = 0; g < GM; ++g) s[g] = 0.f;
    if (valid) {
#pragma unroll
      for (int d0 = 0; d0 < DH; d0 += 8) {
        float kv[8];
        load8<FMT, DH>(k_stripe, tok, d0, kv);
#pragma unroll
        for (int g = 0; g < GM; ++g) {
          if (g < G) {
#pragma unroll
            for (int j = 0; j < 8; ++j) s[g] = fmaf(q_s[g][d0 + j], kv[j], s[g]);
          }
        }
      }
      if (kQuant) {
        const float kscale = ks_bk[page];
#pragma unroll
        for (int g = 0; g < GM; ++g) s[g] *= kscale;
      }
    } else {
#pragma unroll
      for (int g = 0; g < GM; ++g) s[g] = kNegInf;
    }

    // ---- online softmax over the tile, per query row -------------------
    const float vscale = (kQuant && valid) ? vs_bk[page] : 1.f;
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
      float vv[kVGroup][DPL];
#pragma unroll
      for (int t = 0; t < kVGroup; ++t) {
        if ((gmask >> t) & 1u) {
          load_n<FMT, DH, DPL>(v_stripe, static_cast<long>(tok0) + t0 + tg + t,
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

template <int FMT, int DH, int GM>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* ks, const void* vs, const void* base,
                   const void* length, void* o, void* m, void* l, int B,
                   int K, int NP, int T, int G, int P, int window,
                   cudaStream_t stream) {
  const dim3 grid(P, K, B);
  const float scale = 1.0f / sqrtf(static_cast<float>(DH));
  paged_attention_kernel<FMT, DH, GM><<<grid, kThreads, 0, stream>>>(
      static_cast<const float*>(q), k, v, static_cast<const float*>(ks),
      static_cast<const float*>(vs), static_cast<const int*>(base),
      static_cast<const int*>(length), static_cast<float*>(o),
      static_cast<float*>(m), static_cast<float*>(l), K, NP, T, G, P, window,
      scale);
  return cudaGetLastError();
}

template <int FMT, int DH>
cudaError_t launch_g(int G, const void* q, const void* k, const void* v,
                     const void* ks, const void* vs, const void* base,
                     const void* length, void* o, void* m, void* l, int B,
                     int K, int NP, int T, int P, int window,
                     cudaStream_t stream) {
#define KVNAND_LAUNCH(GM)                                                   \
  return launch<FMT, DH, GM>(q, k, v, ks, vs, base, length, o, m, l, B, K, \
                             NP, T, G, P, window, stream)
  if (G <= 1) KVNAND_LAUNCH(1);
  if (G <= 2) KVNAND_LAUNCH(2);
  if (G <= 4) KVNAND_LAUNCH(4);
  KVNAND_LAUNCH(8);
#undef KVNAND_LAUNCH
}

template <int FMT>
cudaError_t launch_dh(int dh, int G, const void* q, const void* k,
                      const void* v, const void* ks, const void* vs,
                      const void* base, const void* length, void* o, void* m,
                      void* l, int B, int K, int NP, int T, int P, int window,
                      cudaStream_t stream) {
  switch (dh) {
    case 32:
      return launch_g<FMT, 32>(G, q, k, v, ks, vs, base, length, o, m, l, B,
                               K, NP, T, P, window, stream);
    case 64:
      return launch_g<FMT, 64>(G, q, k, v, ks, vs, base, length, o, m, l, B,
                               K, NP, T, P, window, stream);
    case 128:
      return launch_g<FMT, 128>(G, q, k, v, ks, vs, base, length, o, m, l, B,
                                K, NP, T, P, window, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// Plain C entry point (bound with ctypes).  fmt: 0 f32, 1 bf16, 2 kv8,
// 3 kv4; window < 0 means no window.  Launches on `stream`, allocates
// nothing, and returns cudaGetLastError() after the launch (0 = success).
extern "C" int kvnand_paged_attention(const void* q, const void* k,
                                      const void* v, const void* ks,
                                      const void* vs, const void* base,
                                      const void* length, void* o, void* m,
                                      void* l, int B, int K, int NP, int T,
                                      int G, int dh, int P, int window,
                                      int fmt, void* stream) {
  if (B < 1 || K < 1 || NP < 1 || T < 1 || G < 1 || G > 8 || P < 1 ||
      NP % P != 0 || (fmt == kKV4 && T % 2 != 0) || K > 65535 || B > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (fmt) {
    case kF32:
      err = launch_dh<kF32>(dh, G, q, k, v, ks, vs, base, length, o, m, l, B,
                            K, NP, T, P, window, s);
      break;
    case kBF16:
      err = launch_dh<kBF16>(dh, G, q, k, v, ks, vs, base, length, o, m, l, B,
                             K, NP, T, P, window, s);
      break;
    case kKV8:
      err = launch_dh<kKV8>(dh, G, q, k, v, ks, vs, base, length, o, m, l, B,
                            K, NP, T, P, window, s);
      break;
    case kKV4:
      err = launch_dh<kKV4>(dh, G, q, k, v, ks, vs, base, length, o, m, l, B,
                            K, NP, T, P, window, s);
      break;
    default:
      err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
