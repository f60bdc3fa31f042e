// Flash-attention forward for Hopper (sm_90a), kernel B4, with a plain C
// entry point bound by ctypes.
//
// Replaces the TPU kernel `flash_attention_pallas`
// (src/repro/kernels/flash_attention/kernel.py, body `_kernel`).  It
// computes the same function: softmax(q·scale · kᵀ) · v per query head,
// online softmax in float32 over k tiles, causal and sliding-window masks,
// GQA (query head h reads kv head h / G), the ragged tails past Sq / Sk
// masked, fully masked (q rows, k tile) pairs skipped.  Numerics as the
// reference: masked scores are the finite -1e30, l is clamped at 1e-30, the
// output is cast to q's type; a float32 q is scaled in float32 before the
// QK product, a bfloat16 one after it (the bf16 products are exact in f32,
// so the two differ by f32 rounding only).
//
// Layouts (element strides, the head dim contiguous):
//   q  [B, Sq, H, dh]  float32 or bfloat16, strides (q_b, q_s, q_h, 1)
//   k  [B, Sk, K, dh]  the same type,       strides (k_b, k_s, k_h, 1)
//   v  [B, Sk, K, dh]                       strides (v_b, v_s, v_h, 1)
//   o  [B, Sq, H, dh]  q's type, contiguous
// dh is 32, 64, 112, 128, 160 or 256; every row start is 16-byte aligned (the
// wrapper checks).  An instance computes at a width DH of 64, 128 or 256 and
// takes any dh up to it: the tile copies zero-fill the dims at and past dh
// (so they add nothing to either product) and the store skips them.
// Query row i sits at position q_offset + i, key j at position j; key j is
// visible to row i when j < Sk, (causal) j <= pos_i and (window w > 0)
// j > pos_i - w.
//
// What bounds it on this card: the two chained products cost 4·dh FLOPs per
// visible (query, key) pair, Sq·Sk/2 pairs a head for a causal prompt, while
// q, k, v and o move once, (2·Sq + 2·Sk)·dh values a head: arithmetic, not
// HBM, from a few hundred tokens on.  Float32 must stay float32-exact (the
// reference's f32 tolerance is 2e-5; one TF32 rounding keeps ~3 digits), so
// the fastest exact route is three TF32 tensor-core products per product
// (3xTF32: x = hi + lo, hi = tf32(x), lo = tf32(x - hi); a·b = hi·hi +
// hi·lo + lo·hi in f32, the lo·lo term below f32 rounding): 494.7 / 3 =
// 165 TFLOP/s against 67 on the CUDA cores.  Bfloat16 inputs take the bf16
// tensor cores (989 TFLOP/s) with f32 accumulation.
//
// The design:
//   * a CTA of 4 warps owns 64 query rows of one (b, h); a warp owns 16 rows,
//     the mma's row side, so a row's max and sum reduce within a quad (two
//     shuffles) and each thread keeps a partial l until the end;
//   * f32: mma.sync m16n8k8 tf32, three products each (lo·hi, hi·lo, hi·hi
//     into one f32 accumulator).  The k slots of both products are permuted
//     (slot t <-> element 4t + 2s, slot t + 4 <-> 4t + 2s + 1 over two steps
//     s of QKᵀ; slot t <-> key 2t, t + 4 <-> key 2t + 1 in PV), so a thread
//     reads its q and k fragments of two k steps as one 16-byte load and
//     P passes from the QKᵀ accumulator to the PV A fragment in place, with
//     no shuffle and no trip through shared memory; V's n slots are permuted
//     the same way (slot g of a pair of n tiles <-> columns 2g, 2g + 1), so V
//     is read 8 bytes at a time and the output lands as 4 consecutive
//     columns a row;
//   * bf16: mma.sync m16n8k16 bf16 with ldmatrix fragments (V through
//     ldmatrix.trans), P passed register to register as bf16 hi + lo (two
//     products, so P keeps ~16 bits: a single bf16 P would add an error of
//     2^-9 |v| that the f32-upcast check cannot absorb near o = 0);
//   * K/V tiles stream through a ring of 2-3 stages of 16-byte cp.async,
//     issued a tile ahead, rows past Sk and dims past dh zero-filled by the
//     copy's source size; rows are padded (f32 q/k by 16 words, v by 4;
//     bf16 by 8 elements) so every fragment load is bank-conflict-free;
//     one __syncthreads a tile;
//   * a warp skips a tile none of its rows can see, and masks only the tiles
//     that straddle Sk, the causal diagonal or the window's edge;
//   * the key range of each (b, h, 64-row q tile) is split over a
//     thread-block cluster of S CTAs (S in 1, 2, 4, 8; chosen on the host by
//     `choose_flash_plan`), each walking a contiguous share of the key
//     tiles; the S partials (m, l, unnormalized o) meet in shared memory and
//     each rank merges a share of the tile's elements over the ranks in
//     rank order through distributed shared memory, so a repeated launch
//     gives the same bits.  S = 1 takes the same epilogue over its own
//     shared memory; every store is 16 (f32) or 8 (bf16) bytes of one row.
//     q tiles are handed out last-first, so the longest causal walks start
//     first.
// What it leaves on the table: at 8192 tokens the f32 products run at
// ~30% of the TF32 peak (counting all three): mma.sync, not wgmma (3xTF32
// on wgmma wants both operands' hi and lo parts staged in shared memory,
// K-major, V transposed), and each warp splits every k and v element of a
// tile itself (the CTA's 4 warps repeat it) and re-splits its q fragments
// every tile.  hi/lo tiles split once into shared memory do not fit beside
// two CTAs an SM at dh 128, and two m-tiles a warp (FA2's reuse of a k/v
// fragment) ran out of registers (PERF.md §6).  One CTA is both producer
// and consumer of its ring; the causal diagonal tile computes its masked
// half.
//
// A row that sees no key at all (only possible with q_offset > 0 or Sq > Sk
// together with a window) comes out as 0; the blocked plain version returns
// an average that depends on its chunking there.  No caller asks for one.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "mma_tf32.cuh"

namespace {

namespace cg = cooperative_groups;

constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kBQ = 64;             // query rows per CTA
constexpr int kThreads = 128;       // 4 warps of 16 rows
constexpr int kMaxSplit = 8;        // portable cluster size

struct Args {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  long long q_b, q_s, q_h, k_b, k_s, k_h, v_b, v_s, v_h;
  int Sq, Sk, H, G, causal, window, q_offset, dh, split;
  float scale;
};

// One compiled instance: keys a tile, ring stages, CTAs an SM it is built to
// hold (its register cap), row strides (elements) and shared-memory layout.
// Mirrored by kernels/flash_attention/kernel.py::INSTANCES.
template <typename T, int DH>
struct Geo {
  static constexpr bool kF32 = std::is_same<T, float>::value;
  static constexpr int kBK = kF32 ? (DH == 64 ? 64 : 32) : (DH == 256 ? 32 : 64);
  static constexpr int kStages = (!kF32 && DH == 64) ? 3 : 2;
  static constexpr int kCtas = kF32 ? (DH == 256 ? 1 : 2) : (DH == 64 ? 3 : 2);
  static constexpr int kLdQK = kF32 ? DH + 16 : DH + 8;   // q and k rows
  static constexpr int kLdV = kF32 ? DH + 4 : DH + 8;     // v rows
  static constexpr int kLdO = DH + 4;                     // partial o, floats
  static constexpr int kQBytes = kBQ * kLdQK * (int)sizeof(T);
  static constexpr int kKBytes = kBK * kLdQK * (int)sizeof(T);
  static constexpr int kStageBytes = kKBytes + kBK * kLdV * (int)sizeof(T);
  static constexpr int kRingBytes = kStages * kStageBytes;
  static constexpr int kPartBytes = (kBQ * kLdO + 2 * kBQ) * 4;
  static constexpr int kBytes =
      kQBytes + (kRingBytes > kPartBytes ? kRingBytes : kPartBytes);
  static_assert(kCtas * (kBytes + 1024) <= 228 * 1024,
                "the instance's CTAs do not fit an SM");
  static_assert(kBytes <= 227 * 1024, "too much shared memory for a CTA");
};

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ void mma_bf16(float (&d)[4],
                                         const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t addr,
                                                  uint32_t (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// (lo, hi) -> one bf16x2 register, lo in the low half; and the residuals
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&p);
}

__device__ __forceinline__ void split_bf16(float x0, float x1, uint32_t& hi,
                                           uint32_t& lo) {
  hi = pack_bf16(x0, x1);
  lo = pack_bf16(x0 - __uint_as_float(hi << 16),
                 x1 - __uint_as_float(hi & 0xffff0000u));
}

// ROWS rows of DH elements from `src` (row stride `stride`) into shared
// memory at `dst` (row stride LD elements) by 16-byte cp.async; rows at or
// past `valid` and dims at or past `dh` are zero-filled.
template <typename T, int DH, int ROWS, int LD>
__device__ __forceinline__ void issue_rows(uint32_t dst, const T* src,
                                           long long stride, int valid,
                                           int dh) {
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kPerRow = DH / kVec;
  static_assert((ROWS * kPerRow) % kThreads == 0, "uneven tile copy");
#pragma unroll
  for (int c = threadIdx.x; c < ROWS * kPerRow; c += kThreads) {
    const int r = c / kPerRow;
    const int col = (c % kPerRow) * kVec;
    const bool ok = r < valid && col < dh;
    cp_async16(dst + (r * LD + col) * (int)sizeof(T),
               ok ? src + r * stride + col : src, ok ? 16 : 0);
  }
}

// The per-warp state: 16 rows, a thread holds rows g and g + 8 (r = 0, 1)
template <int DH>
struct Rows {
  float m[2], l[2];
  float o[DH / 8][4];     // DH/8 n tiles of the mma accumulator
};

// QKᵀ of one tile into s (f32 on 3xTF32).  The two k steps of a 16-wide
// slice accumulate into two sets (s and s2, summed at the end), so each
// accumulator's chain of dependent mma is three deep a slice, not six.
template <int DH, int BK>
__device__ __forceinline__ void qk_f32(const float* Qs, const float* Ks,
                                       float (&s)[BK / 8][4]) {
  using Gm = Geo<float, DH>;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const float* q0 = Qs + (16 * warp + g) * Gm::kLdQK + 4 * t;
  const float* q1 = q0 + 8 * Gm::kLdQK;
  const float* kr = Ks + g * Gm::kLdQK + 4 * t;
  float s2[BK / 8][4];
#pragma unroll
  for (int j = 0; j < BK / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) s2[j][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < DH; kk += 16) {
    const float4 x0 = *reinterpret_cast<const float4*>(q0 + kk);
    const float4 x1 = *reinterpret_cast<const float4*>(q1 + kk);
    uint32_t ah[2][4], al[2][4];
    split_tf32(x0.x, ah[0][0], al[0][0]);
    split_tf32(x1.x, ah[0][1], al[0][1]);
    split_tf32(x0.y, ah[0][2], al[0][2]);
    split_tf32(x1.y, ah[0][3], al[0][3]);
    split_tf32(x0.z, ah[1][0], al[1][0]);
    split_tf32(x1.z, ah[1][1], al[1][1]);
    split_tf32(x0.w, ah[1][2], al[1][2]);
    split_tf32(x1.w, ah[1][3], al[1][3]);
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
      const float4 y =
          *reinterpret_cast<const float4*>(kr + 8 * j * Gm::kLdQK + kk);
      uint32_t bh[4], bl[4];
      split_tf32(y.x, bh[0], bl[0]);
      split_tf32(y.y, bh[1], bl[1]);
      split_tf32(y.z, bh[2], bl[2]);
      split_tf32(y.w, bh[3], bl[3]);
      mma3(s[j], ah[0], al[0], bh[0], bh[1], bl[0], bl[1]);
      mma3(s2[j], ah[1], al[1], bh[2], bh[3], bl[2], bl[3]);
    }
  }
#pragma unroll
  for (int j = 0; j < BK / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[j][e] += s2[j][e];
}

// o += P·V of one tile (f32 on 3xTF32); P is s in place
template <int DH, int BK>
__device__ __forceinline__ void pv_f32(const float* Vs,
                                       const float (&s)[BK / 8][4],
                                       Rows<DH>& w) {
  using Gm = Geo<float, DH>;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int j = 0; j < BK / 8; ++j) {
    uint32_t ph[4], pl[4];
    split_tf32(s[j][0], ph[0], pl[0]);    // row g,     key 2t
    split_tf32(s[j][2], ph[1], pl[1]);    // row g + 8, key 2t
    split_tf32(s[j][1], ph[2], pl[2]);    // row g,     key 2t + 1
    split_tf32(s[j][3], ph[3], pl[3]);    // row g + 8, key 2t + 1
    const float* v0 = Vs + (8 * j + 2 * t) * Gm::kLdV + 2 * g;
    const float* v1 = v0 + Gm::kLdV;
#pragma unroll
    for (int np = 0; np < DH / 16; ++np) {
      const float2 x = *reinterpret_cast<const float2*>(v0 + 16 * np);
      const float2 y = *reinterpret_cast<const float2*>(v1 + 16 * np);
      uint32_t eh0, el0, eh1, el1, oh0, ol0, oh1, ol1;
      split_tf32(x.x, eh0, el0);
      split_tf32(y.x, eh1, el1);
      split_tf32(x.y, oh0, ol0);
      split_tf32(y.y, oh1, ol1);
      mma3(w.o[2 * np], ph, pl, eh0, eh1, el0, el1);
      mma3(w.o[2 * np + 1], ph, pl, oh0, oh1, ol0, ol1);
    }
  }
}

// QKᵀ of one tile into s (bf16 mma, f32 accumulate), then times scale
template <int DH, int BK>
__device__ __forceinline__ void qk_bf16(const __nv_bfloat16* Qs,
                                        const __nv_bfloat16* Ks, float scale,
                                        float (&s)[BK / 8][4]) {
  using Gm = Geo<__nv_bfloat16, DH>;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const uint32_t qa = smem_u32(Qs + (16 * warp + (lane & 15)) * Gm::kLdQK +
                               (lane >> 4) * 8);
  const int mi = lane >> 3;
  const uint32_t ka =
      smem_u32(Ks + ((mi >> 1) * 8 + (lane & 7)) * Gm::kLdQK + (mi & 1) * 8);
#pragma unroll
  for (int kk = 0; kk < DH; kk += 16) {
    uint32_t a[4];
    ldmatrix_x4(qa + kk * 2, a);
#pragma unroll
    for (int jp = 0; jp < BK / 16; ++jp) {
      uint32_t b[4];
      ldmatrix_x4(ka + (jp * 16 * Gm::kLdQK + kk) * 2, b);
      mma_bf16(s[2 * jp], a, b[0], b[1]);
      mma_bf16(s[2 * jp + 1], a, b[2], b[3]);
    }
  }
#pragma unroll
  for (int j = 0; j < BK / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[j][e] *= scale;
}

// o += P·V of one tile (bf16 mma, P as bf16 hi + lo)
template <int DH, int BK>
__device__ __forceinline__ void pv_bf16(const __nv_bfloat16* Vs,
                                        const float (&s)[BK / 8][4],
                                        Rows<DH>& w) {
  using Gm = Geo<__nv_bfloat16, DH>;
  const int lane = threadIdx.x & 31;
  const int mi = lane >> 3;
  const uint32_t va =
      smem_u32(Vs + ((mi & 1) * 8 + (lane & 7)) * Gm::kLdV + (mi >> 1) * 8);
#pragma unroll
  for (int i = 0; i < BK / 16; ++i) {
    uint32_t ph[4], pl[4];
    split_bf16(s[2 * i][0], s[2 * i][1], ph[0], pl[0]);
    split_bf16(s[2 * i][2], s[2 * i][3], ph[1], pl[1]);
    split_bf16(s[2 * i + 1][0], s[2 * i + 1][1], ph[2], pl[2]);
    split_bf16(s[2 * i + 1][2], s[2 * i + 1][3], ph[3], pl[3]);
#pragma unroll
    for (int np = 0; np < DH / 16; ++np) {
      uint32_t b[4];
      ldmatrix_x4_trans(va + (i * 16 * Gm::kLdV + 16 * np) * 2, b);
      mma_bf16(w.o[2 * np], pl, b[0], b[1]);
      mma_bf16(w.o[2 * np], ph, b[0], b[1]);
      mma_bf16(w.o[2 * np + 1], pl, b[2], b[3]);
      mma_bf16(w.o[2 * np + 1], ph, b[2], b[3]);
    }
  }
}

// The 4 output columns a thread holds of row r at column group c4 (4
// columns from 4·c4), as they sit in the accumulator, for the store.
template <typename T, int DH>
__device__ __forceinline__ float4 o_cols(const Rows<DH>& w, int r, int c) {
  if constexpr (std::is_same<T, float>::value) {
    // f32: n tiles 2np (even columns) and 2np + 1 (odd), c = np
    return make_float4(w.o[2 * c][2 * r], w.o[2 * c + 1][2 * r],
                       w.o[2 * c][2 * r + 1], w.o[2 * c + 1][2 * r + 1]);
  } else {
    // bf16: n tile c holds columns 8c + 2t, 8c + 2t + 1 (x, y; z, w unused)
    return make_float4(w.o[c][2 * r], w.o[c][2 * r + 1], 0.f, 0.f);
  }
}

__device__ __forceinline__ void store4(float* o, float4 x) {
  *reinterpret_cast<float4*>(o) = x;
}

__device__ __forceinline__ void store4(__nv_bfloat16* o, float4 x) {
  uint2 u;
  u.x = pack_bf16(x.x, x.y);
  u.y = pack_bf16(x.z, x.w);
  *reinterpret_cast<uint2*>(o) = u;
}

// Grid (q tiles x S, H, B), clusters of S CTAs along x: the S ranks of a
// cluster split the key tiles of one (b, h, q tile).
template <typename T, int DH>
__global__ void __launch_bounds__(kThreads, Geo<T, DH>::kCtas)
flash_fwd(const Args a) {
  using Gm = Geo<T, DH>;
  constexpr int BK = Gm::kBK, ST = Gm::kStages;
  extern __shared__ __align__(16) unsigned char smem[];
  T* Qs = reinterpret_cast<T*>(smem);
  unsigned char* ring = smem + Gm::kQBytes;
  const uint32_t ring_u32 = smem_u32(ring);

  cg::cluster_group cluster = cg::this_cluster();
  const int S = a.split;
  const int rank = static_cast<int>(cluster.block_rank());
  const int nq = (a.Sq + kBQ - 1) / kBQ;
  const int q0 = (nq - 1 - static_cast<int>(blockIdx.x) / S) * kBQ;
  const int h = blockIdx.y, b = blockIdx.z, kh = h / a.G;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;

  const T* qp = static_cast<const T*>(a.q) + b * a.q_b + q0 * a.q_s +
                h * a.q_h;
  const T* kp = static_cast<const T*>(a.k) + b * a.k_b + kh * a.k_h;
  const T* vp = static_cast<const T*>(a.v) + b * a.v_b + kh * a.v_h;

  // the key tiles any row of this q tile can see, and this rank's share
  const int q_first = a.q_offset + q0;
  const int q_last = a.q_offset + min(q0 + kBQ, a.Sq) - 1;
  const int k_hi = a.causal ? min(a.Sk, q_last + 1) : a.Sk;
  const int k_lo = a.window > 0 ? max(0, q_first - a.window + 1) : 0;
  const int t_lo = k_lo / BK;
  const int t_hi = k_hi > k_lo ? (k_hi + BK - 1) / BK : t_lo;
  const int share = (t_hi - t_lo + S - 1) / S;
  const int my_lo = min(t_lo + rank * share, t_hi);
  const int my_n = min(share, t_hi - my_lo);

  // this warp's rows: positions pw0 .. pw0 + 15
  const bool live = q0 + 16 * warp < a.Sq;
  const int pw0 = a.q_offset + q0 + 16 * warp;

  auto issue_tile = [&](int tile, int slot) {
    const int k0 = tile * BK;
    const uint32_t st = ring_u32 + slot * Gm::kStageBytes;
    issue_rows<T, DH, BK, Gm::kLdQK>(st, kp + k0 * a.k_s, a.k_s, a.Sk - k0,
                                     a.dh);
    issue_rows<T, DH, BK, Gm::kLdV>(st + Gm::kKBytes, vp + k0 * a.v_s,
                                    a.v_s, a.Sk - k0, a.dh);
  };

  // prologue: q, then the first ST - 1 tiles, one commit group each
  issue_rows<T, DH, kBQ, Gm::kLdQK>(smem_u32(Qs), qp, a.q_s, a.Sq - q0,
                                    a.dh);
  cp_async_commit();
#pragma unroll
  for (int st = 0; st < ST - 1; ++st) {
    if (st < my_n) issue_tile(my_lo + st, st);
    cp_async_commit();
  }
  if constexpr (Gm::kF32) {
    // q·scale in float32, as the reference: each thread scales the chunks
    // it copied (its own copies are complete after the wait; the first
    // tile's barrier publishes them)
    cp_async_wait<ST - 1>();
    constexpr int kPerRow = DH / 4;
    for (int c = threadIdx.x; c < kBQ * kPerRow; c += kThreads) {
      const int r = c / kPerRow, col = (c % kPerRow) * 4;
      if (r < a.Sq - q0 && col < a.dh) {
        float4* p = reinterpret_cast<float4*>(Qs + r * Gm::kLdQK + col);
        float4 x = *p;
        x.x *= a.scale;
        x.y *= a.scale;
        x.z *= a.scale;
        x.w *= a.scale;
        *p = x;
      }
    }
  }

  Rows<DH> w;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    w.m[r] = kNegInf;
    w.l[r] = 0.f;
  }
#pragma unroll
  for (int n = 0; n < DH / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) w.o[n][e] = 0.f;

  for (int i = 0; i < my_n; ++i) {
    cp_async_wait<ST - 2>();
    __syncthreads();    // tile i has landed; every warp is done with i - 1
    const int nxt = i + ST - 1;
    if (nxt < my_n) issue_tile(my_lo + nxt, nxt % ST);
    cp_async_commit();

    const int k0 = (my_lo + i) * BK;
    // a tile none of the warp's rows can see is skipped
    if (!live || (a.causal && k0 > pw0 + 15) ||
        (a.window > 0 && k0 + BK - 1 <= pw0 - a.window))
      continue;
    const unsigned char* stage = ring + (i % ST) * Gm::kStageBytes;
    const T* Ks = reinterpret_cast<const T*>(stage);
    const T* Vs = reinterpret_cast<const T*>(stage + Gm::kKBytes);

    float s[BK / 8][4];
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
    if constexpr (Gm::kF32)
      qk_f32<DH, BK>(Qs, Ks, s);
    else
      qk_bf16<DH, BK>(Qs, Ks, a.scale, s);

    // masks only on a tile that straddles Sk, the diagonal or the window
    if (k0 + BK > a.Sk || (a.causal && k0 + BK - 1 > pw0) ||
        (a.window > 0 && k0 <= pw0 + 15 - a.window)) {
#pragma unroll
      for (int j = 0; j < BK / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = k0 + 8 * j + 2 * t + (e & 1);
          const int pos = pw0 + g + 8 * (e >> 1);
          const bool ok = key < a.Sk && (!a.causal || key <= pos) &&
                          (a.window <= 0 || key > pos - a.window);
          s[j][e] = ok ? s[j][e] : kNegInf;
        }
    }

    // online softmax of rows g (r = 0) and g + 8 (r = 1)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < BK / 8; ++j)
        mx = fmaxf(mx, fmaxf(s[j][2 * r], s[j][2 * r + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(w.m[r], mx);
      const float alpha = ex2((w.m[r] - m_new) * kLog2e);
      // a row that has seen no visible key yet keeps p = 0 (fma's exact
      // -1e30·log2e minus its f32 rounding would be ~1e23, not 0)
      const float ml = m_new == kNegInf ? 0.f : m_new * kLog2e;
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < BK / 8; ++j)
#pragma unroll
        for (int e = 2 * r; e < 2 * r + 2; ++e) {
          s[j][e] = ex2(fmaf(s[j][e], kLog2e, -ml));
          sum += s[j][e];
        }
      w.l[r] = w.l[r] * alpha + sum;    // this thread's share of the row
      w.m[r] = m_new;
#pragma unroll
      for (int n = 0; n < DH / 8; ++n) {
        w.o[n][2 * r] *= alpha;
        w.o[n][2 * r + 1] *= alpha;
      }
    }

    if constexpr (Gm::kF32)
      pv_f32<DH, BK>(Vs, s, w);
    else
      pv_bf16<DH, BK>(Vs, s, w);
  }
  cp_async_wait<0>();
  __syncthreads();      // the ring becomes the partial tile

  // ---- the partial (m, l, unnormalized o) of every row into shared memory
  float* po = reinterpret_cast<float*>(ring);      // [kBQ][kLdO]
  float* pm = po + kBQ * Gm::kLdO;
  float* pl = pm + kBQ;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float l = w.l[r];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const int row = 16 * warp + g + 8 * r;
    if (t == 0) {
      pm[row] = w.m[r];
      pl[row] = l;
    }
    float* prow = po + row * Gm::kLdO;
    if constexpr (Gm::kF32) {
#pragma unroll
      for (int np = 0; np < DH / 16; ++np)
        *reinterpret_cast<float4*>(prow + 16 * np + 4 * t) =
            o_cols<T, DH>(w, r, np);
    } else {
#pragma unroll
      for (int n = 0; n < DH / 8; ++n) {
        const float4 x = o_cols<T, DH>(w, r, n);
        *reinterpret_cast<float2*>(prow + 8 * n + 2 * t) =
            make_float2(x.x, x.y);
      }
    }
  }
  cluster.sync();       // every rank's partial is written

  // ---- each rank merges a share of the tile over the S ranks, in rank
  // order (log-sum-exp), and stores 4 columns at a time
  T* o = static_cast<T*>(a.o);
  const int rows = min(kBQ, a.Sq - q0);
  constexpr int kC4 = DH / 4;
  for (int i = rank * kThreads + threadIdx.x; i < rows * kC4;
       i += S * kThreads) {
    const int row = i / kC4, c = (i - row * kC4) * 4;
    if (c >= a.dh) continue;
    float M = kNegInf;
    for (int r = 0; r < S; ++r)
      M = fmaxf(M, cluster.map_shared_rank(pm, r)[row]);
    float L = 0.f;
    float4 O = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int r = 0; r < S; ++r) {
      const float e = ex2((cluster.map_shared_rank(pm, r)[row] - M) * kLog2e);
      L = fmaf(cluster.map_shared_rank(pl, r)[row], e, L);
      const float4 x = *reinterpret_cast<const float4*>(
          cluster.map_shared_rank(po, r) + row * Gm::kLdO + c);
      O.x = fmaf(x.x, e, O.x);
      O.y = fmaf(x.y, e, O.y);
      O.z = fmaf(x.z, e, O.z);
      O.w = fmaf(x.w, e, O.w);
    }
    const float den = fmaxf(L, 1e-30f);
    store4(o + (((long long)b * a.Sq + q0 + row) * a.H + h) * a.dh + c,
           make_float4(O.x / den, O.y / den, O.z / den, O.w / den));
  }
  if (S > 1) cluster.sync();    // no rank leaves while it is read
}

template <typename T, int DH>
int launch(const Args& a, int B, void* stream) {
  using Gm = Geo<T, DH>;
  auto* kernel = flash_fwd<T, DH>;
  static bool attr_set = false;   // attribute calls once an instance
  if (!attr_set) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, Gm::kBytes);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
    if (e != cudaSuccess) return static_cast<int>(e);
    attr_set = true;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(((a.Sq + kBQ - 1) / kBQ) * a.split, a.H, B);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = Gm::kBytes;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = a.split;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, kernel, a);
  return static_cast<int>(e != cudaSuccess ? e : cudaGetLastError());
}

template <typename T>
int launch_dh(const Args& a, int B, void* stream) {
  switch (a.dh) {
    case 32:
    case 64:
      return launch<T, 64>(a, B, stream);
    case 112:
    case 128:
      return launch<T, 128>(a, B, stream);
    case 160:
    case 256:
      return launch<T, 256>(a, B, stream);
    default:
      return -1;
  }
}

}  // namespace

// See the layouts above.  window <= 0 means no window; causal is 0 or 1;
// bf16 selects bfloat16 inputs and output (else float32); scale is the
// caller's dh^-0.5; split is the cluster size S (1, 2, 4 or 8) that splits
// each q tile's key range.  Returns cudaGetLastError() after the launch (or
// the attribute call's or the launch's error), or -1 for a head dim not in
// 32, 64, 112, 128, 160, 256 or a split not in 1, 2, 4, 8.
extern "C" int kvnand_flash_attention(
    const void* q, const void* k, const void* v, void* o, long long q_b,
    long long q_s, long long q_h, long long k_b, long long k_s, long long k_h,
    long long v_b, long long v_s, long long v_h, int B, int Sq, int Sk, int H,
    int K, int dh, int causal, int window, int q_offset, int bf16, float scale,
    int split, void* stream) {
  if (split != 1 && split != 2 && split != 4 && split != kMaxSplit) return -1;
  const Args a{q,   k,   v,   o,   q_b, q_s, q_h,    k_b,      k_s,
               k_h, v_b, v_s, v_h, Sq,  Sk,  H,   H / K, causal, window,
               q_offset, dh, split, scale};
  return bf16 ? launch_dh<__nv_bfloat16>(a, B, stream)
              : launch_dh<float>(a, B, stream);
}
