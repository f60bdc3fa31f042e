// Flash-attention forward for Hopper (sm_90a), kernel B4, with a plain C
// entry point bound by ctypes.
//
// Replaces the TPU kernel `flash_attention_pallas`
// (src/repro/kernels/flash_attention/kernel.py, body `_kernel`).  It
// computes the same function: softmax(q·scale · kᵀ) · v per query head,
// online softmax in float32 over k tiles, causal and sliding-window masks,
// GQA (query head h reads kv head h / G), the ragged tails past sq_valid /
// sk_valid masked, fully masked (q tile, k tile) pairs skipped.  Numerics as
// the reference: q is scaled in float32 before the QK dot, masked scores are
// the finite -1e30, l is clamped at 1e-30, the output is cast to q's type.
//
// Layouts (element strides, the head dim contiguous):
//   q  [B, Sq, H, dh]  float32 or bfloat16, strides (q_b, q_s, q_h, 1)
//   k  [B, Sk, K, dh]  the same type,       strides (k_b, k_s, k_h, 1)
//   v  [B, Sk, K, dh]                       strides (v_b, v_s, v_h, 1)
//   o  [B, Sq, H, dh]  q's type, contiguous
// dh is 32, 64, 112, 128, 160 or 256; every row start is 16-byte aligned (the
// wrapper checks).  A kernel instance computes at a width DH of 64, 128 or
// 256 and takes any dh up to it: the tile loads zero-fill the head dims at
// and past dh (so they add nothing to q·kᵀ) and the store skips them, which
// is the reference's padding of dh to its 128-wide lanes done in shared
// memory instead of in copies (q is scaled by the caller's dh^-0.5).
// Query row i sits at position q_offset + i, key j at position j; key j is
// visible to row i when j < Sk, (causal) j <= pos_i and (window w > 0)
// j > pos_i - w.
//
// What bounds it on this card: the two chained products cost 4·dh FLOPs per
// visible (query, key) pair, Sq·Sk/2 pairs a head for a causal prompt, while
// the bytes moved are q, k, v and o once, (2·Sq + 2·Sk)·dh values a head: at
// 256 tokens that is already ~32 FLOPs a float32 byte, so the kernel is
// bound by arithmetic, not by HBM (the bound printed beside its time by
// chip_smoke.py takes the larger of the two anyway).  It
// computes in float32 on CUDA cores (67 TFLOP/s on an H100 SXM), because the
// serving path runs float32 activations and TF32 tensor cores would keep
// about three decimal digits.  The design serves that bound:
//   * a CTA owns one (b, h, 64-row q tile) and loops over 64-key tiles
//     itself, carrying m, l and the output accumulator in registers (the
//     TPU kernel's sequential k grid axis with VMEM scratch has no
//     counterpart here: CTAs run in parallel and share nothing);
//   * the k loop visits only the tiles some row of the q tile can see
//     (causal: none past the last row's position; window: none before the
//     first row's reach), which is the Pallas kernel's `relevant` test;
//     q tiles are handed out last-first, so the longest causal walks start
//     first;
//   * 256 threads as 16 x 16: a thread owns 4 query rows and, in the QK
//     step, 4 keys of the tile (a 4 x 4 block of scores from float4
//     shared-memory reads, 16 FMAs per 8 loads), in the PV step 4 (dh 64)
//     or 8 (dh 128) output columns of its 4 rows; a row's max and sum are
//     reduced over its 16 threads by warp shuffles;
//   * q, k and v tiles are converted to float32 on their way into shared
//     memory (q already scaled); rows past Sq / Sk are zero-filled and
//     masked, so ragged tails need no padding by the caller; the score tile
//     P reuses the K tile's shared memory;
//   * 51 KB (DH 64) / 100 KB (DH 128) of dynamic shared memory, two CTAs an
//     SM at DH 128, so one CTA's tile loads overlap the other's arithmetic
//     (194 KB and one CTA an SM at DH 256).
// What it leaves on the table: no cp.async/TMA double buffering inside a
// CTA, no tensor cores (a bf16 wgmma version is later work), and few CTAs at
// small prompts (B=1, 16 heads, 256 tokens is 64 CTAs on 132 SMs).
//
// A row that sees no key at all (only possible with q_offset > 0 or Sq > Sk
// together with a window) comes out as 0; the blocked plain version returns
// an average that depends on its chunking there.  No caller asks for one.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kBQ = 64;            // query rows per CTA
constexpr int kBK = 64;            // keys per tile
constexpr int kThreads = 256;      // 16 x 16
constexpr int kLdP = kBK + 4;      // row stride of the score tile, floats
constexpr unsigned kFull = 0xffffffffu;

struct Args {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  long long q_b, q_s, q_h, k_b, k_s, k_h, v_b, v_s, v_h;
  int Sq, Sk, H, G, causal, window, q_offset, dh;
  float scale;
};

// 16 bytes of input -> float32 in shared memory, times `mul`
__device__ __forceinline__ void load_chunk(const float* src, float* dst,
                                           float mul) {
  float4 x = *reinterpret_cast<const float4*>(src);
  x.x *= mul;
  x.y *= mul;
  x.z *= mul;
  x.w *= mul;
  *reinterpret_cast<float4*>(dst) = x;
}

__device__ __forceinline__ float bf16_lo(uint32_t w) {
  return __uint_as_float(w << 16);
}
__device__ __forceinline__ float bf16_hi(uint32_t w) {
  return __uint_as_float(w & 0xffff0000u);
}

__device__ __forceinline__ void load_chunk(const __nv_bfloat16* src,
                                           float* dst, float mul) {
  const uint4 u = *reinterpret_cast<const uint4*>(src);
  *reinterpret_cast<float4*>(dst) =
      make_float4(bf16_lo(u.x) * mul, bf16_hi(u.x) * mul, bf16_lo(u.y) * mul,
                  bf16_hi(u.y) * mul);
  *reinterpret_cast<float4*>(dst + 4) =
      make_float4(bf16_lo(u.z) * mul, bf16_hi(u.z) * mul, bf16_lo(u.w) * mul,
                  bf16_hi(u.w) * mul);
}

// ROWS x DH elements from `src` (row stride `stride` elements) into `dst`
// (row stride `ld` floats); rows at or past `valid` and head dims at or past
// `dh` are zero-filled.
template <typename T, int DH, int ROWS>
__device__ __forceinline__ void load_tile(const T* src, long long stride,
                                          int valid, int dh, float* dst,
                                          int ld, float mul) {
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kPerRow = DH / kVec;
  for (int c = threadIdx.x; c < ROWS * kPerRow; c += kThreads) {
    const int r = c / kPerRow;
    const int col = (c % kPerRow) * kVec;
    float* d = dst + r * ld + col;
    if (r < valid && col < dh) {
      load_chunk(src + r * stride + col, d, mul);
    } else {
#pragma unroll
      for (int e = 0; e < kVec; e += 4)
        *reinterpret_cast<float4*>(d + e) = make_float4(0.f, 0.f, 0.f, 0.f);
    }
  }
}

__device__ __forceinline__ float dot4(const float4& a, const float4& b,
                                      float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

__device__ __forceinline__ float lane(const float4& x, int i) {
  return i == 0 ? x.x : i == 1 ? x.y : i == 2 ? x.z : x.w;
}

__device__ __forceinline__ void store4(float* o, const float* x) {
  *reinterpret_cast<float4*>(o) = make_float4(x[0], x[1], x[2], x[3]);
}

__device__ __forceinline__ void store4(__nv_bfloat16* o, const float* x) {
  const __nv_bfloat162 a = __floats2bfloat162_rn(x[0], x[1]);
  const __nv_bfloat162 b = __floats2bfloat162_rn(x[2], x[3]);
  uint2 u;
  u.x = *reinterpret_cast<const uint32_t*>(&a);
  u.y = *reinterpret_cast<const uint32_t*>(&b);
  *reinterpret_cast<uint2*>(o) = u;
}

template <int DH>
constexpr int smem_bytes() {
  return (kBQ * (DH + 4) + kBK * (DH + 4) + kBK * DH) * 4;
}

template <typename T, int DH>
__global__ void __launch_bounds__(kThreads, DH >= 256 ? 1 : 2)
flash_fwd(const Args a) {
  constexpr int kLd = DH + 4;       // q and k tile row stride, floats
  constexpr int kNE = DH / 16;      // output columns per thread
  static_assert(kBQ * kLdP <= kBK * kLd, "P must fit in the K tile");
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);   // [kBQ][kLd], scaled q
  float* Ks = Qs + kBQ * kLd;                    // [kBK][kLd]
  float* Vs = Ks + kBK * kLd;                    // [kBK][DH]
  float* Ps = Ks;                                // [kBQ][kLdP], after QK

  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kh = h / a.G;
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;

  const T* qp = static_cast<const T*>(a.q) + b * a.q_b + q0 * a.q_s +
                h * a.q_h;
  const T* kp = static_cast<const T*>(a.k) + b * a.k_b + kh * a.k_h;
  const T* vp = static_cast<const T*>(a.v) + b * a.v_b + kh * a.v_h;
  load_tile<T, DH, kBQ>(qp, a.q_s, a.Sq - q0, a.dh, Qs, kLd, a.scale);

  // the keys any row of this tile can see: [k_lo, k_hi)
  const int q_first = a.q_offset + q0;
  const int q_last = a.q_offset + min(q0 + kBQ, a.Sq) - 1;
  const int k_hi = a.causal ? min(a.Sk, q_last + 1) : a.Sk;
  const int k_lo = a.window > 0 ? max(0, q_first - a.window + 1) : 0;

  float m[4], l[4], acc[4][kNE];
  int pos[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
    pos[i] = q_first + ty * 4 + i;
#pragma unroll
    for (int e = 0; e < kNE; ++e) acc[i][e] = 0.f;
  }

  for (int k0 = k_lo / kBK * kBK; k0 < k_hi; k0 += kBK) {
    __syncthreads();    // the last tile's P and V reads are done
    load_tile<T, DH, kBK>(kp + k0 * a.k_s, a.k_s, a.Sk - k0, a.dh, Ks, kLd,
                          1.f);
    load_tile<T, DH, kBK>(vp + k0 * a.v_s, a.v_s, a.Sk - k0, a.dh, Vs, DH,
                          1.f);
    __syncthreads();

    // S = (q·scale) kᵀ: rows ty*4 + i, keys tx + 16 j
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < DH; d += 4) {
      float4 kv[4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
        kv[j] = *reinterpret_cast<const float4*>(Ks + (tx + 16 * j) * kLd + d);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float4 qv =
            *reinterpret_cast<const float4*>(Qs + (ty * 4 + i) * kLd + d);
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = dot4(qv, kv[j], s[i][j]);
      }
    }

    // mask, then the online softmax update of each row
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int key = k0 + tx + 16 * j;
        const bool ok = key < a.Sk && (!a.causal || key <= pos[i]) &&
                        (a.window <= 0 || key > pos[i] - a.window);
        s[i][j] = ok ? s[i][j] : kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, off));
      const float m_new = fmaxf(m[i], mx);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = expf(s[i][j] - m_new);
        sum += s[i][j];
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        sum += __shfl_xor_sync(kFull, sum, off);
      const float alpha = expf(m[i] - m_new);
      l[i] = l[i] * alpha + sum;
#pragma unroll
      for (int e = 0; e < kNE; ++e) acc[i][e] *= alpha;
      m[i] = m_new;
    }
    __syncthreads();    // every thread is done reading the K tile
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        Ps[(ty * 4 + i) * kLdP + tx + 16 * j] = s[i][j];
    __syncthreads();

    // acc += P v: rows ty*4 + i, columns tx*4 (+ 64) .. + 3
#pragma unroll 2
    for (int c = 0; c < kBK; c += 4) {
      float4 pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        pv[i] = *reinterpret_cast<const float4*>(Ps + (ty * 4 + i) * kLdP + c);
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) {
        const float* vr = Vs + (c + cc) * DH + tx * 4;
        float4 vv[kNE / 4];
#pragma unroll
        for (int u = 0; u < kNE / 4; ++u)
          vv[u] = *reinterpret_cast<const float4*>(vr + 64 * u);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float p = lane(pv[i], cc);
#pragma unroll
          for (int u = 0; u < kNE / 4; ++u) {
            acc[i][4 * u + 0] = fmaf(p, vv[u].x, acc[i][4 * u + 0]);
            acc[i][4 * u + 1] = fmaf(p, vv[u].y, acc[i][4 * u + 1]);
            acc[i][4 * u + 2] = fmaf(p, vv[u].z, acc[i][4 * u + 2]);
            acc[i][4 * u + 3] = fmaf(p, vv[u].w, acc[i][4 * u + 3]);
          }
        }
      }
    }
  }

  // o = acc / max(l, 1e-30), rows below Sq only
  T* o = static_cast<T*>(a.o);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    if (row >= a.Sq) continue;
    const float den = fmaxf(l[i], 1e-30f);
    T* orow = o + (((long long)b * a.Sq + row) * a.H + h) * a.dh + tx * 4;
#pragma unroll
    for (int u = 0; u < kNE / 4; ++u) {
      if (64 * u + tx * 4 >= a.dh) continue;   // padded head dims
      float x[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) x[e] = acc[i][4 * u + e] / den;
      store4(orow + 64 * u, x);
    }
  }
}

template <typename T, int DH>
int launch(const Args& a, int B, void* stream) {
  constexpr int bytes = smem_bytes<DH>();
  static bool attr_set = false;   // one attribute call per instance
  if (!attr_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_fwd<T, DH>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (e != cudaSuccess) return static_cast<int>(e);
    attr_set = true;
  }
  const dim3 grid((a.Sq + kBQ - 1) / kBQ, a.H, B);
  flash_fwd<T, DH><<<grid, kThreads, bytes,
                     static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// See the layouts above.  window <= 0 means no window; causal is 0 or 1;
// bf16 selects bfloat16 inputs and output (else float32); scale multiplies
// q (the caller's dh^-0.5).  Returns cudaGetLastError() after the launch (or
// the attribute call's error), or -1 for a head dim not in 32, 64, 112, 128,
// 160, 256.
extern "C" int kvnand_flash_attention(
    const void* q, const void* k, const void* v, void* o, long long q_b,
    long long q_s, long long q_h, long long k_b, long long k_s, long long k_h,
    long long v_b, long long v_s, long long v_h, int B, int Sq, int Sk, int H,
    int K, int dh, int causal, int window, int q_offset, int bf16, float scale,
    void* stream) {
  const Args a{q,   k,   v,   o,   q_b, q_s, q_h,    k_b,      k_s,
               k_h, v_b, v_s, v_h, Sq,  Sk,  H,   H / K, causal, window,
               q_offset, dh, scale};
  switch (dh) {
    case 32:
    case 64:
      return bf16 ? launch<__nv_bfloat16, 64>(a, B, stream)
                  : launch<float, 64>(a, B, stream);
    case 112:
    case 128:
      return bf16 ? launch<__nv_bfloat16, 128>(a, B, stream)
                  : launch<float, 128>(a, B, stream);
    case 160:
    case 256:
      return bf16 ? launch<__nv_bfloat16, 256>(a, B, stream)
                  : launch<float, 256>(a, B, stream);
    default:
      return -1;
  }
}
