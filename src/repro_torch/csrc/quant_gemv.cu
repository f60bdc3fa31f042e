// Quantized GEMV / small GEMM for Hopper (sm_90a), kernel B3.  Replaces the
// TPU kernel `quant_gemv_pallas` of src/repro/kernels/quant_gemv/kernel.py
// (bodies `_kernel_w4` / `_kernel_w8`) and computes what it computes:
//
//   w4a16  out[m, f] = f32( sum_d bf16(x[m, d]) * w4[d, f] ) * scale[f]
//          q [D/2, F] uint8: row 2i in the high nibble, row 2i+1 in the low
//          nibble, offset 8 (weights -8..7); x [M, ldx] bf16, accumulated
//          in float32 (no bf16 rounding of the product).
//   w8a8   out[m, f] = f32( sum_d x8[m, d] * w8[d, f] ) * scale[f]
//          q [D, F] int8, x [M, ldx] int8 (the caller quantized x per token
//          and multiplies by its scale afterwards), int32 accumulate.
//
// scale [F] float32, out [M, F] float32, all row-major and contiguous.
// Any M >= 1, any F >= 1, any D >= 1 (even D for w4).  ldx is a multiple of
// 4 and the row of x is zero from column D up to ldx: the kernel reads x in
// groups of 4 columns and its weights past D are 0, so a ragged D costs the
// caller one zero-padded copy of x.
//
// What bounds it: at decode (M = the slot count, 4) a GEMV does 2 flops per
// weight element, 4-8 per weight byte: far below the card's ~295 flops/byte
// balance, so it is bound by the quantized weight bytes it streams from HBM
// (the paper's point: the weight stream is the cost of every token).  At M
// = 64 (a prefill chunk) a CUDA-core kernel is bound by its FMAs instead.
// The design therefore reads every weight byte from HBM once and reuses it
// for all the rows of x the CTA holds, in registers:
//
//   * a CTA owns a tile of output columns and up to MT rows of x (grid.y
//     walks M in chunks of MT).  At decode (MT = 4) a lane owns 4
//     adjacent columns and reads them as one 32-bit word per weight row, so
//     a warp reads 128 contiguous bytes of a row (a whole cache line); at
//     MT = 64 a lane owns one column (its 64 accumulators fill the
//     registers) and a warp reads 32 bytes of a row;
//   * the CTA walks its share of D in chunks; its 16 warps split a chunk in
//     groups of 4 rows (2 packed rows for w4), RG groups each;
//   * the weights of the NEXT chunk are loaded into registers before the
//     current chunk is worked on (a register double buffer), so a lane
//     keeps its loads in flight while the CTA computes;
//   * the CTA stages the chunk's x for its rows in shared memory with
//     coalesced loads (bf16 widened to float once); the multiply reads it
//     as same-address broadcasts: 4 FMAs (w4) or one __dp4a (w8) per group,
//     row and column.  (Reading x straight from global memory instead put
//     an L2 round trip behind every few FMAs: 4-10x slower on an H100);
//   * D is split across grid.z CTAs when the column tiles alone cannot
//     fill the card (a narrow F, or a long D at 4 rows): each split writes
//     its partial tile to a workspace, and the last CTA of a tile to finish
//     (a ticket taken with atomicAdd, and reset by that CTA) sums the
//     partials in split order — deterministic — and applies the scale;
//   * within a CTA the 16 warps' partial sums reduce through shared memory
//     in warp order.
//
// What this design leaves on the table: no cp.async / TMA bulk copies of
// the weight stream (plain 4-byte loads, double-buffered in registers), and
// CUDA-core FMAs instead of wgmma / int8 tensor cores at M = 64.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 16;              // warps of a CTA, splitting D
constexpr int kThreads = 32 * kWarps;
constexpr int kRedBytes = 16384;        // cross-warp reduction buffer
constexpr int kTargetCtas = 2;          // CTAs per SM the splits aim for

// 4 consecutive bf16 (little-endian in 8 bytes) -> 4 floats
__device__ __forceinline__ float4 bf16x4(uint2 r) {
  return make_float4(__uint_as_float(r.x << 16),
                     __uint_as_float(r.x & 0xffff0000u),
                     __uint_as_float(r.y << 16),
                     __uint_as_float(r.y & 0xffff0000u));
}

// The nibble at bit `s` of w as the float (nibble - 8), exactly: 2^23 +
// nibble has the nibble in its low mantissa bits, so one shift, one LOP3
// and one FADD replace a slow integer-to-float conversion.
__device__ __forceinline__ float nibble(uint32_t w, int s) {
  return __uint_as_float(0x4B000000u | ((w >> s) & 15u)) - 8388616.0f;
}

// The CPL bytes of columns f0 .. f0 + CPL - 1 of one weight row, packed
// little-endian (byte c = column f0 + c); `fill` for columns past F.
template <int CPL>
__device__ __forceinline__ uint32_t load_cols(const uint8_t* __restrict__ row,
                                              int f0, int F, bool vec,
                                              uint32_t fill) {
  if (CPL == 4 && vec && f0 + 3 < F)
    return __ldg(reinterpret_cast<const uint32_t*>(row + f0));
  uint32_t w = 0;
#pragma unroll
  for (int c = 0; c < CPL; ++c)
    w |= (f0 + c < F ? static_cast<uint32_t>(__ldg(row + f0 + c)) : fill)
         << (8 * c);
  return w;
}

// RG groups of a chunk: w4 2 packed rows per group (0x88: both nibbles 8,
// weight 0, past D), w8 4 rows per group (0 past D).
template <int RG, int CPL>
__device__ __forceinline__ void load_w4(uint32_t (&b)[RG][2],
                                        const uint8_t* __restrict__ q, int F,
                                        int f0, bool vec, int D2, int g0) {
#pragma unroll
  for (int j = 0; j < RG; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int p = 2 * (g0 + j) + h;
      b[j][h] = p < D2 ? load_cols<CPL>(q + static_cast<size_t>(p) * F, f0,
                                        F, vec, 0x88u)
                       : 0x88888888u;
    }
}

template <int RG, int CPL>
__device__ __forceinline__ void load_w8(uint32_t (&b)[RG][4],
                                        const uint8_t* __restrict__ q, int F,
                                        int f0, bool vec, int D, int g0) {
#pragma unroll
  for (int j = 0; j < RG; ++j)
#pragma unroll
    for (int h = 0; h < 4; ++h) {
      const int d = 4 * (g0 + j) + h;
      b[j][h] = d < D ? load_cols<CPL>(q + static_cast<size_t>(d) * F, f0, F,
                                       vec, 0u)
                      : 0u;
    }
}

// Rows r0..r3 (byte c = column c) -> per column c its 4 row bytes, row 0 in
// the low byte (the byte order of 4 consecutive int8 of x).
__device__ __forceinline__ void transpose4(uint32_t r0, uint32_t r1,
                                           uint32_t r2, uint32_t r3,
                                           int (&col)[4]) {
  const uint32_t t0 = __byte_perm(r0, r1, 0x5140);
  const uint32_t t1 = __byte_perm(r2, r3, 0x5140);
  const uint32_t t2 = __byte_perm(r0, r1, 0x7362);
  const uint32_t t3 = __byte_perm(r2, r3, 0x7362);
  col[0] = static_cast<int>(__byte_perm(t0, t1, 0x5410));
  col[1] = static_cast<int>(__byte_perm(t0, t1, 0x7632));
  col[2] = static_cast<int>(__byte_perm(t2, t3, 0x5410));
  col[3] = static_cast<int>(__byte_perm(t2, t3, 0x7632));
}

// This split's chunks [c_begin, c_end) of the `nchunks` of D.
__device__ __forceinline__ void split_range(int nchunks, int& c_begin,
                                            int& c_end) {
  const int per = (nchunks + gridDim.z - 1) / gridDim.z;
  c_begin = blockIdx.z * per;
  c_end = min(c_begin + per, nchunks);
}

// Sum the 16 warps' partials of this CTA's tile (rows m0 .. m0 + MT, columns
// tile_f0 .. tile_f0 + 32·CPL), then either scale and store them (one
// split) or write them to the workspace, and let the tile's last split sum
// all splits in order, scale and store.
template <typename Acc, int MT, int CPL>
__device__ __forceinline__ void finish(const Acc (&acc)[MT][CPL],
                                       unsigned char* smem, int* last,
                                       Acc* __restrict__ ws,
                                       int* __restrict__ tickets,
                                       const float* __restrict__ scale,
                                       float* __restrict__ out, int m0,
                                       int mn, int M, int F, int warp,
                                       int lane) {
  constexpr int kCols = 32 * CPL;
  constexpr int R = 8 / CPL;            // rows per pass: 16 KB of partials
  static_assert(kWarps * R * kCols * 4 <= kRedBytes, "reduction buffer");
  Acc* red = reinterpret_cast<Acc*>(smem);
  const int tile_f0 = blockIdx.x * kCols;
  const int S = gridDim.z;
#pragma unroll
  for (int mc = 0; mc < MT; mc += R) {
#pragma unroll
    for (int r = 0; r < R; ++r)
      if (mc + r < MT)
#pragma unroll
        for (int c = 0; c < CPL; ++c)
          red[(warp * R + r) * kCols + lane * CPL + c] = acc[mc + r][c];
    __syncthreads();
    for (int e = threadIdx.x; e < R * kCols; e += kThreads) {
      const int r = e / kCols, col = e - r * kCols;
      const int m = mc + r, f = tile_f0 + col;
      if (mc + r < MT && m < mn && f < F) {
        Acc s = 0;
        for (int w = 0; w < kWarps; ++w) s += red[(w * R + r) * kCols + col];
        const size_t o = static_cast<size_t>(m0 + m) * F + f;
        if (S == 1)
          out[o] = static_cast<float>(s) * scale[f];
        else
          ws[static_cast<size_t>(blockIdx.z) * M * F + o] = s;
      }
    }
    __syncthreads();
  }
  if (S == 1) return;
  __threadfence();
  __syncthreads();
  int* ticket = &tickets[blockIdx.y * gridDim.x + blockIdx.x];
  if (threadIdx.x == 0) *last = atomicAdd(ticket, 1) == S - 1;
  __syncthreads();
  if (!*last) return;
  if (threadIdx.x == 0) *ticket = 0;   // every split has taken its ticket
  __threadfence();
  for (int e = threadIdx.x; e < mn * kCols; e += kThreads) {
    const int m = e / kCols, f = tile_f0 + (e - m * kCols);
    if (f >= F) continue;
    const size_t o = static_cast<size_t>(m0 + m) * F + f;
    Acc s = 0;
    for (int z = 0; z < S; ++z)
      s += __ldcg(ws + static_cast<size_t>(z) * M * F + o);
    out[o] = static_cast<float>(s) * scale[f];
  }
}

template <int MT, int CPL, int RG>
__global__ void __launch_bounds__(kThreads)
    w4a16_kernel(const uint16_t* __restrict__ x,   // [M, ldx] bf16 bits
                 const uint8_t* __restrict__ q,    // [D/2, F]
                 const float* __restrict__ scale, float* __restrict__ out,
                 float* __restrict__ ws, int* __restrict__ tickets, int M,
                 int D, int F, int ldx, int vec) {
  constexpr int kChunk = kWarps * RG;              // groups per chunk
  constexpr int kXs = MT * kChunk * 16;            // float4 per (row, group)
  __shared__ __align__(16) unsigned char smem[kXs > kRedBytes ? kXs
                                                               : kRedBytes];
  __shared__ int last;
  float4* xs = reinterpret_cast<float4*>(smem);    // [MT][kChunk]
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int f0 = blockIdx.x * 32 * CPL + lane * CPL;
  const int m0 = blockIdx.y * MT;
  const int mn = min(MT, M - m0);
  const int D2 = D >> 1;                 // packed rows
  const int groups = (D + 3) >> 2;       // groups of 4 rows = 2 packed rows
  int c_begin, c_end;
  split_range((groups + kChunk - 1) / kChunk, c_begin, c_end);
  float acc[MT][CPL];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int c = 0; c < CPL; ++c) acc[m][c] = 0.f;

  uint32_t b[RG][2], nb[RG][2];
  if (c_begin < c_end)
    load_w4<RG, CPL>(nb, q, F, f0, vec, D2, c_begin * kChunk + warp * RG);
  for (int ch = c_begin; ch < c_end; ++ch) {
#pragma unroll
    for (int j = 0; j < RG; ++j) b[j][0] = nb[j][0], b[j][1] = nb[j][1];
    if (ch + 1 < c_end)
      load_w4<RG, CPL>(nb, q, F, f0, vec, D2, (ch + 1) * kChunk + warp * RG);
    for (int u = threadIdx.x; u < mn * kChunk; u += kThreads) {
      const int m = u / kChunk, g = ch * kChunk + (u - m * kChunk);
      xs[u] = g < groups ? bf16x4(__ldg(reinterpret_cast<const uint2*>(
                               x + static_cast<size_t>(m0 + m) * ldx + 4 * g)))
                         : make_float4(0.f, 0.f, 0.f, 0.f);
    }
    __syncthreads();
#pragma unroll
    for (int j = 0; j < RG; ++j) {
      float w[4][CPL];                   // rows 4g .. 4g+3 of each column
#pragma unroll
      for (int c = 0; c < CPL; ++c) {
        w[0][c] = nibble(b[j][0], 8 * c + 4);
        w[1][c] = nibble(b[j][0], 8 * c);
        w[2][c] = nibble(b[j][1], 8 * c + 4);
        w[3][c] = nibble(b[j][1], 8 * c);
      }
      const float4* xg = xs + warp * RG + j;
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        if (m < mn) {
          const float4 v = xg[m * kChunk];
#pragma unroll
          for (int c = 0; c < CPL; ++c) {
            acc[m][c] = fmaf(v.x, w[0][c], acc[m][c]);
            acc[m][c] = fmaf(v.y, w[1][c], acc[m][c]);
            acc[m][c] = fmaf(v.z, w[2][c], acc[m][c]);
            acc[m][c] = fmaf(v.w, w[3][c], acc[m][c]);
          }
        }
      }
    }
    __syncthreads();
  }
  finish<float, MT, CPL>(acc, smem, &last, ws, tickets, scale, out, m0, mn,
                         M, F, warp, lane);
}

// W8A8: as W4A16, with x kept as int8 codes in shared memory (4 per int)
// and one __dp4a per group, row and column; RG is a multiple of 4, so a
// row's x for 4 consecutive groups is one 16-byte shared-memory load.
template <int MT, int CPL, int RG>
__global__ void __launch_bounds__(kThreads)
    w8a8_kernel(const int8_t* __restrict__ x,      // [M, ldx] int8
                const uint8_t* __restrict__ q,     // [D, F] int8 bits
                const float* __restrict__ scale, float* __restrict__ out,
                int* __restrict__ ws, int* __restrict__ tickets, int M,
                int D, int F, int ldx, int vec) {
  static_assert(RG % 4 == 0, "RG must be a multiple of 4");
  constexpr int kChunk = kWarps * RG;
  constexpr int kXs = MT * kChunk * 4;             // int per (row, group)
  __shared__ __align__(16) unsigned char smem[kXs > kRedBytes ? kXs
                                                               : kRedBytes];
  __shared__ int last;
  int* xs = reinterpret_cast<int*>(smem);          // [MT][kChunk]
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int f0 = blockIdx.x * 32 * CPL + lane * CPL;
  const int m0 = blockIdx.y * MT;
  const int mn = min(MT, M - m0);
  const int groups = (D + 3) >> 2;
  int c_begin, c_end;
  split_range((groups + kChunk - 1) / kChunk, c_begin, c_end);
  int acc[MT][CPL];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int c = 0; c < CPL; ++c) acc[m][c] = 0;

  uint32_t b[RG][4], nb[RG][4];
  if (c_begin < c_end)
    load_w8<RG, CPL>(nb, q, F, f0, vec, D, c_begin * kChunk + warp * RG);
  for (int ch = c_begin; ch < c_end; ++ch) {
#pragma unroll
    for (int j = 0; j < RG; ++j)
#pragma unroll
      for (int h = 0; h < 4; ++h) b[j][h] = nb[j][h];
    if (ch + 1 < c_end)
      load_w8<RG, CPL>(nb, q, F, f0, vec, D, (ch + 1) * kChunk + warp * RG);
    for (int u = threadIdx.x; u < mn * kChunk; u += kThreads) {
      const int m = u / kChunk, g = ch * kChunk + (u - m * kChunk);
      xs[u] = g < groups ? __ldg(reinterpret_cast<const int*>(
                               x + static_cast<size_t>(m0 + m) * ldx + 4 * g))
                         : 0;
    }
    __syncthreads();
    int w[RG][4];            // [group][column]: the column's 4 row bytes
#pragma unroll
    for (int j = 0; j < RG; ++j)
      transpose4(b[j][0], b[j][1], b[j][2], b[j][3], w[j]);
#pragma unroll
    for (int m = 0; m < MT; ++m) {
      if (m < mn) {
        const int4* xr = reinterpret_cast<const int4*>(
            xs + m * kChunk + warp * RG);
#pragma unroll
        for (int j = 0; j < RG; j += 4) {
          const int4 v = xr[j / 4];
#pragma unroll
          for (int c = 0; c < CPL; ++c) {
            acc[m][c] = __dp4a(v.x, w[j][c], acc[m][c]);
            acc[m][c] = __dp4a(v.y, w[j + 1][c], acc[m][c]);
            acc[m][c] = __dp4a(v.z, w[j + 2][c], acc[m][c]);
            acc[m][c] = __dp4a(v.w, w[j + 3][c], acc[m][c]);
          }
        }
      }
    }
    __syncthreads();
  }
  finish<int, MT, CPL>(acc, smem, &last, ws, tickets, scale, out, m0, mn, M,
                       F, warp, lane);
}

// The kernel shape of M: rows per CTA, columns per lane, groups per warp
// and chunk (w4, w8).
struct Shape {
  int mt, cpl, rg4, rg8;
};

Shape shape_of(int M) {
  if (M <= 4) return {4, 4, 4, 4};
  return {64, 1, 2, 4};
}

// Splits of D: enough CTAs for kTargetCtas per SM, each split at least one
// chunk of the scheme.
int splits_of(int M, int D, int F, int scheme, int sms) {
  const Shape s = shape_of(M);
  const long tiles = static_cast<long>((F + 32 * s.cpl - 1) / (32 * s.cpl)) *
                     ((M + s.mt - 1) / s.mt);
  const int chunk_rows = 4 * kWarps * (scheme == 0 ? s.rg4 : s.rg8);
  const long chunks = (D + chunk_rows - 1) / chunk_rows;
  const long want = (static_cast<long>(kTargetCtas) * sms + tiles - 1) / tiles;
  return static_cast<int>(want < 1 ? 1 : (want < chunks ? want : chunks));
}

template <int MT, int CPL, int RG4, int RG8>
int launch(int scheme, const void* x, const void* q, const float* scale,
           float* out, void* ws, int* tickets, int M, int D, int F, int ldx,
           int splits, int vec, cudaStream_t stream) {
  const dim3 grid((F + 32 * CPL - 1) / (32 * CPL), (M + MT - 1) / MT,
                  splits);
  if (scheme == 0) {
    w4a16_kernel<MT, CPL, RG4><<<grid, kThreads, 0, stream>>>(
        static_cast<const uint16_t*>(x), static_cast<const uint8_t*>(q),
        scale, out, static_cast<float*>(ws), tickets, M, D, F, ldx, vec);
  } else {
    w8a8_kernel<MT, CPL, RG8><<<grid, kThreads, 0, stream>>>(
        static_cast<const int8_t*>(x), static_cast<const uint8_t*>(q),
        scale, out, static_cast<int*>(ws), tickets, M, D, F, ldx, vec);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// How many splits of D `kvnand_quant_gemv` takes for this call on a card of
// `sms` SMs: the caller sizes the workspace [splits, M, F] (4-byte
// elements) by it.  The tickets (ceil(F / 32) * ceil(M / 4) ints) start at
// zero and every launch leaves them at zero, so one buffer serves every
// launch on a stream.
extern "C" int kvnand_quant_gemv_splits(int M, int D, int F, int scheme,
                                        int sms) {
  return splits_of(M, D, F, scheme, sms);
}

// x [M, ldx] (bf16 for scheme 0 = w4a16, int8 for scheme 1 = w8a8); q
// [D/2, F] uint8 or [D, F] int8; scale [F] f32; out [M, F] f32; ws and
// tickets as above (unused when splits == 1); vec: rows of q may be read as
// 4-byte words (F % 4 == 0 and q 4-byte aligned).  Returns
// cudaGetLastError() after the launch.
extern "C" int kvnand_quant_gemv(const void* x, const void* q,
                                 const void* scale, void* out, void* ws,
                                 void* tickets, int M, int D, int F, int ldx,
                                 int scheme, int splits, int vec,
                                 void* stream) {
  const float* s = static_cast<const float*>(scale);
  float* o = static_cast<float*>(out);
  int* t = static_cast<int*>(tickets);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Shape sh = shape_of(M);
  if (sh.mt == 4)
    return launch<4, 4, 4, 4>(scheme, x, q, s, o, ws, t, M, D, F, ldx,
                              splits, vec, st);
  return launch<64, 1, 2, 4>(scheme, x, q, s, o, ws, t, M, D, F, ldx,
                             splits, vec, st);
}
