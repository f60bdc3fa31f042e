// Quantized GEMV / small GEMM for Hopper (sm_90a), kernel B3.  Replaces the
// TPU kernel `quant_gemv_pallas` of src/repro/kernels/quant_gemv/kernel.py
// (bodies `_kernel_w4` / `_kernel_w8`) and computes what it computes:
//
//   w4a16  out[m, f] = f32( sum_d bf16(x[m, d]) * w4[d, f] ) * scale[f]
//          q [D/2, F] uint8: row 2p in the high nibble, row 2p+1 in the low
//          nibble, offset 8 (weights -8..7); x [M, ldx] bf16, products and
//          sums in float32 (no bf16 rounding of the product).
//   w8a8   out[m, f] = f32( sum_d x8[m, d] * w8[d, f] ) * scale[f]
//          q [D, F] int8, x [M, ldx] int8 (the caller quantized x per token
//          and multiplies by its scale afterwards), int32 sums: exact, so
//          the result does not depend on the order of the sum.
//
// scale [F] float32, out [M, F] float32, q, scale and out contiguous, x rows
// `ldx` elements apart.  Any M >= 1, F >= 1, D >= 1 (even D for w4), any
// alignment of x; the ragged edges are zero-filled inside the kernel.
//
// The product runs on the tensor cores (mma.sync m16n8k16 bf16 -> f32 for
// w4a16, m16n8k32 s8 -> s32 for w8a8) with A and B swapped: out^T = W^T x^T.
// Weight columns take the mma's 16-row side and the rows of x its 8-column
// side, so each 32-bit A register is one packed byte (w4: rows 2p and 2p+1
// of one column, dequantized to a bf16 pair by a byte permute, two LOP3 and
// one bf16x2 FMA: 128 + n has n in its low mantissa bits, minus 136 gives
// n - 8 exactly) or four rows of one column (w8: a byte transpose of four
// 4-column words), and x in its row-major layout is the B operand, read by
// ldmatrix.  Every product of a bf16 x and a w4 in -8..7 is exact in f32,
// so w4a16 computes the TPU kernel's function up to the order of the sum;
// w8a8's int32 sums are exact in any order.
//
// One body, two paths; `kernels/quant_gemv/kernel.py::choose_gemv_plan`
// picks the path, the instance and the splits of D on the host:
//
//   * stream (decode, M up to the crossover, 16): 8 or 16 rows of x a CTA
//     (1-2 n-tiles, the rows past M zero), 4 warps of 32 columns, ring
//     stages of 16 KB of weights (w4 256 rows of D, w8 128) 4 deep, two
//     CTAs an SM.  D is split over CTAs until the grid holds two an SM; the
//     splits' partials meet in a workspace and the last CTA of a tile (a
//     ticket taken with atomicAdd and reset by that CTA) sums them in split
//     order.  Bound, at the long shape, about equally by the weight stream
//     and by the dequant and mma chain of each lane (each alone takes most
//     of the time in a knock-out timing, PERF.md §6);
//   * tile (the 64-row prefill chunk and every M past the crossover): 64
//     rows of x a CTA (8 n-tiles, 64 accumulators a lane), 4 warps, ring
//     stages of 64 rows of D, three CTAs an SM (a register cap of 168).
//     Its D splits (at most 8) form one thread-block cluster: each keeps
//     its partial tile in shared memory and, after a cluster barrier, each
//     sums its share of the rows over the cluster's partials in split order
//     through distributed shared memory (a 64-row workspace pass would be
//     read by one CTA at the rate one SM takes in).  Bound by its loads
//     (the x tile is re-read by every column tile) and its dequant and mma
//     chain in about equal parts.
//
// Common to both: a ring of shared-memory stages filled by 16-byte cp.async
// (zero-fill past D, past F and past M through the copy's source size);
// rows of a weight stage are unpadded and their 16-byte chunks XOR-swizzled
// by row, so the lanes of a warp that read 4 packed rows (w4) or 4 groups
// of 4 rows (w8) of one 32-column strip hit 32 distinct banks; rows of the
// x stage are padded by 16 bytes, so ldmatrix is conflict-free.  A q whose
// rows are not 16-byte aligned (F % 16 != 0) takes byte loads, an x whose
// rows are not 16-byte aligned element loads, into the same ring.  The
// epilogue stages the tile through shared memory, one thread a column, so
// every store is coalesced.  No float atomics: a repeated launch gives the
// same bits.
//
// What it leaves on the table: the dequant and mma of a lane are one
// dependent chain per stage (a wgmma version that waited after each k-step
// pair was slower, PERF.md §6); cp.async issued by every lane, not TMA
// bulk copies from a producer warp; x re-read from L2 by every column tile
// of the tile path (no cluster multicast); and at the serving shape a
// fixed chain of launch, one HBM round trip and the split-D pass.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

namespace cg = cooperative_groups;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// `bytes` (0..16) bytes from global to shared, the rest of the 16 zero
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void mma(int (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Byte J of w (packed rows 2p, 2p+1 of one column) as the bf16 pair (row
// 2p low, row 2p+1 high): the high nibble from w >> 4, the low one from w,
// each OR'ed into bf16 128.0 (0x4300) and 136 subtracted, exactly.
template <int J>
__device__ __forceinline__ uint32_t w4_pair(uint32_t w, uint32_t w_shr4) {
  constexpr uint32_t kSel = J | (J << 4) | ((4 + J) << 8) | ((4 + J) << 12);
  const uint32_t r = (__byte_perm(w_shr4, w, kSel) & 0x000F000Fu) |
                     0x43004300u;
  uint32_t d;
  asm("fma.rn.bf16x2 %0, %1, %2, %3;\n"
      : "=r"(d)
      : "r"(r), "r"(0x3F803F80u), "r"(0xC308C308u));
  return d;
}

// Rows r0..r3 (byte c = column c) -> per column c its 4 row bytes, row 0 in
// the low byte (the byte order of 4 consecutive k of an s8 fragment).
__device__ __forceinline__ void transpose4(uint32_t r0, uint32_t r1,
                                           uint32_t r2, uint32_t r3,
                                           uint32_t (&col)[4]) {
  const uint32_t t0 = __byte_perm(r0, r1, 0x5140);
  const uint32_t t1 = __byte_perm(r2, r3, 0x5140);
  const uint32_t t2 = __byte_perm(r0, r1, 0x7362);
  const uint32_t t3 = __byte_perm(r2, r3, 0x7362);
  col[0] = __byte_perm(t0, t1, 0x5410);
  col[1] = __byte_perm(t0, t1, 0x7632);
  col[2] = __byte_perm(t2, t3, 0x5410);
  col[3] = __byte_perm(t2, t3, 0x7632);
}

// The shapes of one instance.  SCHEME 0 = w4a16, 1 = w8a8; WARPS warps of
// 32 columns each; NT8 n-tiles of 8 rows of x; KC rows of D a ring stage.
template <int SCHEME, int WARPS, int NT8, int KC, int STAGES>
struct Cfg {
  static constexpr int kThreads = 32 * WARPS;
  static constexpr int kCols = 32 * WARPS;              // weight columns
  static constexpr int kRows = 8 * NT8;                 // rows of x
  static constexpr int kWRows = SCHEME == 0 ? KC / 2 : KC;  // q rows a stage
  static constexpr int kXBytes = SCHEME == 0 ? 2 * KC : KC;  // x row bytes
  static constexpr int kXStride = kXBytes + 16;         // padded for ldmatrix
  static constexpr int kWBytes = kWRows * kCols;
  static constexpr int kStage = kWBytes + kRows * kXStride;
  static constexpr int kOutStride = kCols + 4;          // epilogue tile row
  static constexpr int kRing = STAGES * kStage;
  static constexpr int kOut = kRows * kOutStride * 4;
  static constexpr int kSmem = kRing > kOut ? kRing : kOut;
  // mma k-steps of a stage: 32 bytes of an x row each (k16 bf16, k32 s8),
  // taken in pairs (one ldmatrix.x4 per n-tile reads 64 bytes of 8 rows)
  static constexpr int kPairs = kXBytes / 64;
  // independent accumulator sets: with 1-2 n-tiles the mma chain of one
  // accumulator would serialize a stage, so the two k-steps of a pair
  // accumulate apart
  static constexpr int kAcc = NT8 <= 2 ? 2 : 1;
  static_assert(kCols % 128 == 0, "the swizzle needs 8 chunks a row");
  static_assert(kXBytes % 64 == 0, "a stage holds whole k-step pairs");
};

// The swizzle of 16-byte chunk c of weight row R of a stage: w4 lanes t =
// 0..3 read rows 8s + t (and + 4), w8 lanes read rows 32s + 4t + r (and +
// 16): the key separates the four t of a row set.
template <int SCHEME>
__device__ __forceinline__ int swz(int R) {
  return SCHEME == 0 ? (R & 3) << 1 : ((R >> 2) & 3) << 1;
}

struct Args {
  const unsigned char* x;      // [M, ldx] bf16 or int8
  const uint8_t* q;
  const float* scale;
  float* out;
  void* ws;                    // [splits, M, F] partials (f32 or s32)
  int* tickets;
  int M, D, F, ldx;
  int xvec;                    // rows of x 16-byte aligned
  int qvec;                    // rows of q 16-byte aligned
  int cluster;                 // the splits of D form a cluster along z
};

// Issue chunk `ch`'s weight rows and x rows into ring slot `st`.
template <int SCHEME, int WARPS, int NT8, int KC, int STAGES>
__device__ __forceinline__ void load_stage(unsigned char* st, const Args& a,
                                           int ch, int f0, int m0) {
  using C = Cfg<SCHEME, WARPS, NT8, KC, STAGES>;
  constexpr int kChunks = C::kCols / 16;
  const int r0 = ch * C::kWRows;
  const int rows = SCHEME == 0 ? a.D >> 1 : a.D;
  if (a.qvec) {
    for (int e = threadIdx.x; e < C::kWRows * kChunks; e += C::kThreads) {
      const int R = e / kChunks, c = e - R * kChunks;
      const int row = r0 + R, f = f0 + 16 * c;
      const int n = row < rows ? min(max(a.F - f, 0), 16) : 0;
      cp_async16(smem_u32(st + R * C::kCols + ((c ^ swz<SCHEME>(R)) << 4)),
                 n ? a.q + static_cast<size_t>(row) * a.F + f : a.q, n);
    }
  } else {
    for (int e = threadIdx.x; e < C::kWRows * C::kCols; e += C::kThreads) {
      const int R = e / C::kCols, col = e - R * C::kCols;
      const int row = r0 + R, f = f0 + col;
      st[R * C::kCols + (((col >> 4) ^ swz<SCHEME>(R)) << 4) + (col & 15)] =
          row < rows && f < a.F
              ? __ldg(a.q + static_cast<size_t>(row) * a.F + f)
              : 0;
    }
  }
  unsigned char* xs = st + C::kWBytes;
  constexpr int kEs = SCHEME == 0 ? 2 : 1;            // bytes an element
  const int k0 = ch * C::kXBytes;                     // byte offset in a row
  const int row_bytes = a.D * kEs;
  const size_t ld_bytes = static_cast<size_t>(a.ldx) * kEs;
  if (a.xvec) {
    constexpr int kXChunks = C::kXBytes / 16;
    for (int e = threadIdx.x; e < C::kRows * kXChunks; e += C::kThreads) {
      const int m = e / kXChunks, c = e - m * kXChunks;
      const int off = k0 + 16 * c;
      const int n = m0 + m < a.M ? min(max(row_bytes - off, 0), 16) : 0;
      cp_async16(smem_u32(xs + m * C::kXStride + 16 * c),
                 n ? a.x + (m0 + m) * ld_bytes + off : a.x, n);
    }
  } else {
    constexpr int kXElems = C::kXBytes / kEs;
    for (int e = threadIdx.x; e < C::kRows * kXElems; e += C::kThreads) {
      const int m = e / kXElems, k = e - m * kXElems;
      const int d = ch * KC + k;
      const bool in = m0 + m < a.M && d < a.D;
      const unsigned char* src = a.x + (m0 + m) * ld_bytes + d * kEs;
      if (SCHEME == 0)
        *reinterpret_cast<uint16_t*>(xs + m * C::kXStride + 2 * k) =
            in ? __ldg(reinterpret_cast<const uint16_t*>(src)) : 0;
      else
        xs[m * C::kXStride + k] = in ? __ldg(src) : 0;
    }
  }
}

// One warp's products over ring slot `st`: its 32 columns (2 m-tiles of
// 16) x the CTA's NT8 n-tiles of x.  Column mapping: lane (g, t) reads the
// 4-byte word of columns 4g .. 4g+3 of its strip; byte 2h + i of it is
// row g + 8h of m-tile i.
template <int SCHEME, int WARPS, int NT8, int KC, int STAGES, typename Acc>
__device__ __forceinline__ void compute_stage(
    const unsigned char* st, Acc (&acc)[Cfg<SCHEME, WARPS, NT8, KC,
                                            STAGES>::kAcc][2][NT8][4],
    int warp, int lane) {
  using C = Cfg<SCHEME, WARPS, NT8, KC, STAGES>;
  const int g = lane >> 2, t = lane & 3;
  const int cw = 2 * warp + (g >> 2);                  // the word's chunk
  const int within = 4 * (g & 3);
  const uint32_t xrow = smem_u32(st + C::kWBytes + (lane & 7) * C::kXStride +
                                 (lane >> 3) * 16);
#pragma unroll
  for (int p = 0; p < C::kPairs; ++p) {
    uint32_t a[2][2][4];                               // [k-step][m-tile]
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      const int ks = 2 * p + s;
      if (SCHEME == 0) {
        // packed rows 8ks + t (k 2t, 2t+1) and 8ks + 4 + t (k 8 + 2t, ...)
        const int R = 8 * ks + t;
        const unsigned char* base = st + ((cw ^ (2 * t)) << 4) + within;
        const uint32_t lo = *reinterpret_cast<const uint32_t*>(
            base + R * C::kCols);
        const uint32_t hi = *reinterpret_cast<const uint32_t*>(
            base + (R + 4) * C::kCols);
        const uint32_t lo4 = lo >> 4, hi4 = hi >> 4;
        a[s][0][0] = w4_pair<0>(lo, lo4);
        a[s][0][1] = w4_pair<2>(lo, lo4);
        a[s][0][2] = w4_pair<0>(hi, hi4);
        a[s][0][3] = w4_pair<2>(hi, hi4);
        a[s][1][0] = w4_pair<1>(lo, lo4);
        a[s][1][1] = w4_pair<3>(lo, lo4);
        a[s][1][2] = w4_pair<1>(hi, hi4);
        a[s][1][3] = w4_pair<3>(hi, hi4);
      } else {
        // rows 32ks + 4t + r (k 4t .. 4t+3) and 32ks + 16 + 4t + r
        const unsigned char* base = st + ((cw ^ (2 * t)) << 4) + within;
        uint32_t w[2][4], col[2][4];
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int r = 0; r < 4; ++r)
            w[h][r] = *reinterpret_cast<const uint32_t*>(
                base + (32 * ks + 16 * h + 4 * t + r) * C::kCols);
#pragma unroll
        for (int h = 0; h < 2; ++h)
          transpose4(w[h][0], w[h][1], w[h][2], w[h][3], col[h]);
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          a[s][i][0] = col[0][i];
          a[s][i][1] = col[0][2 + i];
          a[s][i][2] = col[1][i];
          a[s][i][3] = col[1][2 + i];
        }
      }
    }
    // the n-tiles in groups of up to 4: the group's B first, then its
    // mmas in an order where 2·group independent ones separate two on the
    // same accumulator (a warp issues in order)
    constexpr int kG = NT8 < 4 ? NT8 : 4;
#pragma unroll
    for (int n0 = 0; n0 < NT8; n0 += kG) {
      uint32_t b[kG][4];
#pragma unroll
      for (int j = 0; j < kG; ++j)
        ldmatrix_x4(xrow + (n0 + j) * 8 * C::kXStride + p * 64, b[j]);
#pragma unroll
      for (int s = 0; s < 2; ++s)
#pragma unroll
        for (int j = 0; j < kG; ++j)
#pragma unroll
          for (int i = 0; i < 2; ++i)
            mma(acc[s % C::kAcc][i][n0 + j], a[s][i], b[j][2 * s],
                b[j][2 * s + 1]);
    }
  }
}

template <int SCHEME, int WARPS, int NT8, int KC, int STAGES, int CTAS>
__global__ void __launch_bounds__(32 * WARPS, CTAS)
    gemv_kernel(const Args a) {
  using C = Cfg<SCHEME, WARPS, NT8, KC, STAGES>;
  using Acc = typename std::conditional<SCHEME == 0, float, int>::type;
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ int last;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int f0 = blockIdx.x * C::kCols;
  const int m0 = blockIdx.y * C::kRows;
  const int nchunks = (a.D + KC - 1) / KC;
  const int per = (nchunks + gridDim.z - 1) / gridDim.z;
  const int c_begin = blockIdx.z * per;
  const int n = max(min(c_begin + per, nchunks) - c_begin, 0);

  Acc acc[C::kAcc][2][NT8][4];
#pragma unroll
  for (int s = 0; s < C::kAcc; ++s)
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int nt = 0; nt < NT8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[s][i][nt][e] = 0;

  // the ring: STAGES - 1 chunks in flight ahead of the one computed; the
  // slot refilled at step i is the one computed at step i - 1, which every
  // warp has left by the barrier
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < n)
      load_stage<SCHEME, WARPS, NT8, KC, STAGES>(smem + s * C::kStage, a,
                                                 c_begin + s, f0, m0);
    cp_async_commit();
  }
  for (int i = 0; i < n; ++i) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    const int nx = i + STAGES - 1;
    if (nx < n)
      load_stage<SCHEME, WARPS, NT8, KC, STAGES>(
          smem + (nx % STAGES) * C::kStage, a, c_begin + nx, f0, m0);
    cp_async_commit();
    compute_stage<SCHEME, WARPS, NT8, KC, STAGES, Acc>(
        smem + (i % STAGES) * C::kStage, acc, warp, lane);
  }
  cp_async_wait<0>();
  __syncthreads();

  // the tile's sums [kRows][kCols] through shared memory: fragment (i, nt,
  // e) of lane (g, t) is column 4g + 2(e >> 1) + i of the warp's strip and
  // row 8nt + 2t + (e & 1)
  Acc* ot = reinterpret_cast<Acc*>(smem);
  {
    const int g = lane >> 2, t = lane & 3;
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int nt = 0; nt < NT8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          Acc v = acc[0][i][nt][e];
#pragma unroll
          for (int s = 1; s < C::kAcc; ++s) v += acc[s][i][nt][e];
          ot[(8 * nt + 2 * t + (e & 1)) * C::kOutStride + 32 * warp + 4 * g +
             2 * (e >> 1) + i] = v;
        }
  }
  __syncthreads();
  // lane-for-column: thread c owns column f0 + c of every row of the tile
  // (kThreads == kCols), so its stores are coalesced across the CTA and the
  // last split's loads of all rows are in flight together
  static_assert(C::kThreads == C::kCols, "one thread a column");
  const int f = f0 + threadIdx.x;
  const int mn = min(C::kRows, a.M - m0);
  const int S = gridDim.z;
  Acc* ws = static_cast<Acc*>(a.ws);
  const size_t MF = static_cast<size_t>(a.M) * a.F;
  const size_t o0 = static_cast<size_t>(m0) * a.F + f;
  if (f < a.F) {
    const float sc = a.scale[f];
#pragma unroll
    for (int r = 0; r < C::kRows; ++r) {
      if (r >= mn) break;
      const Acc v = ot[r * C::kOutStride + threadIdx.x];
      if (S == 1)
        a.out[o0 + static_cast<size_t>(r) * a.F] = static_cast<float>(v) * sc;
      else if (!a.cluster)
        ws[blockIdx.z * MF + o0 + static_cast<size_t>(r) * a.F] = v;
    }
  }
  if (S == 1) return;
  if (a.cluster) {
    // the S splits of this tile are one cluster: rank z sums its share of
    // the rows over every rank's shared-memory partial, in split order
    cg::cluster_group cluster = cg::this_cluster();
    cluster.sync();                     // every rank's partial is staged
    const int rank = static_cast<int>(cluster.block_rank());
    const int per = (mn + S - 1) / S;
    const int r1 = min(mn, (rank + 1) * per);
    if (f < a.F) {
      const float sc = a.scale[f];
      for (int r = rank * per; r < r1; ++r) {
        Acc sum = 0;
        for (int z = 0; z < S; ++z)
          sum += cluster.map_shared_rank(ot, z)[r * C::kOutStride +
                                                threadIdx.x];
        a.out[o0 + static_cast<size_t>(r) * a.F] =
            static_cast<float>(sum) * sc;
      }
    }
    cluster.sync();                     // no rank leaves while it is read
    return;
  }
  __threadfence();
  __syncthreads();
  int* ticket = &a.tickets[blockIdx.y * gridDim.x + blockIdx.x];
  if (threadIdx.x == 0) last = atomicAdd(ticket, 1) == S - 1;
  __syncthreads();
  if (!last) return;
  if (threadIdx.x == 0) *ticket = 0;   // every split has taken its ticket
  __threadfence();
  if (f >= a.F) return;
  Acc sum[C::kRows];
#pragma unroll
  for (int r = 0; r < C::kRows; ++r) sum[r] = 0;
  for (int z = 0; z < S; ++z)
#pragma unroll
    for (int r = 0; r < C::kRows; ++r)
      if (r < mn)
        sum[r] += __ldcg(ws + z * MF + o0 + static_cast<size_t>(r) * a.F);
  const float sc = a.scale[f];
#pragma unroll
  for (int r = 0; r < C::kRows; ++r)
    if (r < mn)
      a.out[o0 + static_cast<size_t>(r) * a.F] =
          static_cast<float>(sum[r]) * sc;
}

template <int SCHEME, int WARPS, int NT8, int KC, int STAGES, int CTAS>
int launch(const Args& a, int splits, cudaStream_t stream) {
  using C = Cfg<SCHEME, WARPS, NT8, KC, STAGES>;
  auto kernel = gemv_kernel<SCHEME, WARPS, NT8, KC, STAGES, CTAS>;
  static bool attr_set = false;   // one attribute call per instance
  if (!attr_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::kSmem);
    if (e != cudaSuccess) return static_cast<int>(e);
    attr_set = true;
  }
  const dim3 grid((a.F + C::kCols - 1) / C::kCols,
                  (a.M + C::kRows - 1) / C::kRows, splits);
  if (!a.cluster || splits == 1) {
    kernel<<<grid, C::kThreads, C::kSmem, stream>>>(a);
    return static_cast<int>(cudaGetLastError());
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(C::kThreads, 1, 1);
  cfg.dynamicSmemBytes = C::kSmem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = splits;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, kernel, a);
  return static_cast<int>(e != cudaSuccess ? e : cudaGetLastError());
}

}  // namespace

// x [M, ldx] (bf16 for scheme 0 = w4a16, int8 for scheme 1 = w8a8); q
// [D/2, F] uint8 or [D, F] int8; scale [F] f32; out [M, F] f32.  The
// instance (warps, rows = 8 x n-tiles, kc, stages, CTAs an SM), the splits
// of D and whether they form a cluster come from `choose_gemv_plan`; ws
// [splits, M, F] 4-byte partials and tickets (one int per column tile x
// row tile, zero, and left at zero) serve the splits that do not, and are
// unused otherwise.  xvec: x and ldx·element size 16-byte aligned; qvec: q
// 16-byte aligned and F % 16 == 0.  Returns cudaGetLastError() after the
// launch, cudaErrorInvalidValue (1) for an instance that is not compiled.
extern "C" int kvnand_quant_gemv(const void* x, const void* q,
                                 const void* scale, void* out, void* ws,
                                 void* tickets, int M, int D, int F, int ldx,
                                 int scheme, int warps, int rows, int kc,
                                 int stages, int ctas, int splits,
                                 int cluster, int xvec, int qvec,
                                 void* stream) {
  const Args a{static_cast<const unsigned char*>(x),
               static_cast<const uint8_t*>(q),
               static_cast<const float*>(scale),
               static_cast<float*>(out),
               ws,
               static_cast<int*>(tickets),
               M, D, F, ldx, xvec, qvec, cluster};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define B3_INSTANCE(S, W, R, K, ST, CTAS)                              \
  if (scheme == S && warps == W && rows == R && kc == K && stages == ST && \
      ctas == CTAS)                                                       \
    return launch<S, W, R / 8, K, ST, CTAS>(a, splits, st);
  // stream path (8 or 16 rows), tile path (64 rows)
  B3_INSTANCE(0, 4, 8, 256, 4, 2)
  B3_INSTANCE(0, 4, 16, 256, 4, 2)
  B3_INSTANCE(0, 4, 64, 64, 4, 3)
  B3_INSTANCE(1, 4, 8, 128, 4, 2)
  B3_INSTANCE(1, 4, 16, 128, 4, 2)
  B3_INSTANCE(1, 4, 64, 64, 4, 3)
#undef B3_INSTANCE
  return static_cast<int>(cudaErrorInvalidValue);
}
