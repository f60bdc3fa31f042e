// Paged decode attention for Hopper (sm_90a): one kernel body, two page
// layouts.  Included by paged_attention.cu (the per-slot stripe layout) and
// paged_attention_shared.cu (the shared pool reached through page tables);
// each source is built into its own library by its own nvcc process.
//
// Replaces the TPU kernels `paged_attention_pallas` (stripe, kernel B1) and
// `paged_attention_pallas_shared` (shared pool, kernel B2) of
// src/repro/kernels/paged_attention/kernel.py (bodies `_kernel` /
// `_kernel_shared`, loaders `_load_pages` / `_load_page_shared`).  Both
// compute the same function: one query token per slot and kv head (a group
// of G <= 8 query heads) against the slot's pages, online softmax in
// float32, kv8/kv4 dequant fused (the K scale multiplies the scores after
// the QK dot, the V scale multiplies p before the PV dot), validity derived
// from page_base / length / window, and locally normalized partials
// (o, m, l) per caller partition of the page walk for the caller's LSE
// merge.  The two layouts differ only in where a page's bytes live, which
// is the `Walk` policy:
//
//   StripeWalk  k, v [B, Kp, NP, Ts, DH], scales [B, Kp, NP]: logical page
//               j of the (b, k) walk is page j of the (b, k0 + k) stripe.
//               A launch may cover a range of the pool's Kp kv heads,
//               [k0, k0 + K): one head group of the discrete variant
//               (KVNAND-D) walks its heads of the layer's whole pool in
//               place, addressed with the pool's own strides, so no
//               narrowed copy of the pool is made.
//   TableWalk   k, v [K, P_total, Ts, DH], scales [K, P_total], table
//               [B, NP]: logical page j sits on physical page table[b, j].
//
// (Ts = T, except kv4: Ts = T/2, token 2i in the high nibble and 2i+1 in
// the low nibble of one packed row, offset 8.)  Other layouts (contiguous):
//   q      [B, K, G, DH] float32 (unscaled; K = the heads of the launch)
//   base   [B, NP] int32: absolute position of each (logical) page's slot
//          0, < 0 = unwritten; length [B] int32
//   o      [B, K, P, G, DH] float32, m / l [B, K, P, G] float32
// DH is 32, 64, 112, 128, 160 or 256 (in PV a lane owns the head dims
// (32j + lane)·VE + e, VE = 4 bytes' worth; past a multiple of 32·VE the
// upper lanes are masked).
//
// What bounds it: decode attention does ~4 flops per KV byte (bf16), far
// below the card's ~295 flops/byte balance point, so the floor is the KV
// bytes streamed from HBM: each valid token's K and V read once.  At small
// batch the floor is a few microseconds, so what the card actually waits
// on is latency: how many dependent memory round trips a walk takes, and
// how many SMs it keeps busy.  This design:
//
//   * Splits every caller partition (p, k, b) over a thread-block cluster
//     of S CTAs (S in {1, 2, 4, 8}, chosen by the host from the grid size
//     and the walk's length).  The grid is (S·P, K, B) with cluster dims
//     (S, 1, 1); cluster rank r walks the r-th contiguous share of the
//     partition's pages, reduces it to (o, m, l) in its shared memory, and
//     after cluster.sync() the S ranks merge the S partials by
//     log-sum-exp through distributed shared memory, each rank writing
//     its share of the output elements.  No extra launch, no global
//     scratch; a rank whose pages are all masked contributes weight 0.
//   * Stages page metadata once: each CTA reads the page bases (and, in
//     the table walk, the table entries) of up to kPageChunk pages of its
//     range in one coalesced load, resolves each valid page's storage
//     offset and scales, and marks fully masked pages with offset -1.  A
//     masked page's table entry is read (it lies inside the table) but
//     never used as an address, so stale entries past `length` are
//     harmless.
//   * Moves K and V by cp.async, 16 bytes a lane, neighbouring lanes on
//     neighbouring addresses of a page's contiguous rows, into padded
//     shared-memory tiles (an odd number of 16-byte chunks a row, so the
//     lane-per-token reads of the QK step hit distinct banks).  Each warp
//     owns a ring of kStages tiles (32 tokens of K and of V each): tile
//     i+kStages is in flight while tile i is computed, so a tile costs one
//     memory round trip and the walk keeps several in flight.  Rows of
//     masked tokens are zero-filled without a global read (cp.async with
//     src-size 0); a tile with no valid token is skipped and costs no K/V
//     bytes.
//   * Computes from shared memory: QK with one lane per token (16-byte
//     row reads, q broadcast from shared memory), a per-warp online
//     softmax (warp shuffles), p staged in shared memory and read back as
//     broadcasts by the PV step, which gives each lane 4 bytes of each V
//     row (1-4 head dims) per load.  Warps merge by log-sum-exp in shared
//     memory, then the
//     cluster merges its ranks.  Tensor cores stay out: ~4 flops a byte
//     leave them nothing to do.
//   * Takes the warps a CTA runs from the tile size: 8 warps where eight
//     rings fit in ~160 KB (bf16/kv8/kv4 at DH 64), fewer for wide rows;
//     one CTA an SM, which the host's choice of S keeps the grid to.
//
// Masking follows the reference exactly: NEG_INF is the finite -1e30, an
// all-masked partial comes out as o = 0, m = -1e30, l = 0 (never NaN), and
// the output divides by max(l, 1e-30).

#pragma once

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace kvnand {

namespace cg = cooperative_groups;

constexpr float kNegInf = -1e30f;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kTile = 32;            // tokens a tile: one lane each in QK
constexpr int kStages = 2;           // tiles a warp keeps in flight
constexpr int kPageChunk = 256;      // pages whose metadata a CTA stages
constexpr int kTileBudget = 160 * 1024;  // tile-ring bytes a CTA aims at
constexpr int kMaxWarps = 8;
constexpr int kMaxSplit = 8;

enum Fmt { kF32 = 0, kBF16 = 1, kKV8 = 2, kKV4 = 3 };

// Shapes that follow from the pool format and the head dim.
template <int FMT, int DH>
struct Geo {
  static constexpr bool kQuant = FMT == kKV8 || FMT == kKV4;
  static constexpr int kEB = FMT == kF32 ? 4 : (FMT == kBF16 ? 2 : 1);
  static constexpr int kTPR = FMT == kKV4 ? 2 : 1;   // tokens a stored row
  static constexpr int kEPC = 16 / kEB;              // elements a chunk
  static constexpr int kRowBytes = DH * kEB;
  static constexpr int kChunks = kRowBytes / 16;     // 16-byte chunks a row
  // padded shared-memory row: an odd number of 16-byte chunks
  static constexpr int kRS = kRowBytes + (kChunks % 2 == 0 ? 16 : 0);
  static constexpr int kRows = kTile / kTPR;         // stored rows a tile
  static constexpr int kTileBytes = kRows * kRS;     // K (or V) of a tile
  static constexpr int kWarpBytes = kStages * 2 * kTileBytes;
  static constexpr int kFit = kTileBudget / kWarpBytes;   // rings that fit
  static constexpr int kWarps = kFit >= kMaxWarps ? kMaxWarps
                                : kFit >= 4 ? 4 : (kFit >= 2 ? 2 : 1);
  static constexpr int kThreads = kWarps * 32;
  // PV: a lane loads 4 bytes of a V row at once, kVE head dims
  static constexpr int kVE = 4 / kEB;
  static constexpr int kDJ = (DH + 32 * kVE - 1) / (32 * kVE);  // loads
  static constexpr int kDA = kDJ * kVE;              // accumulators a row
  static_assert(kRowBytes % 16 == 0, "rows must be whole 16-byte chunks");
};

// Dynamic shared memory, byte offsets.  The warps' merge scratch aliases
// the tile rings once the walk is done.
template <int FMT, int DH, int GM>
struct Smem {
  using Gm = Geo<FMT, DH>;
  static constexpr int kNW = Gm::kWarps;
  static constexpr int kTiles = 0;
  static constexpr int kOfs = kNW * Gm::kWarpBytes;            // long[kPageChunk]
  static constexpr int kQ = kOfs + 8 * kPageChunk;             // float[GM][DH]
  static constexpr int kP = kQ + 4 * GM * DH;                  // float[NW][GM][kTile]
  static constexpr int kCacc = kP + 4 * kNW * GM * kTile;      // float[GM][DH]
  static constexpr int kBase = kCacc + 4 * GM * DH;            // int[kPageChunk]
  static constexpr int kKs = kBase + 4 * kPageChunk;           // float[kPageChunk]
  static constexpr int kVs = kKs + 4 * kPageChunk;             // float[kPageChunk]
  static constexpr int kCm = kVs + 4 * kPageChunk;             // float[GM]
  static constexpr int kCl = kCm + 4 * GM;                     // float[GM]
  static constexpr int kBytes = kCl + 4 * GM;
  // merge scratch: wm, wl [NW][GM], wacc [NW][GM][DH]
  static constexpr int kScratch = 4 * kNW * GM * (DH + 2);
  static_assert(kScratch <= kOfs, "merge scratch must fit in the tiles");
  static_assert(kBytes <= 227 * 1024, "over the 227 KB a CTA can use");
};

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

// 16 bytes global -> shared; src_bytes = 0 zero-fills without a read
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// 4 bytes of a stored row as 4 / kEB float codes (unscaled); `odd` picks
// the low nibble (kv4: the token is the second of its pair).
template <int FMT>
__device__ __forceinline__ void decode4(uint32_t w, bool odd, float* out) {
  if (FMT == kF32) {
    out[0] = __uint_as_float(w);
  } else if (FMT == kBF16) {
    out[0] = __uint_as_float(w << 16);
    out[1] = __uint_as_float(w & 0xffff0000u);
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const uint32_t c = (w >> (8 * j)) & 0xffu;
      if (FMT == kKV8)
        out[j] = static_cast<float>(static_cast<int8_t>(c));
      else
        out[j] = static_cast<float>(
            static_cast<int>(odd ? (c & 0xfu) : (c >> 4)) - 8);
    }
  }
}

// One 16-byte chunk of a stored row as kEPC float codes.
template <int FMT>
__device__ __forceinline__ void decode16(const uint4& u, bool odd,
                                         float* out) {
  constexpr int kPerWord = FMT == kF32 ? 1 : (FMT == kBF16 ? 2 : 4);
  decode4<FMT>(u.x, odd, out);
  decode4<FMT>(u.y, odd, out + kPerWord);
  decode4<FMT>(u.z, odd, out + 2 * kPerWord);
  decode4<FMT>(u.w, odd, out + 3 * kPerWord);
}

// ---- page-address policies ------------------------------------------------
// entry(): what the walk reads per page beside the page base (the table
// entry; nothing for a stripe); offset(): element offset of a VALID page's
// first storage row; scale(): its scale index.

template <int FMT, int DH>
struct StripeWalk {
  long page0, scale0, page_elems;
  __device__ StripeWalk(const int* /*table*/, int b, int k, int Kp, int NP,
                        int Ts, long /*P_total*/)
      : page0((static_cast<long>(b) * Kp + k) * NP),
        scale0((static_cast<long>(b) * Kp + k) * NP),
        page_elems(static_cast<long>(Ts) * DH) {}
  __device__ __forceinline__ int entry(int /*page*/) const { return 0; }
  __device__ __forceinline__ long offset(int page, int /*entry*/) const {
    return (page0 + page) * page_elems;
  }
  __device__ __forceinline__ long scale(int page, int /*entry*/) const {
    return scale0 + page;
  }
};

template <int FMT, int DH>
struct TableWalk {
  const int* table_b;
  long k0, page_elems;
  __device__ TableWalk(const int* table, int b, int k, int /*K*/, int NP,
                       int Ts, long P_total)
      : table_b(table + static_cast<long>(b) * NP),
        k0(static_cast<long>(k) * P_total),
        page_elems(static_cast<long>(Ts) * DH) {}
  __device__ __forceinline__ int entry(int page) const {
    return table_b[page];
  }
  __device__ __forceinline__ long offset(int /*page*/, int entry) const {
    return (k0 + entry) * page_elems;
  }
  __device__ __forceinline__ long scale(int /*page*/, int entry) const {
    return k0 + entry;
  }
};

// The walk state of one warp: its online softmax (m warp-wide, l this
// lane's share of the sum, reduced once at the end) and output
// accumulator (this lane's DA head dims of each query row).
template <int DA, int GM>
struct WarpAcc {
  float m[GM], l[GM], acc[GM][DA];
};

// What a warp's tile steps read: the staged page metadata of the current
// round, q, its p row and tile ring, the pools.
struct Walker {
  const long* ofs_s;        // element offset of each page's first row, -1
  const int* base_s;        // page bases
  const float* ks_s;        // K / V scales of each page (kv8/kv4)
  const float* vs_s;
  const float* q_s;         // scaled q [GM][DH]
  float* my_p;              // the warp's p [GM][kTile]
  unsigned char* my_tiles;  // the warp's ring: kStages x (K tile, V tile)
  const unsigned char* kbytes;
  const unsigned char* vbytes;
  int ntok, T, len, window, lane;

  // token slot `tok` of the round: valid?  `page` = its page in the round
  __device__ __forceinline__ bool valid(int tok, int& page) const {
    page = 0;
    if (tok >= ntok) return false;
    page = tok / T;
    if (ofs_s[page] < 0) return false;
    const int pos = base_s[page] + (tok - page * T);
    return pos < len && (window < 0 || pos > len - 1 - window);
  }
};

// Issue tile j's K and V rows into ring slot `slot`: one cp.async of 16
// bytes a lane and chunk, neighbouring lanes on neighbouring addresses;
// rows of masked tokens zero-filled without a read, a tile without a
// valid token skipped.
template <int FMT, int DH>
__device__ __forceinline__ void issue_tile(const Walker& c, int j,
                                           int slot) {
  using Gm = Geo<FMT, DH>;
  constexpr int TPR = Gm::kTPR;
  const int t0 = j * kTile;
  long rofs = -1;                     // lane r < kRows: stored row r
  if (c.lane < Gm::kRows) {
    bool live = false;
    int page = 0;
#pragma unroll
    for (int u = 0; u < TPR; ++u) {
      int pg;
      live |= c.valid(t0 + c.lane * TPR + u, pg);
      if (u == 0) page = pg;
    }
    if (live)
      rofs = c.ofs_s[page] +
             static_cast<long>((t0 + c.lane * TPR - page * c.T) / TPR) * DH;
  }
  if (__ballot_sync(kFull, rofs >= 0) == 0u) return;   // costs no bytes
  unsigned char* kd = c.my_tiles + slot * 2 * Gm::kTileBytes;
  unsigned char* vd = kd + Gm::kTileBytes;
  constexpr int total = Gm::kRows * Gm::kChunks;
#pragma unroll 4
  for (int c00 = 0; c00 < total; c00 += 32) {
    const int ch = c00 + c.lane;
    const int r = min(ch / Gm::kChunks, Gm::kRows - 1);
    const long ro = __shfl_sync(kFull, rofs, r);
    if (ch < total) {
      const int col = ch - r * Gm::kChunks;
      const bool ok = ro >= 0;
      const long src = ok ? ro * Gm::kEB + col * 16 : 0;
      cp_async16(kd + r * Gm::kRS + col * 16, c.kbytes + src, ok ? 16 : 0);
      cp_async16(vd + r * Gm::kRS + col * 16, c.vbytes + src, ok ? 16 : 0);
    }
  }
}

// s[g] += q[g] · (16-byte chunk `ch` of the K row at `krow`).
template <int FMT, int DH, int GM>
__device__ __forceinline__ void qk_chunk(const unsigned char* krow, int ch,
                                         bool odd, const float* q_s,
                                         float (&s)[GM]) {
  constexpr int EPC = Geo<FMT, DH>::kEPC;
  float kv[EPC];
  decode16<FMT>(*reinterpret_cast<const uint4*>(krow + ch * 16), odd, kv);
#pragma unroll
  for (int g = 0; g < GM; ++g) {
#pragma unroll
    for (int e = 0; e < EPC; e += 4) {
      const float4 qv =
          *reinterpret_cast<const float4*>(q_s + g * DH + ch * EPC + e);
      s[g] = fmaf(qv.x, kv[e], s[g]);
      s[g] = fmaf(qv.y, kv[e + 1], s[g]);
      s[g] = fmaf(qv.z, kv[e + 2], s[g]);
      s[g] = fmaf(qv.w, kv[e + 3], s[g]);
    }
  }
}

// Fold tile j (in ring slot `slot`) into the warp's online softmax: QK
// with one lane per token, p through shared memory, PV with one lane per
// head-dim slice.
template <int FMT, int DH, int GM>
__device__ __forceinline__ void compute_tile(
    const Walker& c, WarpAcc<Geo<FMT, DH>::kDA, GM>& w, int j, int slot) {
  using Gm = Geo<FMT, DH>;
  constexpr int TPR = Gm::kTPR, RS = Gm::kRS;
  constexpr int DJ = Gm::kDJ, VE = Gm::kVE, DA = Gm::kDA;
  const int lane = c.lane;
  int page;
  const bool valid = c.valid(j * kTile + lane, page);
  const unsigned vmask = __ballot_sync(kFull, valid);
  if (vmask == 0u) return;
  const unsigned char* kt = c.my_tiles + slot * 2 * Gm::kTileBytes;
  const unsigned char* vt = kt + Gm::kTileBytes;
  const bool odd = FMT == kKV4 && (lane & 1);
  // two partial sums a row (even / odd chunks): half the FMA chain
  float s[GM], s_odd[GM];
#pragma unroll
  for (int g = 0; g < GM; ++g) s[g] = s_odd[g] = 0.f;
  const unsigned char* krow = kt + (lane / TPR) * RS;
#pragma unroll 2
  for (int ch = 0; ch < Gm::kChunks; ch += 2) {
    qk_chunk<FMT, DH, GM>(krow, ch, odd, c.q_s, s);
    if (ch + 1 < Gm::kChunks)
      qk_chunk<FMT, DH, GM>(krow, ch + 1, odd, c.q_s, s_odd);
  }
#pragma unroll
  for (int g = 0; g < GM; ++g) s[g] += s_odd[g];
  const float kscale = Gm::kQuant ? c.ks_s[page] : 1.f;
  const float vscale = Gm::kQuant ? c.vs_s[page] : 1.f;
  // online softmax over the tile, per query row; p to shared memory
#pragma unroll
  for (int g = 0; g < GM; ++g) {
    const float sg = valid ? s[g] * kscale : kNegInf;
    const float m_new = fmaxf(w.m[g], warp_max(sg));
    const float pg = valid ? expf(sg - m_new) : 0.f;
    const float alpha = expf(w.m[g] - m_new);
    w.l[g] = w.l[g] * alpha + pg;
#pragma unroll
    for (int a = 0; a < DA; ++a) w.acc[g][a] *= alpha;
    w.m[g] = m_new;
    c.my_p[g * kTile + lane] = pg * vscale;
  }
  __syncwarp();
  // PV: lane owns head dims (32·jj + lane)·VE + e, one 4-byte load of
  // each V row for VE of them; p read back as broadcasts
#pragma unroll 2
  for (int t4 = 0; t4 < kTile; t4 += 4) {
    if (((vmask >> t4) & 0xfu) == 0u) continue;       // warp-uniform
    float4 pw[GM];
#pragma unroll
    for (int g = 0; g < GM; ++g)
      pw[g] = *reinterpret_cast<const float4*>(c.my_p + g * kTile + t4);
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int t = t4 + u;
      const unsigned char* vrow = vt + (t / TPR) * RS;
      const bool vodd = FMT == kKV4 && (t & 1);
#pragma unroll
      for (int jj = 0; jj < DJ; ++jj) {
        const int d0 = (jj * 32 + lane) * VE;
        if (DH % (32 * VE) == 0 || d0 < DH) {
          float v[VE];
          decode4<FMT>(*reinterpret_cast<const uint32_t*>(vrow + d0 * Gm::kEB),
                       vodd, v);
#pragma unroll
          for (int g = 0; g < GM; ++g) {
            const float pgt = u == 0   ? pw[g].x
                              : u == 1 ? pw[g].y
                              : u == 2 ? pw[g].z
                                       : pw[g].w;
#pragma unroll
            for (int e = 0; e < VE; ++e)
              w.acc[g][jj * VE + e] = fmaf(pgt, v[e], w.acc[g][jj * VE + e]);
          }
        }
      }
    }
  }
}

// Cluster of S CTAs per (partition p, kv head k, slot b); GM >= G is the
// compile-time bound on the query group (rows g >= G are zero and never
// written out).
template <int FMT, int DH, int GM, class Walk>
__global__ void __launch_bounds__(Geo<FMT, DH>::kThreads)
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
                       int K, int Kp, int k0, int NP, int T, int G, int P,
                       int S, long P_total, int window, float scale) {
  using Gm = Geo<FMT, DH>;
  using Sm = Smem<FMT, DH, GM>;
  constexpr int NW = Gm::kWarps, NT = Gm::kThreads, DJ = Gm::kDJ;
  constexpr int VE = Gm::kVE, DA = Gm::kDA;
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* tiles = smem + Sm::kTiles;
  long* ofs_s = reinterpret_cast<long*>(smem + Sm::kOfs);
  float* q_s = reinterpret_cast<float*>(smem + Sm::kQ);
  float* p_s = reinterpret_cast<float*>(smem + Sm::kP);
  float* cacc = reinterpret_cast<float*>(smem + Sm::kCacc);
  int* base_s = reinterpret_cast<int*>(smem + Sm::kBase);
  float* ks_s = reinterpret_cast<float*>(smem + Sm::kKs);
  float* vs_s = reinterpret_cast<float*>(smem + Sm::kVs);
  float* cm = reinterpret_cast<float*>(smem + Sm::kCm);
  float* cl = reinterpret_cast<float*>(smem + Sm::kCl);

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int p = blockIdx.x / S, k = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const long bk = static_cast<long>(b) * K + k;

  // this rank's share of the partition's logical pages: [pg_lo, pg_hi)
  const int npp = NP / P;
  const int share = (npp + S - 1) / S;
  const int pg_lo = min(p * npp + rank * share, (p + 1) * npp);
  const int pg_hi = min(pg_lo + share, (p + 1) * npp);

  const int Ts = FMT == kKV4 ? T / 2 : T;
  const Walk walk(table, b, k0 + k, Kp, NP, Ts, P_total);
  const int* base_b = base + static_cast<long>(b) * NP;
  Walker c{ofs_s, base_s, ks_s, vs_s, q_s, p_s + warp * GM * kTile,
           tiles + warp * Gm::kWarpBytes,
           static_cast<const unsigned char*>(kp),
           static_cast<const unsigned char*>(vp), 0, T, length[b], window,
           lane};

  WarpAcc<DA, GM> w;
#pragma unroll
  for (int g = 0; g < GM; ++g) {
    w.m[g] = kNegInf;
    w.l[g] = 0.f;
#pragma unroll
    for (int a = 0; a < DA; ++a) w.acc[g][a] = 0.f;
  }

  constexpr int kPer = kPageChunk / NT;   // pages a thread stages a round
  for (int c0 = pg_lo; c0 < pg_hi; c0 += kPageChunk) {
    const int npg = min(kPageChunk, pg_hi - c0);
    // ---- page metadata: bases and entries in one coalesced load --------
    int pb[kPer], en[kPer];
#pragma unroll
    for (int n = 0; n < kPer; ++n) {
      const int i = tid + n * NT;
      pb[n] = i < npg ? base_b[c0 + i] : -1;
      en[n] = i < npg ? walk.entry(c0 + i) : 0;
    }
    if (c0 == pg_lo) {
      // q (scaled), its loads in flight beside the metadata loads: one
      // memory round trip for both
      for (int i = tid; i < GM * DH; i += NT)
        q_s[i] = i < G * DH ? q[bk * G * DH + i] * scale : 0.f;
    } else {
      __syncthreads();                // the last round's metadata is read
    }
#pragma unroll
    for (int n = 0; n < kPer; ++n) {
      const int i = tid + n * NT;
      if (i >= npg) break;
      const bool any = pb[n] >= 0 && pb[n] < c.len &&
                       (window < 0 || pb[n] + T - 1 > c.len - 1 - window);
      long off = -1;
      float ksv = 0.f, vsv = 0.f;
      if (any) {                      // only a live page's entry is used
        off = walk.offset(c0 + i, en[n]);
        if (Gm::kQuant) {
          const long si = walk.scale(c0 + i, en[n]);
          ksv = ks[si];
          vsv = vs[si];
        }
      }
      ofs_s[i] = off;
      base_s[i] = pb[n];
      ks_s[i] = ksv;
      vs_s[i] = vsv;
    }
    __syncthreads();

    // ---- the warp's ring: tile i + kStages in flight while i computes --
    c.ntok = npg * T;
    const int ntiles = (c.ntok + kTile - 1) / kTile;
    const int mine = warp < ntiles ? (ntiles - warp + NW - 1) / NW : 0;
#pragma unroll
    for (int st = 0; st < kStages; ++st) {
      if (st < mine) issue_tile<FMT, DH>(c, warp + st * NW, st);
      cp_async_commit();
    }
    for (int i = 0; i < mine; ++i) {
      cp_async_wait<kStages - 1>();
      __syncwarp();
      compute_tile<FMT, DH, GM>(c, w, warp + i * NW, i % kStages);
      __syncwarp();                   // every lane is done with the slot
      const int refill = i % kStages;
      if (i + kStages < mine)
        issue_tile<FMT, DH>(c, warp + (i + kStages) * NW, refill);
      cp_async_commit();
    }
    cp_async_wait<0>();
  }

  // ---- merge the warps' partials (log-sum-exp) into the CTA's ----------
  __syncthreads();                    // the tile rings become scratch
  float* wm = reinterpret_cast<float*>(tiles);
  float* wl = wm + NW * GM;
  float* wacc = wl + NW * GM;
#pragma unroll
  for (int g = 0; g < GM; ++g) {
    const float lsum = warp_sum(w.l[g]);
    if (lane == 0) {
      wm[warp * GM + g] = w.m[g];
      wl[warp * GM + g] = lsum;
    }
#pragma unroll
    for (int jj = 0; jj < DJ; ++jj) {
      const int d0 = (jj * 32 + lane) * VE;
      if (DH % (32 * VE) == 0 || d0 < DH) {
#pragma unroll
        for (int e = 0; e < VE; ++e)
          wacc[(warp * GM + g) * DH + d0 + e] = w.acc[g][jj * VE + e];
      }
    }
  }
  __syncthreads();
  for (int i = tid; i < G * DH; i += NT) {
    const int g = i / DH, d = i - g * DH;
    float M = kNegInf;
#pragma unroll
    for (int v = 0; v < NW; ++v) M = fmaxf(M, wm[v * GM + g]);
    float L = 0.f, A = 0.f;
#pragma unroll
    for (int v = 0; v < NW; ++v) {
      const float e = expf(wm[v * GM + g] - M);
      L = fmaf(wl[v * GM + g], e, L);
      A = fmaf(wacc[(v * GM + g) * DH + d], e, A);
    }
    cacc[i] = A;
    if (d == 0) {
      cm[g] = M;
      cl[g] = L;
    }
  }

  // ---- merge the cluster's S partials through distributed shared memory
  cluster.sync();                     // every rank's partial is written
  const long out_row = (bk * P + p) * G;
  for (int i = rank * NT + tid; i < G * DH; i += S * NT) {
    const int g = i / DH, d = i - g * DH;
    float M = kNegInf;
    for (int r = 0; r < S; ++r)
      M = fmaxf(M, cluster.map_shared_rank(cm, r)[g]);
    float L = 0.f, O = 0.f;
    for (int r = 0; r < S; ++r) {
      const float e = expf(cluster.map_shared_rank(cm, r)[g] - M);
      L = fmaf(cluster.map_shared_rank(cl, r)[g], e, L);
      O = fmaf(cluster.map_shared_rank(cacc, r)[i], e, O);
    }
    o_out[(out_row + g) * DH + d] = O / fmaxf(L, 1e-30f);
    if (d == 0) {
      m_out[out_row + g] = M;
      l_out[out_row + g] = L;
    }
  }
  cluster.sync();                     // no rank leaves while it is read
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
  int B, K, NP, T, G, P, S;
  long P_total;           // TableWalk only
  int window;             // < 0: no window
  int Kp, k0;             // the pool's kv heads; the launch's first head
};

template <int FMT, int DH, int GM, template <int, int> class Walk>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  using Sm = Smem<FMT, DH, GM>;
  auto* kernel = paged_attention_kernel<FMT, DH, GM, Walk<FMT, DH>>;
  static bool attr_set = false;       // attribute calls once an instance
  if (!attr_set) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, Sm::kBytes);
    // the whole L1 as shared memory, so two CTAs an SM fit
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
    if (e != cudaSuccess) return e;
    attr_set = true;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(a.S * a.P, a.K, a.B);
  cfg.blockDim = dim3(Geo<FMT, DH>::kThreads, 1, 1);
  cfg.dynamicSmemBytes = Sm::kBytes;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = a.S;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const float scale = 1.0f / sqrtf(static_cast<float>(DH));
  const cudaError_t e = cudaLaunchKernelEx(
      &cfg, kernel, static_cast<const float*>(a.q), a.k, a.v,
      static_cast<const float*>(a.ks), static_cast<const float*>(a.vs),
      static_cast<const int*>(a.table), static_cast<const int*>(a.base),
      static_cast<const int*>(a.length), static_cast<float*>(a.o),
      static_cast<float*>(a.m), static_cast<float*>(a.l), a.K, a.Kp, a.k0,
      a.NP, a.T,
      a.G, a.P, a.S, a.P_total, a.window, scale);
  return e != cudaSuccess ? e : cudaGetLastError();
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
    case 112: return launch_g<FMT, 112, Walk>(a, stream);
    case 128: return launch_g<FMT, 128, Walk>(a, stream);
    case 160: return launch_g<FMT, 160, Walk>(a, stream);
    case 256: return launch_g<FMT, 256, Walk>(a, stream);
    default: return cudaErrorInvalidValue;
  }
}

// fmt: 0 f32, 1 bf16, 2 kv8, 3 kv4.  Launches on `stream`, allocates
// nothing, and returns the launch's error (0 = success).
template <template <int, int> class Walk>
int dispatch(int fmt, int dh, const Args& a, void* stream) {
  if (a.B < 1 || a.K < 1 || a.NP < 1 || a.T < 1 || a.G < 1 || a.G > 8 ||
      a.P < 1 || a.NP % a.P != 0 || (fmt == kKV4 && a.T % 2 != 0) ||
      a.K > 65535 || a.B > 65535 || a.k0 < 0 || a.k0 + a.K > a.Kp ||
      (a.S != 1 && a.S != 2 && a.S != 4 && a.S != kMaxSplit) ||
      static_cast<long>(a.S) * a.P > 0x7fffffffL)
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
