// Paged decode attention over the shared page pool (kernel B2): replaces
// the TPU kernel `paged_attention_pallas_shared`
// (src/repro/kernels/paged_attention/kernel.py, body `_kernel_shared`,
// loader `_load_page_shared`).  The TPU kernel scalar-prefetched the page
// table so its block index map streamed one pool page per grid step; here
// each CTA reads the table entries of its page range beside their page
// bases in one coalesced load, resolves the live pages' storage offsets in
// shared memory, and its warps stream those pages' rows by cp.async
// (TableWalk in paged_attention.cuh, which holds the kernel body, its
// design and what bounds it).  This file holds the shared layout's plain C
// entry point, bound with ctypes.

#include "paged_attention.cuh"

// q [B, K, G, dh] f32; k, v [K, P_total, Ts, dh]; ks, vs [K, P_total] f32
// (kv8/kv4 only); table [B, NP] int32 physical page of each logical page,
// every entry in [0, P_total) (entries of masked tokens are read, never
// used as addresses);
// base [B, NP], length [B] int32; o [B, K, P, G, dh], m / l [B, K, P, G]
// f32.  fmt: 0 f32, 1 bf16, 2 kv8, 3 kv4; window < 0 means no window;
// split (1, 2, 4 or 8) is the cluster size S that walks each of the P
// partitions.  Returns the launch's error (0 = success).
extern "C" int kvnand_paged_attention_shared(
    const void* q, const void* k, const void* v, const void* ks,
    const void* vs, const void* table, const void* base, const void* length,
    void* o, void* m, void* l, int B, int K, int NP, int P_total, int T,
    int G, int dh, int P, int window, int split, int fmt, void* stream) {
  if (P_total < 1) return static_cast<int>(cudaErrorInvalidValue);
  const kvnand::Args a{q, k, v, ks, vs, table, base, length, o, m, l,
                       B, K, NP, T, G, P, split,
                       static_cast<long>(P_total), window, K, 0};
  return kvnand::dispatch<kvnand::TableWalk>(fmt, dh, a, stream);
}
