// Paged decode attention over the per-slot stripe layout (kernel B1):
// replaces the TPU kernel `paged_attention_pallas`
// (src/repro/kernels/paged_attention/kernel.py).  The kernel body, its
// design and what bounds it are in paged_attention.cuh; this file holds
// the stripe layout's plain C entry point, bound with ctypes.

#include "paged_attention.cuh"

// q [B, K, G, dh] f32 for the pool's kv heads [k0, k0 + K); k, v
// [B, Kp, NP, Ts, dh] (the layer's whole pool, Kp >= k0 + K); ks, vs
// [B, Kp, NP] f32 (kv8/kv4 only); base [B, NP], length [B] int32;
// o [B, K, P, G, dh], m / l [B, K, P, G] f32.  fmt: 0 f32, 1 bf16, 2 kv8,
// 3 kv4; window < 0 means no window; split (1, 2, 4 or 8) is the cluster
// size S that walks each of the P partitions.  Returns the launch's error
// (0 = success).
extern "C" int kvnand_paged_attention(const void* q, const void* k,
                                      const void* v, const void* ks,
                                      const void* vs, const void* base,
                                      const void* length, void* o, void* m,
                                      void* l, int B, int K, int Kp, int k0,
                                      int NP, int T, int G, int dh, int P,
                                      int window, int split, int fmt,
                                      void* stream) {
  const kvnand::Args a{q, k, v, ks, vs, nullptr, base, length, o, m, l,
                       B, K, NP, T, G, P, split, 0, window, Kp, k0};
  return kvnand::dispatch<kvnand::StripeWalk>(fmt, dh, a, stream);
}
