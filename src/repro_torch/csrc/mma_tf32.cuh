// Helpers shared by the port's tensor-core kernels on Hopper (sm_90a):
// 16-byte cp.async with its commit / wait, and float32-exact products on the
// TF32 tensor cores (3xTF32).  Included by flash_attention.cu (B4) and
// wkv6.cu (B5).
//
// 3xTF32: x = hi + lo, hi = tf32(x), lo = tf32(x - hi), each a TF32 value;
// a·b = hi·hi + hi·lo + lo·hi in f32 accumulation, the lo·lo term below
// f32 rounding.  mma.sync m16n8k8 .tf32 fragments, g = lane / 4, q = lane % 4:
//   A (16 x 8, row)  a0 (g, q)  a1 (g + 8, q)  a2 (g, q + 4)  a3 (g + 8, q + 4)
//   B (8 x 8, col)   b0 (q, g)  b1 (q + 4, g)
//   C (16 x 8)       c0 (g, 2q) c1 (g, 2q + 1) c2 (g + 8, 2q) c3 (g + 8, 2q + 1)
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// `bytes` (0 or 16) bytes from global to shared, the rest of the 16 zero
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(bytes)
               : "memory");
}

// `bytes` (0 or 4) bytes from global to shared, the rest of the 4 zero
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
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

// x rounded to TF32 (10 mantissa bits), to nearest, ties away from zero:
// the bits of cvt.rna.tf32.f32 for every finite x below 2^128, as an
// integer add and mask (cvt.rna costs several instructions on this card:
// B4's f32 long shape ran 1.33x slower with it, PERF.md §6)
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// x = hi + lo, each a TF32 value: hi = tf32(x), lo = tf32(x - hi)
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = tf32_rna(x);
  lo = tf32_rna(x - __uint_as_float(hi));
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a·b in f32-exact 3xTF32: the two small cross terms first
__device__ __forceinline__ void mma3(float (&d)[4], const uint32_t (&ah)[4],
                                     const uint32_t (&al)[4], uint32_t bh0,
                                     uint32_t bh1, uint32_t bl0,
                                     uint32_t bl1) {
  mma_tf32(d, al, bh0, bh1);
  mma_tf32(d, ah, bl0, bl1);
  mma_tf32(d, ah, bh0, bh1);
}

}  // namespace
