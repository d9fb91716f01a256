// Thin wrappers over the PTX instructions of the tensor-core attention
// kernels (tc_attention.cuh, tc_attention_f32.cuh): cp.async copies into
// shared memory with zero fill, ldmatrix fragment loads, the bf16 mma.sync
// product m16n8k16 and the TF32 product m16n8k8, both with f32
// accumulation, and the round-to-nearest conversion of f32 to TF32.
//
// Fragment layouts (PTX ISA, "Matrix fragments for mma.m16n8k16"), for
// lane l of a warp, g = l / 4 and t = l % 4:
//   A (16 x 16, row-major), four 32-bit registers of two bf16 each:
//     a0 = (row g,     cols 2t, 2t+1), a1 = (row g + 8, cols 2t, 2t+1),
//     a2 = (row g,     cols 2t+8, +9), a3 = (row g + 8, cols 2t+8, +9);
//   B (16 x 8, "col": element (k, n)), two registers:
//     b0 = (k 2t, 2t+1; n g), b1 = (k 2t+8, 2t+9; n g);
//   C/D (16 x 8 f32): c0, c1 = (row g, cols 2t, 2t+1), c2, c3 = (row g+8,
//     cols 2t, 2t+1).
// The lower-indexed element of a pair sits in the low 16 bits.
// ldmatrix .x4 loads four 8x8 b16 matrices whose rows lanes 0-7, 8-15,
// 16-23 and 24-31 address; lane l receives (row l / 4, cols 2(l % 4),
// +1) of each, or with .trans (rows 2(l % 4), +1; col l / 4).
//
// "Matrix fragments for mma.m16n8k8" with .tf32 operands, one TF32 value
// (an f32 bit pattern whose low 13 mantissa bits the product ignores) per
// 32-bit register:
//   A (16 x 8, row-major): a0 = (row g, col t), a1 = (row g + 8, col t),
//     a2 = (row g, col t + 4), a3 = (row g + 8, col t + 4);
//   B (8 x 8, "col"): b0 = (k t; n g), b1 = (k t + 4; n g);
//   C/D (16 x 8 f32): as for m16n8k16 above.
// The product ignores the low bits rather than rounding them away, so
// operands are rounded first (tc_attention_f32.cuh's split, held against
// tf32_rna on the card).  The card test
// tests/test_torch_cuda.py::test_tf32x3_fragments_exact pins this layout
// with exact integer products.

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace ffk {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// async copies global -> shared of 16, 8 or 4 bytes; the bytes past
// src_bytes (0: all of them) are filled with zeros and not read
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async8(void* dst, const void* src,
                                          int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// wait until at most N of this thread's committed groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4],
                                              const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldsm_x2_trans(uint32_t (&r)[2],
                                              const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
      : "=r"(r[0]), "=r"(r[1])
      : "r"(smem_addr(p)));
}

// d += a . b, bf16 operands, f32 accumulators
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a . b, TF32 operands (see tf32_rna), f32 accumulators
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// x rounded to TF32, to nearest with ties away from zero (the magnitude's
// bit pattern plus 0x1000, low 13 bits cleared), as an f32 bit pattern
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// two floats rounded to bf16 (nearest even), lo in the low 16 bits
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

}  // namespace ffk
