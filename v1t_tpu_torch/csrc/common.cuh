// Shared device helpers for the port's hand-written Hopper kernels.
//
// The matrix products use the warp-level tensor-core instruction
// mma.sync.m16n8k16 (bf16 inputs, fp32 accumulation). Fragment layouts, with
// g = lane / 4 and t = lane % 4 (PTX ISA, "Matrix fragments for mma.m16n8k16"):
//   A (16x16, row-major): a[0] = (row g,   cols 2t..2t+1)
//                         a[1] = (row g+8, cols 2t..2t+1)
//                         a[2] = (row g,   cols 2t+8..2t+9)
//                         a[3] = (row g+8, cols 2t+8..2t+9)
//   B (16x8, "col"):      b[0] = (k 2t..2t+1,   col g)
//                         b[1] = (k 2t+8..2t+9, col g)
//   C (16x8, fp32):       c[0..1] = (row g, cols 2t..2t+1), c[2..3] = row g+8
// Each 32-bit register holds two bf16 values, the lower column in the low half.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ void mma_16816(float c[4], const uint32_t a[4],
                                          const uint32_t b[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// two bf16 (lo = lower column) in one register
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// a 32-bit load of two adjacent bf16 from shared memory (even element index)
__device__ __forceinline__ uint32_t ld_pair(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }

// round a float to bf16 and back: the rounding points of the plain versions
__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// shared-memory address of a generic pointer, for the PTX below
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// 16-byte asynchronous copy global -> shared; zero-fills when !valid
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int PENDING>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(PENDING));
}

// four 8x8 bf16 matrices from shared memory, transposed: lane i addresses
// row i % 8 of matrix i / 8 and receives, of each matrix, the elements
// (rows 2t, 2t+1; column g) — the mma B fragment of a row-major [k][n] tile
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t r[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}
