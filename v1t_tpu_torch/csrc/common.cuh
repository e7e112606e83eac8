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

// four 8x8 bf16 matrices from shared memory, not transposed: lane i
// addresses row i % 8 of matrix i / 8 and receives, of each matrix, the
// elements (row g; columns 2t, 2t+1)
__device__ __forceinline__ void ldmatrix_x4(uint32_t r[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// the two warps of a dk/dv pair p (warps p and p + 4) meet at barrier 1 + p
__device__ __forceinline__ void pair_barrier(int pair) {
  asm volatile("bar.sync %0, 64;\n" ::"r"(1 + pair) : "memory");
}

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ void store_f(bf16* p, float v) { *p = __float2bfloat16_rn(v); }
__device__ __forceinline__ void store_f(float* p, float v) { *p = v; }

// float4 helpers of the float32 (FFMA) kernels
__device__ __forceinline__ float lane4(const float4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// acc + a . b over four terms, in order
__device__ __forceinline__ float dot4(float acc, const float4& a, const float4& b) {
  return fmaf(a.w, b.w, fmaf(a.z, b.z, fmaf(a.y, b.y, fmaf(a.x, b.x, acc))));
}

// acc += a b, four columns
__device__ __forceinline__ void fma4(float4& acc, float a, const float4& b) {
  acc.x = fmaf(a, b.x, acc.x);
  acc.y = fmaf(a, b.y, acc.y);
  acc.z = fmaf(a, b.z, acc.z);
  acc.w = fmaf(a, b.w, acc.w);
}

// Where row `row` of plane bh = b * H + h of a (B, H, N, D) tensor starts
// when it is stored with arbitrary strides (a (B, N, H, D) buffer: batch
// N * H * D, head D, row H * D).
struct RowLayout {
  int H, batch, head, row;
  __device__ __forceinline__ size_t at(int bh, int r) const {
    return (size_t)(bh / H) * batch + (size_t)(bh % H) * head + (size_t)r * row;
  }
};

// ---------------------------------------------------------------------------
// Dropout keep masks (ops/dropout.py is the same function in PyTorch).
// Element (plane, row, col) of site `site` under seed `seed` is word col % 4
// of Philox4x32-10 with key (seed, site) and counter (col / 4, row, plane, 0),
// kept when that word is below `threshold` = floor(keep_prob * 2^32);
// threshold 0 switches dropout off. Kept elements are scaled by `scale`.
struct Drop {
  uint32_t seed, site, threshold;
  float scale;
  __device__ __forceinline__ bool on() const { return threshold != 0u; }
};

__device__ __forceinline__ uint4 philox4x32(uint32_t c0, uint32_t c1, uint32_t c2,
                                            uint32_t c3, uint32_t k0, uint32_t k1) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    if (r) {
      k0 += 0x9E3779B9u;
      k1 += 0xBB67AE85u;
    }
    const uint32_t hi0 = __umulhi(0xD2511F53u, c0), lo0 = 0xD2511F53u * c0;
    const uint32_t hi1 = __umulhi(0xCD9E8D57u, c2), lo1 = 0xCD9E8D57u * c2;
    c0 = hi1 ^ c1 ^ k0;
    c2 = hi0 ^ c3 ^ k1;
    c1 = lo1;
    c3 = lo0;
  }
  return make_uint4(c0, c1, c2, c3);
}

__device__ __forceinline__ uint32_t word_of(const uint4& w, int i) {
  return i == 0 ? w.x : i == 1 ? w.y : i == 2 ? w.z : w.w;
}

// the four keep words of elements (plane, row, 4*col4 .. 4*col4 + 3)
__device__ __forceinline__ uint4 keep_words(const Drop& d, uint32_t plane, uint32_t row,
                                            uint32_t col4) {
  return philox4x32(col4, row, plane, 0u, d.seed, d.site);
}

// keep (1) or drop (0) element (plane, row, col)
__device__ __forceinline__ bool keep_at(const Drop& d, uint32_t plane, uint32_t row,
                                        uint32_t col) {
  return word_of(keep_words(d, plane, row, col >> 2), col & 3) < d.threshold;
}

// Keep flags of the four elements an mma C fragment gives a thread, in
// c[] order: (row0 + g, col0 + 2t + j) for c[j], (row0 + g + 8, ...) for
// c[2 + j], where the mask's col runs along the fragment's columns. Lanes t
// and t^1 share a group of 4 columns: each computes one Philox (row g or
// g + 8) and passes the other lane the two words it needs.
__device__ __forceinline__ void keep_frag_rows(const Drop& d, uint32_t plane, int row0,
                                               int col0, int lane, bool keep[4]) {
  const int g = lane >> 2, t = lane & 3, odd = t & 1;
  const uint4 w = keep_words(d, plane, (uint32_t)(row0 + g + 8 * odd),
                             (uint32_t)(col0 + 2 * t) >> 2);
  // even lanes need words 0, 1 of both rows; odd lanes words 2, 3
  const uint32_t send0 = odd ? w.x : w.z, send1 = odd ? w.y : w.w;
  const uint32_t got0 = __shfl_xor_sync(0xffffffffu, send0, 1);
  const uint32_t got1 = __shfl_xor_sync(0xffffffffu, send1, 1);
  const uint32_t own0 = odd ? w.z : w.x, own1 = odd ? w.w : w.y;
  // c[0..1] belong to row g, c[2..3] to row g + 8
  keep[0] = (odd ? got0 : own0) < d.threshold;
  keep[1] = (odd ? got1 : own1) < d.threshold;
  keep[2] = (odd ? own0 : got0) < d.threshold;
  keep[3] = (odd ? own1 : got1) < d.threshold;
}

// The same for a transposed fragment, where the mask's col runs along the
// fragment's rows: c[j] is element (mask row = col0 + 2t + j, mask col =
// row0 + g), c[2 + j] (col0 + 2t + j, row0 + g + 8). The four lanes that
// share t and g / 4 hold the same four (mask row, column group) pairs: each
// computes one and the others fetch the word they need in three shuffles.
__device__ __forceinline__ void keep_frag_cols(const Drop& d, uint32_t plane, int row0,
                                               int col0, int lane, bool keep[4]) {
  const int g = lane >> 2, t = lane & 3, i = g & 3;
  // pair p: mask row col0 + 2t + (p & 1), mask column group of row0 + g (+8 if p >= 2)
  const uint4 w = keep_words(d, plane, (uint32_t)(col0 + 2 * t + (i & 1)),
                             (uint32_t)(row0 + (g & ~3) + 8 * (i >> 1)) >> 2);
  // round r: receive from the lane that computed pair (i + r) % 4 its word i
  uint32_t v[4];
  v[0] = word_of(w, i);
#pragma unroll
  for (int r = 1; r < 4; ++r)
    v[r] = __shfl_sync(0xffffffffu, word_of(w, (i - r) & 3), (lane & ~12) | (((i + r) & 3) << 2));
#pragma unroll
  for (int p = 0; p < 4; ++p) {
    const int r = (p - i) & 3;
    const uint32_t word = r == 0 ? v[0] : r == 1 ? v[1] : r == 2 ? v[2] : v[3];
    keep[p] = word < d.threshold;
  }
}
