// float32 products on the tensor cores in three TF32 terms (3xTF32), for the
// float32 flash kernels past padded head width 256 (flash_attention.cu,
// flash_attention_bwd.cu).
//
// Each float32 operand x is split in registers into two TF32 values, big =
// tf32(x) and small = tf32(x - big) (cvt.rna's rounding: to nearest, ties
// away from zero), and a b is taken as small_a big_b + big_a small_b + big_a big_b
// on mma.sync m16n8k8 (TF32 inputs, float32 accumulation), the small terms
// first, as CUTLASS's fast-F32 warp product (OpMultiplyAddFastF32, which
// PyTorch's float32 SDPA runs on) orders them. The dropped small_a small_b
// term and the residual of small are below 2^-22 of |a b|: float32's own
// rounding. One TF32 product alone keeps 11 bits (tests/test_torch_tf32_split.py
// shows it missing the float32 kernels' tolerance).
//
// Fragments of m16n8k8 .tf32 (PTX ISA, "Matrix fragments for mma.m16n8k8"),
// g = lane / 4, t = lane % 4:
//   A (16x8, row): a0 (g, t), a1 (g + 8, t), a2 (g, t + 4), a3 (g + 8, t + 4)
//   B (8x8, col):  b0 (k t, n g), b1 (k t + 4, n g)
//   C (16x8):      c0, c1 (g, 2t .. 2t + 1), c2, c3 (g + 8, 2t .. 2t + 1)
//
// Tiles in shared memory are row-major, a multiple of 32 floats a row, their
// 16-byte chunks swizzled by row: chunk c of row r sits at c ^ swz(r), swz
// taking rows 0-7 to 0, 2, 4, 6, 1, 3, 5, 7. Both ways the products read a
// tile are then free of bank conflicts: ldmatrix (8 consecutive rows, one
// chunk each: 8 distinct chunk positions) and the transposed 32-bit reads of
// a B (or transposed A) fragment (rows t and t + 4, columns g of 8: the
// swizzles of rows 0-3, and of 4-7, differ in bits 1-2 of the chunk).
#pragma once

#include "common.cuh"

namespace tf32 {

// x rounded to TF32 as cvt.rna.tf32.f32 rounds a finite value (to nearest,
// ties away from zero): half of the dropped unit added to the magnitude's
// bits, the 13 low bits cleared; inf and quiet nan stay as they are. Two
// integer instructions; cvt.rna itself compiles to more on an H100 (it also
// tests for inf and nan): the kernels' variant with it gives the same output
// bits, slower (tools/f32_wide_costs.py, variant cvt.rna)
__device__ __forceinline__ uint32_t to_tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// x = big + small, both TF32 (x - big is exact)
__device__ __forceinline__ void split(float x, uint32_t& big, uint32_t& small) {
  big = to_tf32(x);
  small = to_tf32(x - __uint_as_float(big));
}

template <int N>
__device__ __forceinline__ void split(const uint32_t (&x)[N], uint32_t (&big)[N],
                                      uint32_t (&small)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) split(__uint_as_float(x[i]), big[i], small[i]);
}

__device__ __forceinline__ void mma(float c[4], const uint32_t a[4], const uint32_t b[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// c += a b in 3xTF32, the small terms first
__device__ __forceinline__ void mma3(float c[4], const uint32_t ab[4], const uint32_t as[4],
                                     const uint32_t bb[2], const uint32_t bs[2]) {
  mma(c, as, bb);
  mma(c, ab, bs);
  mma(c, ab, bb);
}

__device__ __forceinline__ int swz(int r) { return ((r & 3) << 1) | ((r >> 2) & 1); }

// the float offset of element (r, c) of a swizzled tile of `ld` floats a row
__device__ __forceinline__ int at(int r, int c, int ld) {
  return r * ld + ((((c >> 2) ^ swz(r)) << 2) | (c & 3));
}

// an A fragment (rows m0 .. m0 + 15, columns k0 .. k0 + 7) by ldmatrix: lane
// i addresses row m0 + i % 16 of chunk k0 / 4 + i / 16
__device__ __forceinline__ void load_a(uint32_t a[4], const float* tile, int ld, int m0, int k0,
                                       int lane) {
  ldmatrix_x4(a, tile + at(m0 + (lane & 15), k0 + 4 * (lane >> 4), ld));
}

// A and B fragments of a product over a row-major [m][k] A and [n][k] B
// (S = q K^T, dP = dO V^T) by ldmatrix, 32 columns of k at a time: the
// lane's rows and, for the four k-steps of a 32-column block, its
// swizzled chunk offsets (the block's base moves by 32 floats, the
// swizzle stays), computed once
struct RowPairLoader {
  const float* a;
  const float* b;
  int aoff[4], boff[4];
  __device__ __forceinline__ RowPairLoader(const float* at_, const float* bt, int ld, int m0, int n0,
                                           int lane) {
    const int ar = m0 + (lane & 15), br = n0 + (lane & 7) + ((lane >> 4) << 3);
    a = at_ + ar * ld;
    b = bt + br * ld;
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      aoff[s] = ((2 * s + (lane >> 4)) ^ swz(ar)) << 2;
      boff[s] = ((2 * s + ((lane >> 3) & 1)) ^ swz(br)) << 2;
    }
  }
  // k-step s of the 32-column block at k0: an A fragment, two n-tiles' B
  __device__ __forceinline__ void load(uint32_t af[4], uint32_t bf[4], int k0, int s) const {
    ldmatrix_x4(af, a + k0 + aoff[s]);
    ldmatrix_x4(bf, b + k0 + boff[s]);
  }
};

// A B^T over k < kn (a multiple of 32) in 3xTF32, 16 rows x two n-tiles:
// d[n] in C fragment order. Alternate k-steps accumulate into sets of
// their own (summed at the end), so that the three-product chains of
// neighbouring k-steps overlap
__device__ __forceinline__ void product_rows(float (&d)[2][4], const RowPairLoader& ld, int kn) {
  float c[2][2][4];
#pragma unroll
  for (int p = 0; p < 2; ++p)
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) c[p][n][e] = 0.f;
  for (int k0 = 0; k0 < kn; k0 += 32) {
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      uint32_t a[4], b[4], ab[4], as[4], bb[4], bs[4];
      ld.load(a, b, k0, s);
      split(a, ab, as);
      split(b, bb, bs);
      mma3(c[s & 1][0], ab, as, bb, bs);
      mma3(c[s & 1][1], ab, as, bb + 2, bs + 2);
    }
  }
#pragma unroll
  for (int n = 0; n < 2; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) d[n][e] = c[0][n][e] + c[1][n][e];
}

// a B fragment read across a [k][n] tile (rows k0 + t, k0 + t + 4; column
// n0 + g), split
__device__ __forceinline__ void load_bt(uint32_t bb[2], uint32_t bs[2], const float* tile, int ld,
                                        int k0, int n0, int lane) {
  const int g = lane >> 2, t = lane & 3;
  split(tile[at(k0 + t, n0 + g, ld)], bb[0], bs[0]);
  split(tile[at(k0 + t + 4, n0 + g, ld)], bb[1], bs[1]);
}

// an A fragment read across a [k][m] tile (the transpose of the [m][k] A:
// rows k0 + t, k0 + t + 4; columns m0 + g, m0 + g + 8), as stored
__device__ __forceinline__ void load_at(uint32_t a[4], const float* tile, int ld, int m0, int k0,
                                        int lane) {
  const int g = lane >> 2, t = lane & 3;
  a[0] = __float_as_uint(tile[at(k0 + t, m0 + g, ld)]);
  a[1] = __float_as_uint(tile[at(k0 + t, m0 + g + 8, ld)]);
  a[2] = __float_as_uint(tile[at(k0 + t + 4, m0 + g, ld)]);
  a[3] = __float_as_uint(tile[at(k0 + t + 4, m0 + g + 8, ld)]);
}

}  // namespace tf32
