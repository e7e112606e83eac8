// The bf16 attention forward tile loop of attention.cu (the fused
// sublayer's core, q in registers); the composed path's flash kernel
// (flash_attention.cu) runs on wgmma instead.
//
// A block of 8 warps owns 128 query rows of one (batch, head); each warp owns
// 16 of them and runs an online softmax over key tiles of 64. Key and value
// tiles stream through a double-buffered shared-memory ring with 16-byte
// cp.async copies, the next tile in flight while the current one is used; K
// is read as 32-bit pairs in the mma B layout, V through ldmatrix.trans.
// Scores, the running max and sum, and the 16 x DP output accumulator stay in
// registers (the C layout of mma is known, so rescaling needs no shared
// memory); the unnormalised probabilities are rounded to bf16 and reused in
// registers as the A operand of P.V. Scores are in log2 units: the caller
// folds log2(e) into q, or asks for the product to be scaled (SCALE_S).
// Dropout selects only: the row sum is taken before the keep mask and the
// 1/keep scale folds into the caller's 1/l. Masked scores are MASKED; a row
// whose keys so far are all masked sums garbage ones that the first real
// key's rescale (alpha = 0) wipes.
#pragma once

#include "common.cuh"

namespace attn_tile {

constexpr int BQ = 128, BKV = 64, THREADS = 256;
constexpr float LOG2E = 1.4426950408889634f;
constexpr float MASKED = -1e30f;

// the K and V rings: [2 stages][BKV][DP + 8] each
template <int DP>
constexpr int kv_smem_bytes() {
  return 2 /* K, V */ * 2 /* stages */ * BKV * (DP + 8) * (int)sizeof(bf16);
}

// Start the cp.async copies of key/value tile kt (rows of DP bf16, rows at or
// past n_keys zero-filled) into ring stage `stage`, and commit them.
template <int DP>
__device__ __forceinline__ void load_kv_tile(const bf16* __restrict__ kg,
                                             const bf16* __restrict__ vg, int n_keys, int kt,
                                             int stage, bf16* Ks, bf16* Vs) {
  constexpr int LD = DP + 8, CHUNKS = DP / 8;
  bf16* kd = Ks + stage * BKV * LD;
  bf16* vd = Vs + stage * BKV * LD;
  for (int i = threadIdx.x; i < BKV * CHUNKS; i += THREADS) {
    const int j = i / CHUNKS, c = (i % CHUNKS) * 8, key = kt * BKV + j;
    const bool valid = key < n_keys;
    const size_t off = valid ? (size_t)key * DP + c : 0;
    cp_async16(kd + j * LD + c, kg + off, valid);
    cp_async16(vd + j * LD + c, vg + off, valid);
  }
  cp_async_commit();
}

// The online softmax and P.V over every key tile, for the warp's rows
// row0 + g (c[0..1], running max m0, sum l0) and row0 + g + 8 (c[2..3], m1,
// l1). Tile 0 must already be in flight (load_kv_tile(.., 0, 0, ..)).
// qfrag(kk, a) gives the A fragment of q for head columns 16 kk .. 16 kk + 15.
// Keys at or past n_real are masked, and with lsa the key equal to the row.
// DROP applies the keep mask of element (plane, row, key) when drop.on().
// l0/l1 come out summed over the quad: every lane holds its rows' sums.
template <int DP, bool DROP, bool SCALE_S, class QFrag>
__device__ __forceinline__ void softmax_pv(const QFrag& qfrag, const bf16* __restrict__ kg,
                                           const bf16* __restrict__ vg, int n_keys,
                                           int n_real, int row0, int lsa, const Drop& drop,
                                           uint32_t plane, bf16* Ks, bf16* Vs,
                                           float (&o)[DP / 8][4], float& m0, float& m1,
                                           float& l0, float& l1) {
  constexpr int LD = DP + 8;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int r0 = row0 + g, r1 = r0 + 8;
#pragma unroll
  for (int di = 0; di < DP / 8; ++di)
#pragma unroll
    for (int j = 0; j < 4; ++j) o[di][j] = 0.f;
  m0 = m1 = MASKED;
  l0 = l1 = 0.f;

  const int ntiles = (n_keys + BKV - 1) / BKV;
  for (int kt = 0; kt < ntiles; ++kt) {
    const int stage = kt & 1;
    if (kt + 1 < ntiles) {
      load_kv_tile<DP>(kg, vg, n_keys, kt + 1, stage ^ 1, Ks, Vs);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* kt_s = Ks + stage * BKV * LD;
    const bf16* vt_s = Vs + stage * BKV * LD;

    // scores of 16 rows x 64 keys: 8 n-tiles of 8 keys
    float s[BKV / 8][4];
#pragma unroll
    for (int ni = 0; ni < BKV / 8; ++ni)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[ni][j] = 0.f;
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) {
      uint32_t a[4];
      qfrag(kk, a);
#pragma unroll
      for (int ni = 0; ni < BKV / 8; ++ni) {
        const bf16* p = kt_s + (ni * 8 + g) * LD + kk * 16 + 2 * t;
        uint32_t bfrag[2] = {ld_pair(p), ld_pair(p + 8)};
        mma_16816(s[ni], a, bfrag);
      }
    }

    // masks, then the online softmax update of rows r0 (c0, c1), r1 (c2, c3)
    float mx0 = m0, mx1 = m1;
#pragma unroll
    for (int ni = 0; ni < BKV / 8; ++ni)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int key = kt * BKV + ni * 8 + 2 * t + (j & 1);
        const int row = (j >> 1) ? r1 : r0;
        if (SCALE_S) s[ni][j] *= LOG2E;
        if (key >= n_real || (lsa && key == row)) s[ni][j] = MASKED;
        if (j >> 1) mx1 = fmaxf(mx1, s[ni][j]);
        else mx0 = fmaxf(mx0, s[ni][j]);
      }
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
    const float a0 = exp2f(m0 - mx0), a1 = exp2f(m1 - mx1);
    m0 = mx0;
    m1 = mx1;
    l0 *= a0;
    l1 *= a1;
#pragma unroll
    for (int di = 0; di < DP / 8; ++di) {
      o[di][0] *= a0;
      o[di][1] *= a0;
      o[di][2] *= a1;
      o[di][3] *= a1;
    }
    uint32_t pf[BKV / 16][4];
#pragma unroll
    for (int ni = 0; ni < BKV / 8; ++ni) {
      float p00 = exp2f(s[ni][0] - m0), p01 = exp2f(s[ni][1] - m0);
      float p10 = exp2f(s[ni][2] - m1), p11 = exp2f(s[ni][3] - m1);
      l0 += p00 + p01;
      l1 += p10 + p11;
      if (DROP && drop.on()) {  // select only: 1/keep folds into 1/l
        bool keep[4];
        keep_frag_rows(drop, plane, row0, kt * BKV + ni * 8, lane, keep);
        p00 = keep[0] ? p00 : 0.f;
        p01 = keep[1] ? p01 : 0.f;
        p10 = keep[2] ? p10 : 0.f;
        p11 = keep[3] ? p11 : 0.f;
      }
      // two adjacent 8-key C tiles form one 16-key A fragment
      pf[ni >> 1][(ni & 1) * 2 + 0] = pack_bf16(p00, p01);
      pf[ni >> 1][(ni & 1) * 2 + 1] = pack_bf16(p10, p11);
    }

    // o += P . V: per 16-key step, one ldmatrix.x4.trans feeds two d-tiles
#pragma unroll
    for (int ks = 0; ks < BKV / 16; ++ks) {
#pragma unroll
      for (int di = 0; di < DP / 8; di += 2) {
        uint32_t r[4];
        ldmatrix_x4_trans(r, vt_s + (ks * 16 + (lane & 15)) * LD + di * 8 + (lane >> 4) * 8);
        const uint32_t b0[2] = {r[0], r[1]}, b1[2] = {r[2], r[3]};
        mma_16816(o[di], pf[ks], b0);
        mma_16816(o[di + 1], pf[ks], b1);
      }
    }
    __syncthreads();  // every warp is done with this stage before it refills
  }
  // the four lanes of a quad hold partial sums of the same rows
  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
}

}  // namespace attn_tile
