// attention_bwd: the backward of attention.cu's training forward,
//   dq, dk, dv of o = dropout(softmax(scale_h * q.k, masked)) v per head,
// from the q/k/v the forward read, its output o, the cotangent dO and the
// log2-domain log-sum-exp (LSE) the forward saved.
//
// Replaces the attention part of v1t_tpu/ops/fused_mha.py
// _mha_bwd_kernel_dt2 (:676) (and its dt/legacy orientations :384, :1008):
// P recomputed from the LSE (:768), delta = rowsum(dO . o) (:756), the
// probability keep mask regenerated (:760-762), dS = P (Z dP - delta),
// dq, dk, dv and the per-head dscale (:818). The projections around it
// (the out-projection's and QKV's backwards, the LayerNorm backward) are
// ln_linear_bwd.cu.
//
// Math in the log2 domain the forward uses: q_s = bf16(q * scale * log2 e),
// s2 = q_s . k, P = exp2(s2 - lse2), so that P = softmax(scale q.k). With Z =
// keep / (1 - rate) (zero where dropped), dP = Z (dO . v), dS = P (dP -
// delta) is the gradient of the natural-log scores; then dq = scale dS k,
// dk = ln2 dS^T q_s (= scale dS^T q up to q_s's rounding, as the TPU kernel
// computes it, :804), dv = (Z P)^T dO, dscale_h = sum q . (dS k).
//
// Bound on the H100 at the flagship shapes (B 64, H 4, N 1654, D 155):
// the five N^2 products of a head (S, dP, dq, dk, dv) are 5 * 2 * N^2 * D
// FLOP = 4.24 GFLOP per (b, h), 1.09 TFLOP per call: 1.10 ms of bf16
// tensor-core time against ~0.25 ms of bytes. Bound by operations.
//
// Three kernels, one launch each:
// 1. prep: delta = rowsum(dO . o) per (b, h, row), dO copied from the
//    out-projection's (B, N, H*D) layout into the head-major (B, H, N, DP)
//    layout of q/k/v (zero-padded from D to DP), and q_s = bf16(q * scale *
//    log2 e) written head-major, so that the two main kernels stream every
//    operand with 16-byte cp.async copies.
// 2. dq: one block of 8 warps per (128 query rows, head, batch), the
//    forward's shape: q in registers, the block's dO rows in shared memory,
//    key/value tiles of 64 through a double-buffered cp.async ring; per tile
//    S, P, dP, dS in registers and dq += dS k (ldmatrix.trans on k). The
//    per-(b, h) dscale partial is summed with one atomicAdd per warp.
// 3. dkdv: one block of 8 warps per (64 keys, head, batch); the block's k
//    and v rows stay in shared memory and query tiles of 64 (q_s, dO, lse,
//    delta) stream through a double-buffered ring. The warps work in pairs,
//    one pair per 16 keys: the P warp computes S^T, P^T and its keep mask,
//    hands P^T to its partner through shared memory (a two-warp barrier)
//    and accumulates dv += (Z P)^T dO; the dS warp computes dP^T = v dO^T
//    meanwhile, then dS^T = P^T (Z dP^T - delta) and dk += dS^T q_s. One
//    accumulator of 16 x DP fp32 per warp keeps the registers under the
//    limit, and both warps of a pair issue 160 products per tile. P is
//    recomputed in dq as well: 7 N^2 products where the minimum is 5.
// Keep masks are regenerated with one Philox per 4 elements shared across
// lanes (common.cuh keep_frag_rows / keep_frag_cols).
// Not yet: wgmma, TMA, one pass for dq/dk/dv (atomics on dq).
#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int BQ = 128, BKV = 64;  // dq: query rows per block, key tile
constexpr int CK = 64, CQ = 64;    // dkdv: keys per block, query tile
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

__global__ void __launch_bounds__(THREADS) attention_bwd_prep_kernel(
    const bf16* __restrict__ qkv, const float* __restrict__ scale, const bf16* __restrict__ o,
    const bf16* __restrict__ dout, bf16* __restrict__ qs, bf16* __restrict__ dohm,
    float* __restrict__ delta, int B, int N, int H, int D, int DP) {
  // one warp per (b, h, row)
  const long long item = (long long)blockIdx.x * (THREADS / 32) + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (item >= (long long)B * H * N) return;
  const int row = (int)(item % N), bh = (int)(item / N), h = bh % H, b = bh / H;
  const size_t src = ((size_t)b * N + row) * H * D + (size_t)h * D;
  const size_t hm = ((size_t)bh * N + row) * DP;  // head-major row of q, dO, q_s
  const float sc = scale[h] * LOG2E;
  float acc = 0.f;
  for (int d = lane; d < DP; d += 32) {
    const float g = d < D ? to_f(dout[src + d]) : 0.f;
    if (d < D) acc += g * to_f(o[src + d]);
    dohm[hm + d] = __float2bfloat16_rn(g);
    // q rounded after the scale, as the forward and the dq kernel round it
    qs[hm + d] = __float2bfloat16_rn(d < D ? to_f(qkv[hm + d]) * sc : 0.f);
  }
  acc = warp_sum(acc);
  if (lane == 0) delta[(size_t)bh * N + row] = acc;
}

template <int DP>
constexpr int dq_smem_bytes() {
  return (BQ + 2 * 2 * BKV) * (DP + 8) * (int)sizeof(bf16);
}

template <int DP>
__global__ void __launch_bounds__(THREADS, 1) attention_bwd_dq_kernel(
    const bf16* __restrict__ qkv, const bf16* __restrict__ dohm,
    const float* __restrict__ lse, const float* __restrict__ delta,
    const float* __restrict__ scale, bf16* __restrict__ dqkv, float* __restrict__ dscale,
    int B, int N, int H, int D, int lsa, Drop drop) {
  constexpr int LD = DP + 8, CHUNKS = DP / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* dOs = reinterpret_cast<bf16*>(smem_raw);  // [BQ][LD]
  bf16* Ks = dOs + BQ * LD;                        // [2][BKV][LD]
  bf16* Vs = Ks + 2 * BKV * LD;                    // [2][BKV][LD]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const size_t slab = (size_t)N * DP, bh = (size_t)b * H + h;
  const bf16* qg = qkv + bh * slab;
  const bf16* kg = qkv + ((size_t)(B + b) * H + h) * slab;
  const bf16* vg = qkv + ((size_t)(2 * B + b) * H + h) * slab;
  const bf16* dog = dohm + bh * slab;
  const float sc_nat = scale[h], sc = sc_nat * LOG2E;

  // the block's dO rows, then the first key/value tile
  for (int i = tid; i < BQ * CHUNKS; i += THREADS) {
    const int r = i / CHUNKS, c = (i % CHUNKS) * 8, row = qt * BQ + r;
    const bool valid = row < N;
    cp_async16(dOs + r * LD + c, dog + (valid ? (size_t)row * DP + c : 0), valid);
  }
  auto load_tile = [&](int kt, int stage) {
    bf16* kd = Ks + stage * BKV * LD;
    bf16* vd = Vs + stage * BKV * LD;
    for (int i = tid; i < BKV * CHUNKS; i += THREADS) {
      const int j = i / CHUNKS, c = (i % CHUNKS) * 8, key = kt * BKV + j;
      const bool valid = key < N;
      const size_t off = valid ? (size_t)key * DP + c : 0;
      cp_async16(kd + j * LD + c, kg + off, valid);
      cp_async16(vd + j * LD + c, vg + off, valid);
    }
    cp_async_commit();
  };
  const int ntiles = (N + BKV - 1) / BKV;
  load_tile(0, 0);  // commits the dO rows with it

  const int row0 = qt * BQ + warp * 16;
  const int r0 = row0 + g, r1 = r0 + 8;
  uint32_t qf[DP / 16][4];
#pragma unroll
  for (int kk = 0; kk < DP / 16; ++kk) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int row = (j & 1) ? r1 : r0;
      const int c = kk * 16 + 2 * t + (j >> 1) * 8;
      float lo = 0.f, hi = 0.f;
      if (row < N) {
        const __nv_bfloat162 pair =
            *reinterpret_cast<const __nv_bfloat162*>(qg + (size_t)row * DP + c);
        if (c < D) lo = __low2float(pair) * sc;
        if (c + 1 < D) hi = __high2float(pair) * sc;
      }
      qf[kk][j] = pack_bf16(lo, hi);
    }
  }
  const float* lrow = lse + bh * N;
  const float* drow = delta + bh * N;
  const float lse0 = r0 < N ? lrow[r0] : 0.f, lse1 = r1 < N ? lrow[r1] : 0.f;
  const float del0 = r0 < N ? drow[r0] : 0.f, del1 = r1 < N ? drow[r1] : 0.f;

  float dq[DP / 8][4];
#pragma unroll
  for (int di = 0; di < DP / 8; ++di)
#pragma unroll
    for (int j = 0; j < 4; ++j) dq[di][j] = 0.f;

  for (int kt = 0; kt < ntiles; ++kt) {
    const int stage = kt & 1;
    if (kt + 1 < ntiles) {
      load_tile(kt + 1, stage ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* kt_s = Ks + stage * BKV * LD;
    const bf16* vt_s = Vs + stage * BKV * LD;

    float s[BKV / 8][4], dp[BKV / 8][4];
#pragma unroll
    for (int ni = 0; ni < BKV / 8; ++ni)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[ni][j] = dp[ni][j] = 0.f;
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) {
      const bf16* pa = dOs + (warp * 16 + g) * LD + kk * 16 + 2 * t;
      const uint32_t da[4] = {ld_pair(pa), ld_pair(pa + 8 * LD), ld_pair(pa + 8),
                              ld_pair(pa + 8 * LD + 8)};
#pragma unroll
      for (int ni = 0; ni < BKV / 8; ++ni) {
        const bf16* pk = kt_s + (ni * 8 + g) * LD + kk * 16 + 2 * t;
        const bf16* pv = vt_s + (ni * 8 + g) * LD + kk * 16 + 2 * t;
        const uint32_t kb[2] = {ld_pair(pk), ld_pair(pk + 8)};
        const uint32_t vb[2] = {ld_pair(pv), ld_pair(pv + 8)};
        mma_16816(s[ni], qf[kk], kb);
        mma_16816(dp[ni], da, vb);
      }
    }

    uint32_t dsf[BKV / 16][4];
#pragma unroll
    for (int ni = 0; ni < BKV / 8; ++ni) {
      bool keep[4] = {true, true, true, true};
      if (drop.on())
        keep_frag_rows(drop, (uint32_t)bh, row0, kt * BKV + ni * 8, lane, keep);
      float ds[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int key = kt * BKV + ni * 8 + 2 * t + (j & 1);
        const int row = (j >> 1) ? r1 : r0;
        const bool masked = key >= N || row >= N || (lsa && key == row);
        const float p = masked ? 0.f : exp2f(s[ni][j] - ((j >> 1) ? lse1 : lse0));
        const float z = drop.on() ? (keep[j] ? drop.scale : 0.f) : 1.f;
        ds[j] = p * (z * dp[ni][j] - ((j >> 1) ? del1 : del0));
      }
      dsf[ni >> 1][(ni & 1) * 2 + 0] = pack_bf16(ds[0], ds[1]);
      dsf[ni >> 1][(ni & 1) * 2 + 1] = pack_bf16(ds[2], ds[3]);
    }
    // dq += dS k: per 16-key step, one ldmatrix.x4.trans feeds two d-tiles
#pragma unroll
    for (int ks = 0; ks < BKV / 16; ++ks) {
#pragma unroll
      for (int di = 0; di < DP / 8; di += 2) {
        uint32_t r[4];
        ldmatrix_x4_trans(r, kt_s + (ks * 16 + (lane & 15)) * LD + di * 8 + (lane >> 4) * 8);
        const uint32_t b0[2] = {r[0], r[1]}, b1[2] = {r[2], r[3]};
        mma_16816(dq[di], dsf[ks], b0);
        mma_16816(dq[di + 1], dsf[ks], b1);
      }
    }
    __syncthreads();  // every warp is done with this stage before it refills
  }

  // dq = scale dq_acc, head-major; dscale partial = sum q_raw . dq_acc
  float dsc = 0.f;
  bf16* dqg = dqkv + bh * slab;
#pragma unroll
  for (int di = 0; di < DP / 8; ++di)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int row = (j >> 1) ? r1 : r0;
      const int col = di * 8 + 2 * t + (j & 1);
      if (row >= N) continue;
      if (col < D) dsc += to_f(qg[(size_t)row * DP + col]) * dq[di][j];
      dqg[(size_t)row * DP + col] = __float2bfloat16_rn(col < D ? dq[di][j] * sc_nat : 0.f);
    }
  dsc = warp_sum(dsc);
  if (lane == 0) atomicAdd(dscale + bh, dsc);
}

constexpr int PLD = CQ + 4;  // P^T hand-over rows (floats)

template <int DP>
constexpr int dkdv_smem_bytes() {
  return (2 * CK + 2 * 2 * CQ) * (DP + 8) * (int)sizeof(bf16) +
         (2 * 2 * CQ + CK * PLD) * (int)sizeof(float);
}

template <int DP>
__global__ void __launch_bounds__(THREADS, 1) attention_bwd_dkdv_kernel(
    const bf16* __restrict__ qkv, const bf16* __restrict__ dohm,
    const float* __restrict__ lse, const float* __restrict__ delta,
    const bf16* __restrict__ qs, bf16* __restrict__ dqkv, int B, int N, int H, int D,
    int lsa, Drop drop) {
  constexpr int LD = DP + 8, CHUNKS = DP / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Ks = reinterpret_cast<bf16*>(smem_raw);  // [CK][LD]
  bf16* Vs = Ks + CK * LD;                        // [CK][LD]
  bf16* Qs = Vs + CK * LD;                        // [2][CQ][LD], q_s
  bf16* dOs = Qs + 2 * CQ * LD;                   // [2][CQ][LD]
  float* Ls = reinterpret_cast<float*>(dOs + 2 * CQ * LD);  // [2][CQ]
  float* Dl = Ls + 2 * CQ;                                   // [2][CQ]
  float* Ps = Dl + 2 * CQ;                                   // [CK][PLD], P^T per pair

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int kb = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const size_t slab = (size_t)N * DP, bh = (size_t)b * H + h;
  const bf16* qg = qs + bh * slab;
  const bf16* kg = qkv + ((size_t)(B + b) * H + h) * slab;
  const bf16* vg = qkv + ((size_t)(2 * B + b) * H + h) * slab;
  const bf16* dog = dohm + bh * slab;
  const float* lrow = lse + bh * N;
  const float* drow = delta + bh * N;
  const bool p_warp = warp < 4;       // else the pair's dS warp
  const int pair = warp & 3;
  const int krow0 = pair * 16;        // the pair's 16 keys within the block
  const int key0 = kb * CK + krow0;
  float* p_pair = Ps + krow0 * PLD;   // the pair's P^T hand-over

  for (int i = tid; i < CK * CHUNKS; i += THREADS) {
    const int j = i / CHUNKS, c = (i % CHUNKS) * 8, key = kb * CK + j;
    const bool valid = key < N;
    const size_t off = valid ? (size_t)key * DP + c : 0;
    cp_async16(Ks + j * LD + c, kg + off, valid);
    cp_async16(Vs + j * LD + c, vg + off, valid);
  }
  auto load_tile = [&](int qtile, int stage) {
    bf16* qd = Qs + stage * CQ * LD;
    bf16* dd = dOs + stage * CQ * LD;
    for (int i = tid; i < CQ * CHUNKS; i += THREADS) {
      const int r = i / CHUNKS, c = (i % CHUNKS) * 8, row = qtile * CQ + r;
      const bool valid = row < N;
      const size_t off = valid ? (size_t)row * DP + c : 0;
      cp_async16(qd + r * LD + c, qg + off, valid);
      cp_async16(dd + r * LD + c, dog + off, valid);
    }
    if (tid < CQ) {
      const int row = qtile * CQ + tid;
      Ls[stage * CQ + tid] = row < N ? lrow[row] : 0.f;
      Dl[stage * CQ + tid] = row < N ? drow[row] : 0.f;
    }
    cp_async_commit();
  };
  const int ntiles = (N + CQ - 1) / CQ;
  load_tile(0, 0);  // commits the k/v rows with it

  float acc[DP / 8][4];
#pragma unroll
  for (int di = 0; di < DP / 8; ++di)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[di][j] = 0.f;

  for (int qt = 0; qt < ntiles; ++qt) {
    const int stage = qt & 1;
    if (qt + 1 < ntiles) {
      load_tile(qt + 1, stage ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* q_s = Qs + stage * CQ * LD;
    const bf16* do_s = dOs + stage * CQ * LD;
    const float* l_s = Ls + stage * CQ;
    const float* d_s = Dl + stage * CQ;

    // the P warp: S^T (16 keys x 64 queries) = k q_s^T; the dS warp:
    // dP^T = v dO^T. c[j]: key key0 + g (+8 for j >= 2), query
    // qt * CQ + ni * 8 + 2t + (j & 1)
    float c[CQ / 8][4];
#pragma unroll
    for (int ni = 0; ni < CQ / 8; ++ni)
#pragma unroll
      for (int j = 0; j < 4; ++j) c[ni][j] = 0.f;
    const bf16* arows = (p_warp ? Ks : Vs) + (krow0 + g) * LD + 2 * t;
    const bf16* bsrc = p_warp ? q_s : do_s;
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) {
      const bf16* pa = arows + kk * 16;
      const uint32_t a[4] = {ld_pair(pa), ld_pair(pa + 8 * LD), ld_pair(pa + 8),
                             ld_pair(pa + 8 * LD + 8)};
#pragma unroll
      for (int ni = 0; ni < CQ / 8; ++ni) {
        const bf16* pb = bsrc + (ni * 8 + g) * LD + kk * 16 + 2 * t;
        const uint32_t bb[2] = {ld_pair(pb), ld_pair(pb + 8)};
        mma_16816(c[ni], a, bb);
      }
    }

    // P^T goes to the dS warp through shared memory, with the keep bit as
    // its sign (P >= 0; a dropped P of 0 contributes 0 either way)
    uint32_t af[CQ / 16][4];
#pragma unroll
    for (int ni = 0; ni < CQ / 8; ++ni) {
      bool keep[4] = {true, true, true, true};
      if (p_warp && drop.on())
        keep_frag_cols(drop, (uint32_t)bh, key0, qt * CQ + ni * 8, lane, keep);
      float v[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int qc = ni * 8 + 2 * t + (j & 1), row = qt * CQ + qc;
        float* slot = p_pair + (g + (j >> 1) * 8) * PLD + qc;
        if (p_warp) {
          const int key = key0 + g + (j >> 1) * 8;
          const bool masked = key >= N || row >= N || (lsa && key == row);
          const float p = masked ? 0.f : exp2f(c[ni][j] - l_s[qc]);
          *slot = keep[j] ? p : -p;
          v[j] = keep[j] ? p : 0.f;  // the 1/keep scale is applied to dv at the end
        }
      }
      if (p_warp) {
        af[ni >> 1][(ni & 1) * 2 + 0] = pack_bf16(v[0], v[1]);
        af[ni >> 1][(ni & 1) * 2 + 1] = pack_bf16(v[2], v[3]);
      }
    }
    pair_barrier(pair);  // P^T of this tile is in p_pair
    if (!p_warp) {
#pragma unroll
      for (int ni = 0; ni < CQ / 8; ++ni) {
        float v[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int qc = ni * 8 + 2 * t + (j & 1);
          const float pk = p_pair[(g + (j >> 1) * 8) * PLD + qc];
          const float z = drop.on() ? (pk > 0.f ? drop.scale : 0.f) : 1.f;
          v[j] = fabsf(pk) * (z * c[ni][j] - d_s[qc]);
        }
        af[ni >> 1][(ni & 1) * 2 + 0] = pack_bf16(v[0], v[1]);
        af[ni >> 1][(ni & 1) * 2 + 1] = pack_bf16(v[2], v[3]);
      }
    }
    // dv += (Z P)^T dO, or dk += dS^T q_s: B from the query tile, transposed
    bsrc = p_warp ? do_s : q_s;
#pragma unroll
    for (int ks = 0; ks < CQ / 16; ++ks) {
#pragma unroll
      for (int di = 0; di < DP / 8; di += 2) {
        uint32_t r[4];
        ldmatrix_x4_trans(r, bsrc + (ks * 16 + (lane & 15)) * LD + di * 8 + (lane >> 4) * 8);
        const uint32_t b0[2] = {r[0], r[1]}, b1[2] = {r[2], r[3]};
        mma_16816(acc[di], af[ks], b0);
        mma_16816(acc[di + 1], af[ks], b1);
      }
    }
    __syncthreads();  // every warp is done with this stage before it refills
  }

  const float out_scale = p_warp ? (drop.on() ? drop.scale : 1.f) : LN2;
  bf16* dst = dqkv + ((size_t)((p_warp ? 2 : 1) * B + b) * H + h) * slab;
#pragma unroll
  for (int di = 0; di < DP / 8; ++di)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int key = key0 + g + (j >> 1) * 8;
      const int col = di * 8 + 2 * t + (j & 1);
      if (key < N)
        dst[(size_t)key * DP + col] = __float2bfloat16_rn(col < D ? acc[di][j] * out_scale : 0.f);
    }
}

template <int DP>
int launch(const void* qkv, const void* o, const void* dout, const void* lse,
           const void* scale, void* dqkv, void* dscale, void* qs, void* dohm, void* delta,
           int B, int N, int H, int D, int lsa, Drop drop, cudaStream_t stream) {
  const long long rows = (long long)B * H * N;
  attention_bwd_prep_kernel<<<(unsigned)((rows + THREADS / 32 - 1) / (THREADS / 32)), THREADS,
                              0, stream>>>((const bf16*)qkv, (const float*)scale,
                                           (const bf16*)o, (const bf16*)dout, (bf16*)qs,
                                           (bf16*)dohm, (float*)delta, B, N, H, D, DP);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  constexpr int dq_bytes = dq_smem_bytes<DP>();
  err = cudaFuncSetAttribute(attention_bwd_dq_kernel<DP>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, dq_bytes);
  if (err != cudaSuccess) return (int)err;
  attention_bwd_dq_kernel<DP><<<dim3((N + BQ - 1) / BQ, H, B), THREADS, dq_bytes, stream>>>(
      (const bf16*)qkv, (const bf16*)dohm, (const float*)lse, (const float*)delta,
      (const float*)scale, (bf16*)dqkv, (float*)dscale, B, N, H, D, lsa, drop);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  constexpr int kv_bytes = dkdv_smem_bytes<DP>();
  err = cudaFuncSetAttribute(attention_bwd_dkdv_kernel<DP>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, kv_bytes);
  if (err != cudaSuccess) return (int)err;
  attention_bwd_dkdv_kernel<DP><<<dim3((N + CK - 1) / CK, H, B), THREADS, kv_bytes, stream>>>(
      (const bf16*)qkv, (const bf16*)dohm, (const float*)lse, (const float*)delta,
      (const bf16*)qs, (bf16*)dqkv, B, N, H, D, lsa, drop);
  return (int)cudaGetLastError();
}

}  // namespace

// Returns a CUDA error code (0 on success). qkv (3, B, H, N, DP) bf16 as
// ln_linear wrote it for the forward; o and dout (B, N, H*D) bf16; lse
// (B, H, N) float32 from attention's training forward; scale (H,) float32.
// Writes dqkv (3, B, H, N, DP) bf16 (zero past D) and adds each (b, h)'s
// dscale partial into dscale (B, H) float32, which the caller zeroes.
// qs and dohm (B, H, N, DP) bf16 and delta (B, H, N) float32 are scratch. DP is
// 32, 64, 96, 128 or 160; threshold > 0 regenerates the probabilities' keep
// mask of (seed, site) (the forward's), scaling kept ones by drop_scale.
extern "C" int v1t_attention_bwd(const void* qkv, const void* o, const void* dout,
                                 const void* lse, const void* scale, void* dqkv, void* dscale,
                                 void* qs, void* dohm, void* delta, int B, int N, int H, int D,
                                 int DP,
                                 int lsa, unsigned seed, unsigned site, unsigned threshold,
                                 float drop_scale, void* stream) {
  const Drop drop{seed, site, threshold, drop_scale};
  cudaStream_t s = (cudaStream_t)stream;
  switch (DP) {
    case 32: return launch<32>(qkv, o, dout, lse, scale, dqkv, dscale, qs, dohm, delta, B, N, H, D, lsa, drop, s);
    case 64: return launch<64>(qkv, o, dout, lse, scale, dqkv, dscale, qs, dohm, delta, B, N, H, D, lsa, drop, s);
    case 96: return launch<96>(qkv, o, dout, lse, scale, dqkv, dscale, qs, dohm, delta, B, N, H, D, lsa, drop, s);
    case 128: return launch<128>(qkv, o, dout, lse, scale, dqkv, dscale, qs, dohm, delta, B, N, H, D, lsa, drop, s);
    case 160: return launch<160>(qkv, o, dout, lse, scale, dqkv, dscale, qs, dohm, delta, B, N, H, D, lsa, drop, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
