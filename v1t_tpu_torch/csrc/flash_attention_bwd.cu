// flash_attention_bwd: dq, dk, dv of flash_attention.cu's training forward,
//   o = dropout(softmax(q.k^T, masked)) v per (batch * head),
// from q, k, v as the forward read them, its output o, the cotangent dO, the
// natural-log LSE the forward returned and the LSE's own cotangent dlse.
//
// Replaces v1t_tpu/ops/flash_attention.py _flash_backward (:1088) and the
// kernels behind it: _flash_backward_merged (:1040) -> _merged_bwd_kernel
// (:954), _merged_bwd_kernel_fullk (:337), _dq_kernel (:840), _dkv_kernel
// (:887), and _flash_backward_dt (:769) -> _dq_kernel_dt (:646),
// _dkv_kernel_dt (:702); one function, ported once. delta = rowsum(dO . o)
// - dlse (:1093-1105: the LSE cotangent folds into delta exactly, since
// d lse_i / d s_ij = P_ij), P recomputed from the LSE, the keep mask Z
// (keep / (1 - rate), zero where dropped) regenerated from (seed, site):
//   dP = Z (dO . v), dS = P (dP - delta),
//   dq = dS k, dk = dS^T q, dv = (Z P)^T dO.
// q carries the softmax scale already (the scale's gradient flows through
// PyTorch's autograd of q * scale, as through XLA's in JAX). Keys at or past
// n_real_k and, with lsa, the diagonal are masked; Nq != Nk is allowed.
//
// bf16 at DP <= 160: one pass, the design of the TPU's _merged_bwd_kernel
// and of FlashAttention-3, on wgmma (hopper.cuh), between two small kernels:
// 1. prep: delta per (bh, row) and dO copied from o's strided layout into a
//    head-major (BH, Nq, DP) one, zero-padded from D to DP, so that the main
//    kernel streams it like q; the float32 dq accumulator is zeroed.
// 2. one pass: a block of two warpgroups owns 128 keys and loops over query
//    tiles of 64. One thread starts TMA copies of the block's K and V panels
//    once and of the tiles' q and dO into a 2-stage ring (mbarriers), 64
//    threads copy lse and delta with cp.async. Warpgroup c owns keys 64 c ..
//    64 c + 63: S = q k^T and dP = dO v^T with the tile's queries as wgmma's
//    M (m64nSKk16, both operands in shared memory, SK = 32 keys at a time
//    from DP 128 on, else 64), so that the keep mask maps onto the accumulator as in
//    the forward: one Philox draw per element per backward. Z P and dS = P
//    (Z dP - delta) go to shared memory as bf16, the A operands (read
//    transposed) of dV += (Z P)^T dO and dK += dS^T q (m64nDPk16,
//    accumulators in registers: DP fp32 a thread); then dq = dS k over the
//    block's 128 keys, the DP columns split between the two warpgroups at a
//    32-column boundary, added to the float32 accumulator four columns an
//    atomic. Five N^2 products. No producer warpgroup: its registers
//    (setmaxnreg) would leave the consumers fewer than the 255 a thread of a
//    256-thread block has, and dK, dV, S and dP need ~200.
// 3. convert: the accumulator rounded to bf16 into dq. The key blocks add
//    into it in no fixed order, so dq's float32 sums, and on rare ties its
//    bf16 rounding, may differ from run to run.
// bf16 at DP 192-256: dK and dV of 64 keys would take 192-256 fp32
// registers a thread beside S and dP, so these widths keep two passes on
// mma.sync m16n8k16 (the design of attention_bwd.cu): dq by 8
// warps of 16 rows with q and dO in shared memory, key tiles of 32; dkdv by
// 4 pairs of warps over 16 keys each, the P warp computing S^T, P^T and the
// keep mask and handing P^T over through shared memory (the keep bit as its
// sign), the dS warp dP^T and dS^T; query tiles of 32. 7 N^2 products.
// The dispatch on DP is the wrapper's (ops/flash_attention.py bwd_plan).
// float32 (FFMA, not TF32): dq by 256 threads over 64 rows, thread (ty, tx)
// owning rows 4 ty .. 4 ty + 3 and keys 2 tx, 2 tx + 1 of a 32-key tile for
// S and dP, then dq at columns tx + 16 j through dS^T in shared memory;
// dkdv over 64 keys and 32-query tiles, the same split with keys and queries
// swapped, dv then dk through one shared (Z P)^T / dS^T buffer.
//
// Bound on the H100: 10 * BH * Nq * Nk * D FLOP (five products): 14.4 TFLOP
// at the full-resolution shape (BH 8, N 34,114, D 155) = 14.6 ms of bf16
// tensor-core time; 1.09 TFLOP at the fp32 flagship (BH 256, N 1654) = 16.2
// ms at the fp32 rate. Bound by operations.
// Not yet: dq's partial sums go out as atomics, not as TMA's bulk
// reduce-add (its staging tile does not fit beside the panels at DP 160);
// the one pass's products and its P / dS arithmetic do not overlap within a
// warpgroup.
#include "hopper.cuh"


namespace {

constexpr int THREADS = 256;
constexpr float LOG2E = 1.4426950408889634f;

template <typename T>
__global__ void __launch_bounds__(THREADS) flash_bwd_prep_kernel(
    const T* __restrict__ o, const T* __restrict__ dout, const float* __restrict__ dlse,
    T* __restrict__ dohm, float* __restrict__ delta, int BH, int Nq, int D, int DP,
    RowLayout ol) {
  // one warp per (bh, row)
  const long long item = (long long)blockIdx.x * (THREADS / 32) + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (item >= (long long)BH * Nq) return;
  const int row = (int)(item % Nq), bh = (int)(item / Nq);
  const size_t src = ol.at(bh, row), hm = (size_t)item * DP;
  float acc = 0.f;
  for (int d = lane; d < DP; d += 32) {
    const float g = d < D ? to_f(dout[src + d]) : 0.f;
    if (d < D) acc += g * to_f(o[src + d]);
    store_f(dohm + hm + d, g);
  }
  acc = warp_sum(acc);
  if (lane == 0) delta[item] = acc - (dlse != nullptr ? dlse[item] : 0.f);
}

// ---------------------------------------------------------------------------
// bf16, DP <= 160: one pass on wgmma (hopper.cuh)

constexpr int ONE_PASS_MAX_DP = 160;
constexpr int KB = 128, QB = 64, BWG = 128, BWD_THREADS = 2 * BWG, BWD_STAGES = 2;

// dq's columns per consumer warpgroup: the first half of the DP / 32
// sub-tiles (rounded up) for the first, as many from there for the second;
// the two issue one product shape (a warpgroup-dependent shape would
// serialize the products), and columns at or past DP are computed from the
// next panel's bytes and dropped
template <int DP>
__host__ __device__ constexpr int dq_cols() { return 32 * ((DP / 32 + 1) / 2); }

// keys of one S / dP product: from DP 128 on, dK and dV take DP fp32
// registers a thread, and S and dP of 64 keys (64 more) spill
template <int DP>
__host__ __device__ constexpr int sdp_keys() { return DP >= 128 ? 32 : 64; }

// K and V panels [KB][DP]; per stage q and dO panels [QB][DP] and the
// tile's lse and delta rows; P and dS panels [QB][KB]; the mbarriers
template <int DP>
constexpr int one_pass_smem_bytes() {
  return 1024 + 2 * KB * DP * 2 + BWD_STAGES * (2 * QB * DP * 2 + 2 * QB * 4) +
         2 * QB * KB * 2 + (1 + BWD_STAGES) * 8;
}

template <int DP>
__global__ void __launch_bounds__(BWD_THREADS, 1) flash_bwd_one_pass_kernel(
    const __grid_constant__ CUtensorMap qmap, const __grid_constant__ CUtensorMap kmap,
    const __grid_constant__ CUtensorMap vmap, const __grid_constant__ CUtensorMap dmap,
    const float* __restrict__ lse, const float* __restrict__ delta, float* __restrict__ dq_acc,
    bf16* __restrict__ dk, bf16* __restrict__ dv, int Nq, int Nk, int n_real, int D, int lsa,
    Drop drop) {
  using namespace hopper;
  constexpr int KV_BYTES = KB * DP * 2, QP_BYTES = QB * DP * 2, PS_BYTES = QB * KB * 2;
  constexpr int DQC = dq_cols<DP>(), SK = sdp_keys<DP>();
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~(uintptr_t)1023);
  unsigned char* Ks = base;
  unsigned char* Vs = Ks + KV_BYTES;
  unsigned char* Qs = Vs + KV_BYTES;                  // [STAGES] q panels
  unsigned char* dOs = Qs + BWD_STAGES * QP_BYTES;    // [STAGES] dO panels
  unsigned char* Ps = dOs + BWD_STAGES * QP_BYTES;    // (Z P) [QB][KB]
  unsigned char* dSs = Ps + PS_BYTES;                 // dS [QB][KB]
  float* Ls = reinterpret_cast<float*>(dSs + PS_BYTES);  // [STAGES][QB] lse
  float* Dl = Ls + BWD_STAGES * QB;                      // [STAGES][QB] delta

  uint64_t* kv_full = reinterpret_cast<uint64_t*>(Dl + BWD_STAGES * QB);
  uint64_t* full = kv_full + 1;  // [STAGES] q and dO landed

  const int tid = threadIdx.x, kb = blockIdx.x, bh = blockIdx.y;
  const int ntiles = (Nq + QB - 1) / QB;
  const float* lrow = lse + (size_t)bh * Nq;
  const float* drow = delta + (size_t)bh * Nq;
  // thread 0 starts the TMA copies of a query tile's q and dO panels, 64
  // threads copy its lse and delta rows with cp.async; the copies of tile
  // it + 1 run while tile it is computed
  auto load_tile = [&](int it) {
    const int s = it % BWD_STAGES;
    if (tid == 0) {
      bar_expect(&full[s], 2 * QP_BYTES);
      tma_panel<DP>(Qs + s * QP_BYTES, &qmap, bh, it * QB, QB, &full[s]);
      tma_panel<DP>(dOs + s * QP_BYTES, &dmap, bh, it * QB, QB, &full[s]);
    }
    if (tid < QB) {
      const int row = it * QB + tid;
      cp_async4(Ls + s * QB + tid, lrow + (row < Nq ? row : 0), row < Nq);
      cp_async4(Dl + s * QB + tid, drow + (row < Nq ? row : 0), row < Nq);
    }
    cp_async_commit();
  };
  if (tid == 0) {
    bar_init(kv_full, 1);
    for (int s = 0; s < BWD_STAGES; ++s) bar_init(&full[s], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid == 0) {
    bar_expect(kv_full, 2 * KV_BYTES);
    tma_panel<DP>(Ks, &kmap, bh, kb * KB, KB, kv_full);
    tma_panel<DP>(Vs, &vmap, bh, kb * KB, KB, kv_full);
  }
  load_tile(0);

  // warpgroup c owns keys 64 c .. 64 c + 63 of the block for S, dP, dK and
  // dV, and dq's columns DQC c .. DQC c + DQC - 1 (those below DP) of every
  // query tile
  const int c = tid / BWG, lane = tid & 31, warp = (tid / 32) & 3;
  const int g = lane >> 2, t = lane & 3;
  const int kcol0 = 64 * c;  // the warpgroup's keys within the block
  const uint32_t k_s = smem_u32(Ks), v_s = smem_u32(Vs), q_s = smem_u32(Qs),
                 do_s = smem_u32(dOs), p_s = smem_u32(Ps), ds_s = smem_u32(dSs);
  float dk_acc[DP / 2], dv_acc[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) dk_acc[i] = dv_acc[i] = 0.f;

  bar_wait(kv_full, 0u);
  for (int it = 0; it < ntiles; ++it) {
    const int st = it % BWD_STAGES;
    cp_async_wait<0>();
    bar_wait(&full[st], (uint32_t)((it / BWD_STAGES) & 1));
    // tile it has landed, and every thread is done with tile it - 1 (its
    // stage, P and dS)
    __syncthreads();
    if (it + 1 < ntiles) load_tile(it + 1);
    const uint32_t qt_s = q_s + st * QP_BYTES, dot_s = do_s + st * QP_BYTES;
    const int lr0 = 16 * warp + g, lr1 = lr0 + 8;  // accumulator rows within the tile
    const int r0 = it * QB + lr0, r1 = it * QB + lr1;
    const float lse0 = Ls[st * QB + lr0] * LOG2E, lse1 = Ls[st * QB + lr1] * LOG2E;
    const float del0 = Dl[st * QB + lr0], del1 = Dl[st * QB + lr1];

    // S = q k^T and dP = dO v^T for the tile's 64 queries x SK of the
    // group's keys at a time; P and dS from them, the keep mask drawn once
    // per element (rows are queries, as in the forward)
#pragma unroll 1
    for (int h = 0; h < 64 / SK; ++h) {
      const int key0 = kcol0 + h * SK;  // within the block
      float s[SK / 2], dp[SK / 2];
      mma_fence();
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk)
        wgmma::Mma<SK>::template ss<0, 0>(s, desc_k(qt_s, QB, 0, kk), desc_k(k_s, KB, key0, kk),
                                          kk > 0);
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk)
        wgmma::Mma<SK>::template ss<0, 0>(dp, desc_k(dot_s, QB, 0, kk),
                                          desc_k(v_s, KB, key0, kk), kk > 0);
      mma_commit();
      mma_wait<0>();
      fence_regs(s);
      fence_regs(dp);
      // only a tile that reaches keys at or past n_real, queries at or past
      // Nq, or the diagonal under LSA is masked element by element
      const int kbase = kb * KB + key0, qbase = it * QB;
      const bool edge = kbase + SK > n_real || qbase + QB > Nq ||
                        (lsa && kbase < qbase + QB && kbase + SK > qbase);
#pragma unroll
      for (int ni = 0; ni < SK / 8; ++ni) {
        bool keep[4] = {true, true, true, true};
        if (drop.on())
          keep_frag_rows(drop, (uint32_t)bh, qbase + 16 * warp, kbase + ni * 8, lane, keep);
        float pk[4], ds[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float p = ex2(fmaf(s[4 * ni + e], LOG2E, -((e >> 1) ? lse1 : lse0)));
          if (edge) {
            const int key = kbase + ni * 8 + 2 * t + (e & 1), row = (e >> 1) ? r1 : r0;
            if (key >= n_real || row >= Nq || (lsa && key == row)) p = 0.f;
          }
          const float z = drop.on() ? (keep[e] ? drop.scale : 0.f) : 1.f;
          ds[e] = p * (z * dp[4 * ni + e] - ((e >> 1) ? del1 : del0));
          pk[e] = keep[e] ? p : 0.f;  // the 1/keep scale is applied to dv at the end
        }
        const int col = key0 + ni * 8 + 2 * t;
        *reinterpret_cast<uint32_t*>(Ps + elem_at(QB, lr0, col)) = pack_bf16(pk[0], pk[1]);
        *reinterpret_cast<uint32_t*>(Ps + elem_at(QB, lr1, col)) = pack_bf16(pk[2], pk[3]);
        *reinterpret_cast<uint32_t*>(dSs + elem_at(QB, lr0, col)) = pack_bf16(ds[0], ds[1]);
        *reinterpret_cast<uint32_t*>(dSs + elem_at(QB, lr1, col)) = pack_bf16(ds[2], ds[3]);
      }
    }
    fence_async_smem();
    __syncthreads();  // the whole tile's P and dS are in shared memory

    // dv += (Z P)^T dO, dk += dS^T q (M = the group's keys, K = the tile's
    // queries), dq[:, cols] = dS k (M = queries, K = the block's 128 keys)
    float dq[DQC / 2];
    mma_fence();
#pragma unroll
    for (int ks = 0; ks < QB / 16; ++ks)
      wgmma::Mma<DP>::template ss<1, 1>(dv_acc, desc_mn(p_s, QB, kcol0 / 32, ks),
                                        desc_mn(dot_s, QB, 0, ks), 1);
#pragma unroll
    for (int ks = 0; ks < QB / 16; ++ks)
      wgmma::Mma<DP>::template ss<1, 1>(dk_acc, desc_mn(ds_s, QB, kcol0 / 32, ks),
                                        desc_mn(qt_s, QB, 0, ks), 1);
#pragma unroll
    for (int ks = 0; ks < KB / 16; ++ks)
      wgmma::Mma<DQC>::template ss<0, 1>(dq, desc_k(ds_s, QB, 0, ks),
                                         desc_mn(k_s, KB, c * DQC / 32, ks), ks > 0);
    mma_commit();
    mma_wait<0>();
    fence_regs(dv_acc);
    fence_regs(dk_acc);
    fence_regs(dq);

    // dq's partial sums into the float32 accumulator, four columns an
    // atomic: lanes t and t ^ 1 swap halves so that an even lane holds
    // (row g, columns 2t .. 2t + 3) and an odd one (row g + 8, columns
    // 2t - 2 .. 2t + 1). The key blocks add in no fixed order. Columns D ..
    // DP - 1 add zeros (k is zero there); columns past DP are dropped.
    const int odd = t & 1, col0 = c * DQC + 2 * (t - odd);
    const int row = odd ? r1 : r0;
    float* acc_row = dq_acc + ((size_t)bh * Nq + row) * DP + col0;
#pragma unroll
    for (int i = 0; i < DQC / 8; ++i) {
      const float send0 = odd ? dq[4 * i + 0] : dq[4 * i + 2];
      const float send1 = odd ? dq[4 * i + 1] : dq[4 * i + 3];
      const float got0 = __shfl_xor_sync(0xffffffffu, send0, 1);
      const float got1 = __shfl_xor_sync(0xffffffffu, send1, 1);
      const float4 add = odd ? make_float4(got0, got1, dq[4 * i + 2], dq[4 * i + 3])
                             : make_float4(dq[4 * i + 0], dq[4 * i + 1], got0, got1);
      if (row < Nq && col0 + 8 * i < DP)
        atomicAdd(reinterpret_cast<float4*>(acc_row + 8 * i), add);
    }
  }

  // dk and dv of the group's 64 keys: accumulator rows are keys
  const float dv_scale = drop.on() ? drop.scale : 1.f;
#pragma unroll
  for (int i = 0; i < DP / 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int key = kb * KB + kcol0 + 16 * warp + g + 8 * (e >> 1);
      const int col = 8 * i + 2 * t + (e & 1);
      if (key < Nk) {
        const size_t at = ((size_t)bh * Nk + key) * DP + col;
        dk[at] = __float2bfloat16_rn(col < D ? dk_acc[4 * i + e] : 0.f);
        dv[at] = __float2bfloat16_rn(col < D ? dv_acc[4 * i + e] * dv_scale : 0.f);
      }
    }
}

// dq = the float32 accumulator rounded to bf16 (zero past D: never added to)
__global__ void __launch_bounds__(THREADS) flash_bwd_dq_convert_kernel(
    const float4* __restrict__ acc, bf16* __restrict__ dq, long long n4) {
  const long long i = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (i >= n4) return;
  const float4 x = acc[i];
  uint2 packed;
  packed.x = pack_bf16(x.x, x.y);
  packed.y = pack_bf16(x.z, x.w);
  reinterpret_cast<uint2*>(dq)[i] = packed;
}

// ---------------------------------------------------------------------------
// bf16, DP 192-256: two passes on mma.sync (dq, then dk and dv), where the
// one pass's dK and dV accumulators (DP fp32 registers a thread) do not fit

constexpr int BQ = 128;  // dq: query rows per block
constexpr int CK = 64;   // dkdv: keys per block

constexpr int DQ_BKV = 32;  // dq: keys per tile
constexpr int KV_CQ = 32;   // dkdv: queries per tile

template <int DP>
constexpr int dq_smem_bytes() {
  return (2 * BQ + 2 * 2 * DQ_BKV) * (DP + 8) * (int)sizeof(bf16);
}

template <int DP>
__global__ void __launch_bounds__(THREADS, 1) flash_bwd_dq_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    const bf16* __restrict__ dohm, const float* __restrict__ lse,
    const float* __restrict__ delta, bf16* __restrict__ dq, int Nq, int Nk, int n_real, int D,
    int lsa, Drop drop) {
  constexpr int BKV = DQ_BKV, LD = DP + 8, CHUNKS = DP / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);  // [BQ][LD]
  bf16* dOs = Qs + BQ * LD;                      // [BQ][LD]
  bf16* Ks = dOs + BQ * LD;                      // [2][BKV][LD]
  bf16* Vs = Ks + 2 * BKV * LD;                  // [2][BKV][LD]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int qt = blockIdx.x, bh = blockIdx.y;
  const bf16* qg = q + (size_t)bh * Nq * DP;
  const bf16* dog = dohm + (size_t)bh * Nq * DP;
  const bf16* kg = k + (size_t)bh * Nk * DP;
  const bf16* vg = v + (size_t)bh * Nk * DP;

  for (int i = tid; i < BQ * CHUNKS; i += THREADS) {
    const int r = i / CHUNKS, c = (i % CHUNKS) * 8, row = qt * BQ + r;
    const bool valid = row < Nq;
    const size_t off = valid ? (size_t)row * DP + c : 0;
    cp_async16(Qs + r * LD + c, qg + off, valid);
    cp_async16(dOs + r * LD + c, dog + off, valid);
  }
  auto load_tile = [&](int kt, int stage) {
    bf16* kd = Ks + stage * BKV * LD;
    bf16* vd = Vs + stage * BKV * LD;
    for (int i = tid; i < BKV * CHUNKS; i += THREADS) {
      const int j = i / CHUNKS, c = (i % CHUNKS) * 8, key = kt * BKV + j;
      const bool valid = key < Nk;
      const size_t off = valid ? (size_t)key * DP + c : 0;
      cp_async16(kd + j * LD + c, kg + off, valid);
      cp_async16(vd + j * LD + c, vg + off, valid);
    }
    cp_async_commit();
  };
  const int ntiles = (Nk + BKV - 1) / BKV;
  load_tile(0, 0);  // commits the q and dO rows with it

  const int row0 = qt * BQ + warp * 16;
  const int r0 = row0 + g, r1 = r0 + 8;
  const float* lrow = lse + (size_t)bh * Nq;
  const float* drow = delta + (size_t)bh * Nq;
  const float lse0 = r0 < Nq ? lrow[r0] * LOG2E : 0.f, lse1 = r1 < Nq ? lrow[r1] * LOG2E : 0.f;
  const float del0 = r0 < Nq ? drow[r0] : 0.f, del1 = r1 < Nq ? drow[r1] : 0.f;
  const bf16* qw = Qs + (warp * 16 + g) * LD + 2 * t;
  const bf16* dw = dOs + (warp * 16 + g) * LD + 2 * t;

  float acc[DP / 8][4];
#pragma unroll
  for (int di = 0; di < DP / 8; ++di)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[di][j] = 0.f;

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
      const uint32_t qa[4] = {ld_pair(qw + kk * 16), ld_pair(qw + kk * 16 + 8 * LD),
                              ld_pair(qw + kk * 16 + 8), ld_pair(qw + kk * 16 + 8 * LD + 8)};
      const uint32_t da[4] = {ld_pair(dw + kk * 16), ld_pair(dw + kk * 16 + 8 * LD),
                              ld_pair(dw + kk * 16 + 8), ld_pair(dw + kk * 16 + 8 * LD + 8)};
#pragma unroll
      for (int ni = 0; ni < BKV / 8; ++ni) {
        const bf16* pk = kt_s + (ni * 8 + g) * LD + kk * 16 + 2 * t;
        const bf16* pv = vt_s + (ni * 8 + g) * LD + kk * 16 + 2 * t;
        const uint32_t kb[2] = {ld_pair(pk), ld_pair(pk + 8)};
        const uint32_t vb[2] = {ld_pair(pv), ld_pair(pv + 8)};
        mma_16816(s[ni], qa, kb);
        mma_16816(dp[ni], da, vb);
      }
    }

    uint32_t dsf[BKV / 16][4];
#pragma unroll
    for (int ni = 0; ni < BKV / 8; ++ni) {
      bool keep[4] = {true, true, true, true};
      if (drop.on()) keep_frag_rows(drop, (uint32_t)bh, row0, kt * BKV + ni * 8, lane, keep);
      float ds[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int key = kt * BKV + ni * 8 + 2 * t + (j & 1);
        const int row = (j >> 1) ? r1 : r0;
        const bool masked = key >= n_real || row >= Nq || (lsa && key == row);
        const float p = masked ? 0.f : exp2f(s[ni][j] * LOG2E - ((j >> 1) ? lse1 : lse0));
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
        mma_16816(acc[di], dsf[ks], b0);
        mma_16816(acc[di + 1], dsf[ks], b1);
      }
    }
    __syncthreads();  // every warp is done with this stage before it refills
  }

  bf16* dqg = dq + (size_t)bh * Nq * DP;
#pragma unroll
  for (int di = 0; di < DP / 8; ++di)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int row = (j >> 1) ? r1 : r0;
      const int col = di * 8 + 2 * t + (j & 1);
      if (row < Nq) dqg[(size_t)row * DP + col] = __float2bfloat16_rn(col < D ? acc[di][j] : 0.f);
    }
}

template <int DP>
constexpr int dkdv_smem_bytes() {
  return (2 * CK + 2 * 2 * KV_CQ) * (DP + 8) * (int)sizeof(bf16) +
         (2 * 2 * KV_CQ + CK * (KV_CQ + 4)) * (int)sizeof(float);
}

template <int DP>
__global__ void __launch_bounds__(THREADS, 1) flash_bwd_dkdv_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    const bf16* __restrict__ dohm, const float* __restrict__ lse,
    const float* __restrict__ delta, bf16* __restrict__ dk, bf16* __restrict__ dv, int Nq,
    int Nk, int n_real, int D, int lsa, Drop drop) {
  constexpr int CQ = KV_CQ, LD = DP + 8, CHUNKS = DP / 8, PLD = CQ + 4;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Ks = reinterpret_cast<bf16*>(smem_raw);  // [CK][LD]
  bf16* Vs = Ks + CK * LD;                        // [CK][LD]
  bf16* Qs = Vs + CK * LD;                        // [2][CQ][LD]
  bf16* dOs = Qs + 2 * CQ * LD;                   // [2][CQ][LD]
  float* Ls = reinterpret_cast<float*>(dOs + 2 * CQ * LD);  // [2][CQ], lse * log2 e
  float* Dl = Ls + 2 * CQ;                                   // [2][CQ]
  float* Ps = Dl + 2 * CQ;                                   // [CK][PLD], P^T per pair

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int kb = blockIdx.x, bh = blockIdx.y;
  const bf16* qg = q + (size_t)bh * Nq * DP;
  const bf16* dog = dohm + (size_t)bh * Nq * DP;
  const bf16* kg = k + (size_t)bh * Nk * DP;
  const bf16* vg = v + (size_t)bh * Nk * DP;
  const float* lrow = lse + (size_t)bh * Nq;
  const float* drow = delta + (size_t)bh * Nq;
  const bool p_warp = warp < 4;  // else the pair's dS warp
  const int pair = warp & 3;
  const int krow0 = pair * 16;   // the pair's 16 keys within the block
  const int key0 = kb * CK + krow0;
  float* p_pair = Ps + krow0 * PLD;

  for (int i = tid; i < CK * CHUNKS; i += THREADS) {
    const int j = i / CHUNKS, c = (i % CHUNKS) * 8, key = kb * CK + j;
    const bool valid = key < Nk;
    const size_t off = valid ? (size_t)key * DP + c : 0;
    cp_async16(Ks + j * LD + c, kg + off, valid);
    cp_async16(Vs + j * LD + c, vg + off, valid);
  }
  auto load_tile = [&](int qtile, int stage) {
    bf16* qd = Qs + stage * CQ * LD;
    bf16* dd = dOs + stage * CQ * LD;
    for (int i = tid; i < CQ * CHUNKS; i += THREADS) {
      const int r = i / CHUNKS, c = (i % CHUNKS) * 8, row = qtile * CQ + r;
      const bool valid = row < Nq;
      const size_t off = valid ? (size_t)row * DP + c : 0;
      cp_async16(qd + r * LD + c, qg + off, valid);
      cp_async16(dd + r * LD + c, dog + off, valid);
    }
    if (tid < CQ) {
      const int row = qtile * CQ + tid;
      Ls[stage * CQ + tid] = row < Nq ? lrow[row] * LOG2E : 0.f;
      Dl[stage * CQ + tid] = row < Nq ? drow[row] : 0.f;
    }
    cp_async_commit();
  };
  const int ntiles = (Nq + CQ - 1) / CQ;
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

    // the P warp: S^T (16 keys x CQ queries) = k q^T; the dS warp:
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
      float val[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int qc = ni * 8 + 2 * t + (j & 1), row = qt * CQ + qc;
        float* slot = p_pair + (g + (j >> 1) * 8) * PLD + qc;
        if (p_warp) {
          const int key = key0 + g + (j >> 1) * 8;
          const bool masked = key >= n_real || row >= Nq || (lsa && key == row);
          const float p = masked ? 0.f : exp2f(c[ni][j] * LOG2E - l_s[qc]);
          *slot = keep[j] ? p : -p;
          val[j] = keep[j] ? p : 0.f;  // the 1/keep scale is applied to dv at the end
        }
      }
      if (p_warp) {
        af[ni >> 1][(ni & 1) * 2 + 0] = pack_bf16(val[0], val[1]);
        af[ni >> 1][(ni & 1) * 2 + 1] = pack_bf16(val[2], val[3]);
      }
    }
    pair_barrier(pair);  // P^T of this tile is in p_pair
    if (!p_warp) {
#pragma unroll
      for (int ni = 0; ni < CQ / 8; ++ni) {
        float val[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int qc = ni * 8 + 2 * t + (j & 1);
          const float pk = p_pair[(g + (j >> 1) * 8) * PLD + qc];
          const float z = drop.on() ? (pk > 0.f ? drop.scale : 0.f) : 1.f;
          val[j] = fabsf(pk) * (z * c[ni][j] - d_s[qc]);
        }
        af[ni >> 1][(ni & 1) * 2 + 0] = pack_bf16(val[0], val[1]);
        af[ni >> 1][(ni & 1) * 2 + 1] = pack_bf16(val[2], val[3]);
      }
    }
    // dv += (Z P)^T dO, or dk += dS^T q: B from the query tile, transposed
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

  const float out_scale = p_warp && drop.on() ? drop.scale : 1.f;
  bf16* dst = (p_warp ? dv : dk) + (size_t)bh * Nk * DP;
#pragma unroll
  for (int di = 0; di < DP / 8; ++di)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int key = key0 + g + (j >> 1) * 8;
      const int col = di * 8 + 2 * t + (j & 1);
      if (key < Nk)
        dst[(size_t)key * DP + col] = __float2bfloat16_rn(col < D ? acc[di][j] * out_scale : 0.f);
    }
}

// ---------------------------------------------------------------------------
// float32

constexpr int GQ = 64, GK = 32;  // dq: rows per block, key tile
constexpr int HK = 64, HQ = 32;  // dkdv: keys per block, query tile
constexpr int WLD = 68, NLD = 36;  // strides of the 64- and 32-wide transposed tiles

template <int DP>
constexpr int f32_smem_bytes() {
  // two [DP][WLD] tiles, two [DP][NLD] tiles, one [32][WLD] buffer, two rows of 64
  return (2 * DP * WLD + 2 * DP * NLD + 32 * WLD + 2 * 64) * (int)sizeof(float);
}

// rows r0 .. r0 + rows - 1 of a (rows_total, DP) float32 operand into a
// transposed [DP][ld] shared tile (zero past rows_total)
template <int DP>
__device__ __forceinline__ void load_transposed(float* dst, int ld, const float* __restrict__ src,
                                                int r0, int rows, int rows_total) {
  constexpr int C4 = DP / 4;
  for (int i = threadIdx.x; i < rows * C4; i += THREADS) {
    const int r = i / C4, c = (i % C4) * 4, row = r0 + r;
    const float4 x = row < rows_total
                         ? *reinterpret_cast<const float4*>(src + (size_t)row * DP + c)
                         : make_float4(0.f, 0.f, 0.f, 0.f);
    dst[(c + 0) * ld + r] = x.x;
    dst[(c + 1) * ld + r] = x.y;
    dst[(c + 2) * ld + r] = x.z;
    dst[(c + 3) * ld + r] = x.w;
  }
}

template <int DP>
__global__ void __launch_bounds__(THREADS, 1) flash_bwd_dq_f32_kernel(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    const float* __restrict__ dohm, const float* __restrict__ lse,
    const float* __restrict__ delta, float* __restrict__ dq, int Nq, int Nk, int n_real, int D,
    int lsa, Drop drop) {
  constexpr int NJ = DP / 16;
  extern __shared__ __align__(16) float fsm[];
  float* Qt = fsm;              // [DP][WLD]
  float* dOt = Qt + DP * WLD;   // [DP][WLD]
  float* Kt = dOt + DP * WLD;   // [DP][NLD]
  float* Vt = Kt + DP * NLD;    // [DP][NLD]
  float* Ws = Vt + DP * NLD;    // [GK][WLD], dS^T
  float* Ls = Ws + 32 * WLD;    // [GQ], lse * log2 e
  float* Dl = Ls + 64;          // [GQ]

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int qt = blockIdx.x, bh = blockIdx.y;
  const size_t qoff = (size_t)bh * Nq * DP, koff = (size_t)bh * Nk * DP;
  load_transposed<DP>(Qt, WLD, q + qoff, qt * GQ, GQ, Nq);
  load_transposed<DP>(dOt, WLD, dohm + qoff, qt * GQ, GQ, Nq);
  if (tid < GQ) {
    const int row = qt * GQ + tid;
    Ls[tid] = row < Nq ? lse[(size_t)bh * Nq + row] * LOG2E : 0.f;
    Dl[tid] = row < Nq ? delta[(size_t)bh * Nq + row] : 0.f;
  }

  float acc[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.f;

  const int ntiles = (Nk + GK - 1) / GK;
  for (int kt = 0; kt < ntiles; ++kt) {
    __syncthreads();  // every thread is done with the previous tile
    load_transposed<DP>(Kt, NLD, k + koff, kt * GK, GK, Nk);
    load_transposed<DP>(Vt, NLD, v + koff, kt * GK, GK, Nk);
    __syncthreads();

    float s[4][2], dp[4][2];
#pragma unroll
    for (int i = 0; i < 4; ++i) s[i][0] = s[i][1] = dp[i][0] = dp[i][1] = 0.f;
#pragma unroll 4
    for (int d = 0; d < DP; ++d) {
      const float4 a = *reinterpret_cast<const float4*>(Qt + d * WLD + ty * 4);
      const float4 c = *reinterpret_cast<const float4*>(dOt + d * WLD + ty * 4);
      const float2 b = *reinterpret_cast<const float2*>(Kt + d * NLD + tx * 2);
      const float2 e = *reinterpret_cast<const float2*>(Vt + d * NLD + tx * 2);
      const float av[4] = {a.x, a.y, a.z, a.w}, cv[4] = {c.x, c.y, c.z, c.w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        s[i][0] = fmaf(av[i], b.x, s[i][0]);
        s[i][1] = fmaf(av[i], b.y, s[i][1]);
        dp[i][0] = fmaf(cv[i], e.x, dp[i][0]);
        dp[i][1] = fmaf(cv[i], e.y, dp[i][1]);
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = qt * GQ + ty * 4 + i, key_pair = kt * GK + tx * 2;
      uint4 w = make_uint4(0u, 0u, 0u, 0u);
      if (drop.on()) w = keep_words(drop, (uint32_t)bh, (uint32_t)row, (uint32_t)key_pair >> 2);
      float ds[2];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int key = key_pair + j;
        const bool masked = key >= n_real || row >= Nq || (lsa && key == row);
        const float p = masked ? 0.f : exp2f(s[i][j] * LOG2E - Ls[ty * 4 + i]);
        const float z =
            drop.on() ? (word_of(w, (key_pair & 3) + j) < drop.threshold ? drop.scale : 0.f) : 1.f;
        ds[j] = p * (z * dp[i][j] - Dl[ty * 4 + i]);
      }
      Ws[(tx * 2 + 0) * WLD + ty * 4 + i] = ds[0];
      Ws[(tx * 2 + 1) * WLD + ty * 4 + i] = ds[1];
    }
    __syncthreads();
#pragma unroll 4
    for (int kk = 0; kk < GK; ++kk) {
      const float4 d4 = *reinterpret_cast<const float4*>(Ws + kk * WLD + ty * 4);
      const float dv4[4] = {d4.x, d4.y, d4.z, d4.w};
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const float kv = Kt[(tx + 16 * j) * NLD + kk];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(dv4[i], kv, acc[i][j]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = qt * GQ + ty * 4 + i;
    if (row >= Nq) continue;
    float* dst = dq + ((size_t)bh * Nq + row) * DP;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int col = tx + 16 * j;
      dst[col] = col < D ? acc[i][j] : 0.f;
    }
  }
}

template <int DP>
__global__ void __launch_bounds__(THREADS, 1) flash_bwd_dkdv_f32_kernel(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    const float* __restrict__ dohm, const float* __restrict__ lse,
    const float* __restrict__ delta, float* __restrict__ dk, float* __restrict__ dv, int Nq,
    int Nk, int n_real, int D, int lsa, Drop drop) {
  constexpr int NJ = DP / 16;
  extern __shared__ __align__(16) float fsm[];
  float* Kt = fsm;              // [DP][WLD]
  float* Vt = Kt + DP * WLD;    // [DP][WLD]
  float* Qt = Vt + DP * WLD;    // [DP][NLD]
  float* dOt = Qt + DP * NLD;   // [DP][NLD]
  float* Ws = dOt + DP * NLD;   // [HQ][WLD], (Z P)^T then dS^T
  float* Ls = Ws + 32 * WLD;    // [HQ], lse * log2 e
  float* Dl = Ls + 64;          // [HQ]

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int kb = blockIdx.x, bh = blockIdx.y;
  const size_t qoff = (size_t)bh * Nq * DP, koff = (size_t)bh * Nk * DP;
  load_transposed<DP>(Kt, WLD, k + koff, kb * HK, HK, Nk);
  load_transposed<DP>(Vt, WLD, v + koff, kb * HK, HK, Nk);
  const int key_base = kb * HK + ty * 4;  // this thread's 4 keys (one Philox group)

  float adk[4][NJ], adv[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) adk[i][j] = adv[i][j] = 0.f;

  const int ntiles = (Nq + HQ - 1) / HQ;
  for (int qt = 0; qt < ntiles; ++qt) {
    __syncthreads();  // every thread is done with the previous tile
    load_transposed<DP>(Qt, NLD, q + qoff, qt * HQ, HQ, Nq);
    load_transposed<DP>(dOt, NLD, dohm + qoff, qt * HQ, HQ, Nq);
    if (tid < HQ) {
      const int row = qt * HQ + tid;
      Ls[tid] = row < Nq ? lse[(size_t)bh * Nq + row] * LOG2E : 0.f;
      Dl[tid] = row < Nq ? delta[(size_t)bh * Nq + row] : 0.f;
    }
    __syncthreads();

    // S^T and dP^T for keys 4 ty + i and queries 2 tx + j
    float s[4][2], dp[4][2];
#pragma unroll
    for (int i = 0; i < 4; ++i) s[i][0] = s[i][1] = dp[i][0] = dp[i][1] = 0.f;
#pragma unroll 4
    for (int d = 0; d < DP; ++d) {
      const float4 a = *reinterpret_cast<const float4*>(Kt + d * WLD + ty * 4);
      const float4 c = *reinterpret_cast<const float4*>(Vt + d * WLD + ty * 4);
      const float2 b = *reinterpret_cast<const float2*>(Qt + d * NLD + tx * 2);
      const float2 e = *reinterpret_cast<const float2*>(dOt + d * NLD + tx * 2);
      const float av[4] = {a.x, a.y, a.z, a.w}, cv[4] = {c.x, c.y, c.z, c.w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        s[i][0] = fmaf(av[i], b.x, s[i][0]);
        s[i][1] = fmaf(av[i], b.y, s[i][1]);
        dp[i][0] = fmaf(cv[i], e.x, dp[i][0]);
        dp[i][1] = fmaf(cv[i], e.y, dp[i][1]);
      }
    }
    float zp[2][4], ds[2][4];
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int qc = tx * 2 + j, row = qt * HQ + qc;
      uint4 w = make_uint4(0u, 0u, 0u, 0u);
      if (drop.on()) w = keep_words(drop, (uint32_t)bh, (uint32_t)row, (uint32_t)key_base >> 2);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int key = key_base + i;
        const bool masked = key >= n_real || row >= Nq || (lsa && key == row);
        const float p = masked ? 0.f : exp2f(s[i][j] * LOG2E - Ls[qc]);
        const float z = drop.on() ? (word_of(w, i) < drop.threshold ? drop.scale : 0.f) : 1.f;
        zp[j][i] = z * p;
        ds[j][i] = p * (z * dp[i][j] - Dl[qc]);
      }
    }
    // dv += (Z P)^T dO, then dk += dS^T q, through one buffer
#pragma unroll
    for (int pass = 0; pass < 2; ++pass) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const float* src = pass ? ds[j] : zp[j];
        *reinterpret_cast<float4*>(Ws + (tx * 2 + j) * WLD + ty * 4) =
            make_float4(src[0], src[1], src[2], src[3]);
      }
      __syncthreads();
      const float* opnd = pass ? Qt : dOt;
#pragma unroll 4
      for (int qq = 0; qq < HQ; ++qq) {
        const float4 w4 = *reinterpret_cast<const float4*>(Ws + qq * WLD + ty * 4);
        const float wv[4] = {w4.x, w4.y, w4.z, w4.w};
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          const float x = opnd[(tx + 16 * j) * NLD + qq];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            if (pass) adk[i][j] = fmaf(wv[i], x, adk[i][j]);
            else adv[i][j] = fmaf(wv[i], x, adv[i][j]);
          }
        }
      }
      __syncthreads();  // the buffer is free for the next pass
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int key = key_base + i;
    if (key >= Nk) continue;
    float* dkr = dk + ((size_t)bh * Nk + key) * DP;
    float* dvr = dv + ((size_t)bh * Nk + key) * DP;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int col = tx + 16 * j;
      dkr[col] = col < D ? adk[i][j] : 0.f;
      dvr[col] = col < D ? adv[i][j] : 0.f;
    }
  }
}

// ---------------------------------------------------------------------------

template <int DP>
int launch(bool f32, const void* q, const void* k, const void* v, const void* o,
           const void* dout, const void* lse, const void* dlse, void* dq, void* dk, void* dv,
           void* dohm, void* delta, void* dq_acc, int BH, int Nq, int Nk, int n_real, int D,
           RowLayout ol, int lsa, Drop drop, cudaStream_t stream) {
  const long long rows = (long long)BH * Nq;
  const unsigned prep_blocks = (unsigned)((rows + THREADS / 32 - 1) / (THREADS / 32));
  cudaError_t err;
  if (f32) {
    flash_bwd_prep_kernel<float><<<prep_blocks, THREADS, 0, stream>>>(
        (const float*)o, (const float*)dout, (const float*)dlse, (float*)dohm, (float*)delta,
        BH, Nq, D, DP, ol);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    constexpr int bytes = f32_smem_bytes<DP>();
    err = cudaFuncSetAttribute(flash_bwd_dq_f32_kernel<DP>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return (int)err;
    flash_bwd_dq_f32_kernel<DP><<<dim3((Nq + GQ - 1) / GQ, BH), THREADS, bytes, stream>>>(
        (const float*)q, (const float*)k, (const float*)v, (const float*)dohm,
        (const float*)lse, (const float*)delta, (float*)dq, Nq, Nk, n_real, D, lsa, drop);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    err = cudaFuncSetAttribute(flash_bwd_dkdv_f32_kernel<DP>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return (int)err;
    flash_bwd_dkdv_f32_kernel<DP><<<dim3((Nk + HK - 1) / HK, BH), THREADS, bytes, stream>>>(
        (const float*)q, (const float*)k, (const float*)v, (const float*)dohm,
        (const float*)lse, (const float*)delta, (float*)dk, (float*)dv, Nq, Nk, n_real, D, lsa,
        drop);
    return (int)cudaGetLastError();
  }
  flash_bwd_prep_kernel<bf16><<<prep_blocks, THREADS, 0, stream>>>(
      (const bf16*)o, (const bf16*)dout, (const float*)dlse, (bf16*)dohm, (float*)delta, BH, Nq,
      D, DP, ol);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  if constexpr (DP <= ONE_PASS_MAX_DP) {
    if (dq_acc == nullptr) return (int)cudaErrorInvalidValue;
    const long long n4 = rows * DP / 4;
    err = cudaMemsetAsync(dq_acc, 0, (size_t)n4 * 16, stream);
    if (err != cudaSuccess) return (int)err;
    constexpr int bytes = one_pass_smem_bytes<DP>();
    err = cudaFuncSetAttribute(flash_bwd_one_pass_kernel<DP>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return (int)err;
    CUtensorMap qmap, kmap, vmap, dmap;
    int rc;
    if ((rc = hopper::make_panel_map(&qmap, q, BH, Nq, DP, QB)) != 0 ||
        (rc = hopper::make_panel_map(&dmap, dohm, BH, Nq, DP, QB)) != 0 ||
        (rc = hopper::make_panel_map(&kmap, k, BH, Nk, DP, KB)) != 0 ||
        (rc = hopper::make_panel_map(&vmap, v, BH, Nk, DP, KB)) != 0)
      return rc;
    flash_bwd_one_pass_kernel<DP><<<dim3((Nk + KB - 1) / KB, BH), BWD_THREADS, bytes, stream>>>(
        qmap, kmap, vmap, dmap, (const float*)lse, (const float*)delta, (float*)dq_acc,
        (bf16*)dk, (bf16*)dv, Nq, Nk, n_real, D, lsa, drop);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    flash_bwd_dq_convert_kernel<<<(unsigned)((n4 + THREADS - 1) / THREADS), THREADS, 0, stream>>>(
        (const float4*)dq_acc, (bf16*)dq, n4);
    return (int)cudaGetLastError();
  } else {
    constexpr int dq_bytes = dq_smem_bytes<DP>();
    err = cudaFuncSetAttribute(flash_bwd_dq_kernel<DP>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, dq_bytes);
    if (err != cudaSuccess) return (int)err;
    flash_bwd_dq_kernel<DP><<<dim3((Nq + BQ - 1) / BQ, BH), THREADS, dq_bytes, stream>>>(
        (const bf16*)q, (const bf16*)k, (const bf16*)v, (const bf16*)dohm, (const float*)lse,
        (const float*)delta, (bf16*)dq, Nq, Nk, n_real, D, lsa, drop);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    constexpr int kv_bytes = dkdv_smem_bytes<DP>();
    err = cudaFuncSetAttribute(flash_bwd_dkdv_kernel<DP>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, kv_bytes);
    if (err != cudaSuccess) return (int)err;
    flash_bwd_dkdv_kernel<DP><<<dim3((Nk + CK - 1) / CK, BH), THREADS, kv_bytes, stream>>>(
        (const bf16*)q, (const bf16*)k, (const bf16*)v, (const bf16*)dohm, (const float*)lse,
        (const float*)delta, (bf16*)dk, (bf16*)dv, Nq, Nk, n_real, D, lsa, drop);
    return (int)cudaGetLastError();
  }
}

}  // namespace

// Returns a CUDA error code (0 on success). q (BH, Nq, DP), k, v (BH, Nk,
// DP) as the forward read them (bf16 when f32 == 0, float32 when 1; DP =
// 32, 64, ..., 256); o and dout at element (bh, row, d) -> (bh / H) *
// o_batch + (bh % H) * o_head + row * o_row + d, d < D, in the same dtype;
// lse (BH, Nq) float32 natural log from the forward; dlse (BH, Nq) float32
// or null. Writes dq (BH, Nq, DP), dk and dv (BH, Nk, DP), zero past D.
// dohm (BH, Nq, DP) in the dtype and delta (BH, Nq) float32 are scratch,
// and dq_acc (BH, Nq, DP) float32 for bf16 at DP <= 160 (null otherwise).
// threshold > 0 regenerates the forward's keep mask of (seed, site).
extern "C" int v1t_flash_attention_bwd(const void* q, const void* k, const void* v,
                                       const void* o, const void* dout, const void* lse,
                                       const void* dlse, void* dq, void* dk, void* dv,
                                       void* dohm, void* delta, void* dq_acc, int BH,
                                       int Nq, int Nk, int n_real_k, int D, int DP, int H,
                                       int o_batch, int o_head, int o_row, int f32, int lsa,
                                       unsigned seed, unsigned site, unsigned threshold,
                                       float drop_scale, void* stream) {
  if (BH < 1 || BH > 65535 || H < 1 || D > DP || n_real_k > Nk || Nq < 1 || Nk < 1)
    return (int)cudaErrorInvalidValue;
  const Drop drop{seed, site, threshold, drop_scale};
  const RowLayout ol{H, o_batch, o_head, o_row};
  cudaStream_t s = (cudaStream_t)stream;
  const bool f = f32 != 0;
  switch (DP) {
    case 32: return launch<32>(f, q, k, v, o, dout, lse, dlse, dq, dk, dv, dohm, delta, dq_acc, BH, Nq, Nk, n_real_k, D, ol, lsa, drop, s);
    case 64: return launch<64>(f, q, k, v, o, dout, lse, dlse, dq, dk, dv, dohm, delta, dq_acc, BH, Nq, Nk, n_real_k, D, ol, lsa, drop, s);
    case 96: return launch<96>(f, q, k, v, o, dout, lse, dlse, dq, dk, dv, dohm, delta, dq_acc, BH, Nq, Nk, n_real_k, D, ol, lsa, drop, s);
    case 128: return launch<128>(f, q, k, v, o, dout, lse, dlse, dq, dk, dv, dohm, delta, dq_acc, BH, Nq, Nk, n_real_k, D, ol, lsa, drop, s);
    case 160: return launch<160>(f, q, k, v, o, dout, lse, dlse, dq, dk, dv, dohm, delta, dq_acc, BH, Nq, Nk, n_real_k, D, ol, lsa, drop, s);
    case 192: return launch<192>(f, q, k, v, o, dout, lse, dlse, dq, dk, dv, dohm, delta, dq_acc, BH, Nq, Nk, n_real_k, D, ol, lsa, drop, s);
    case 224: return launch<224>(f, q, k, v, o, dout, lse, dlse, dq, dk, dv, dohm, delta, dq_acc, BH, Nq, Nk, n_real_k, D, ol, lsa, drop, s);
    case 256: return launch<256>(f, q, k, v, o, dout, lse, dlse, dq, dk, dv, dohm, delta, dq_acc, BH, Nq, Nk, n_real_k, D, ol, lsa, drop, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

namespace {
template <int DP>
int bf16_bwd_smem() {
  if constexpr (DP <= ONE_PASS_MAX_DP) return one_pass_smem_bytes<DP>();
  else return dq_smem_bytes<DP>() > dkdv_smem_bytes<DP>() ? dq_smem_bytes<DP>()
                                                           : dkdv_smem_bytes<DP>();
}
}  // namespace

// Dynamic shared memory of a block of the bf16 backward's main kernel (the
// larger of dq and dkdv above ONE_PASS_MAX_DP) at padded head width dp (0
// for a width it is not built for).
extern "C" int v1t_flash_attention_bwd_smem(int dp) {
  switch (dp) {
    case 32: return bf16_bwd_smem<32>();
    case 64: return bf16_bwd_smem<64>();
    case 96: return bf16_bwd_smem<96>();
    case 128: return bf16_bwd_smem<128>();
    case 160: return bf16_bwd_smem<160>();
    case 192: return bf16_bwd_smem<192>();
    case 224: return bf16_bwd_smem<224>();
    case 256: return bf16_bwd_smem<256>();
    default: return 0;
  }
}
