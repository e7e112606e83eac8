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
// A masked key keeps the forward's masked score, so that a row with every
// key masked (LSA at N 1) spreads P over them as the plain version does;
// keys past Nk and queries past Nq (the tiles' zero fill) weigh nothing.
//
// bf16: one pass, the design of the TPU's _merged_bwd_kernel and of
// FlashAttention-3, on wgmma (hopper.cuh), between two small kernels:
// 1. prep: delta per (bh, row) and dO copied from o's strided layout into a
//    head-major (BH, Nq, DP) one, zero-padded from D to DP, so that the main
//    kernel streams it like q; the float32 dq accumulator is zeroed.
// 2. one pass: a block of two warpgroups owns a block of keys and loops
//    over query tiles of 64. One thread starts TMA copies of the block's K
//    and V panels once and of the tiles' q and dO into a 2-stage ring
//    (mbarriers), 64 threads copy lse and delta with cp.async. S = q k^T and
//    dP = dO v^T take the tile's queries as wgmma's M (m64nSKk16, both
//    operands in shared memory), so that the keep mask maps onto the
//    accumulator as in the forward: one Philox draw per element per
//    backward. Z P and dS = P (Z dP - delta) go to shared memory as bf16,
//    the A operands (read transposed) of dV += (Z P)^T dO and dK += dS^T q
//    (accumulators in registers); then dq = dS k over the block's keys, the
//    DP columns split between the two warpgroups at a 32-column boundary,
//    added to the float32 accumulator four columns an atomic. Five N^2
//    products. No producer warpgroup: its registers (setmaxnreg) would leave
//    the consumers fewer than the 255 a thread of a 256-thread block has.
//    Up to DP 160 (WIDE_DP) a block owns 128 keys and warpgroup c keys 64 c
//    .. 64 c + 63, for S and dP (SK = 32 keys at a time from DP 128 on, else
//    64) and for dK and dV (m64nDPk16: DP fp32 a thread each). Above, dK and
//    dV of 64 keys would be 2 DP fp32 registers a thread beside S and dP:
//    a block owns 64 keys, warpgroup c computes S and dP of keys 32 c .. 32
//    c + 31 (m64n32k16) and, after a barrier of the block, dK and dV of all
//    64 keys for its half of the columns (m64n(DP/2)k16 at the dq split:
//    64 + 64 fp32 at DP 256). No product is computed twice; q and dO are
//    streamed once per 64 keys instead of 128, and dq's partial sums, twice
//    as many, leave through a float32 box a warp in shared memory that
//    TMA's bulk reduce-add adds into the accumulator (whole lines instead
//    of 16-byte atomics).
// 3. convert: the accumulator rounded to bf16 into dq. The key blocks add
//    into it in no fixed order, so dq's float32 sums, and on rare ties its
//    bf16 rounding, may differ from run to run.
// The one pass is generic over the scores' units (one_pass_bwd.cuh): P =
// exp2(s_log2 (q.k - lse)) and dk = dk_scale dS^T q. This file launches it
// with s_log2 = log2 e and dk_scale = 1; attention_bwd.cu, whose q_s and LSE
// are in log2 units, with 1 and ln 2, between its own prep and convert.
// The tiling at each DP is mirrored by ops/flash_attention.py bwd_plan.
//
// float32 (FFMA, not TF32: the fp32 path's users want float32 arithmetic):
// prep, dq zeroed, then one pass over key blocks with the five products on
// the FMA pipes. A block of 256 threads owns 64 keys (32 from DP 192 on)
// and loops over query tiles of 32, whose q, dO, lse and delta arrive by
// cp.async into a 2-stage ring while the previous tile is computed; K and V
// stay in shared memory. Every tile is row-major with rows padded by four
// floats, and every product reads float4s along rows, so no tile is
// transposed and no access conflicts on the banks:
//   S^T = K q^T (the first half of the block) and dP^T = V dO^T (the
//   second), both along d; a thread owns 4 keys (one Philox group) x 4
//   queries. The first half writes Z P and P, with the keep bit as its sign,
//   into [query][key] tiles; the second turns P into dS = P (Z dP - delta)
//   in place.
//   dV += (Z P)^T dO (first half) and dK += dS^T q (second half): a thread
//   owns 4 keys x DP / 8 columns, DP / 2 fp32 registers, fed by one float4
//   of A (4 keys) and DP / 32 float4s of B per query: ~13 FMAs a shared
//   load at DP 160, where the FMA pipes need 4 to outrun shared memory.
//   dq = dS K over each half's keys: a thread owns 2 queries x DP / 8
//   columns, added to dq with float4 atomics (the float32 output is its own
//   accumulator). The key blocks and the halves add in no fixed order, so
//   dq's last bits may differ from run to run.
//
// Bound on the H100: 10 * BH * Nq * Nk * D FLOP (five products): 14.4 TFLOP
// at the full-resolution shape (BH 8, N 34,114, D 155) = 14.6 ms of bf16
// tensor-core time; 0.448 TFLOP at the sweep's widest heads (BH 64, N 1654,
// D 256) = 0.453 ms; 1.09 TFLOP at the fp32 flagship (BH 256, N 1654) = 16.2
// ms at the fp32 rate. Bound by operations.
// Not yet: up to DP 160 dq's partial sums go out as atomics (the staging
// boxes do not fit beside the panels at DP 160); above, the bulk adds are
// still the pass's largest cost on an H100 (a variant without any dq sums,
// not kept, ran far faster), and neither a query order staggered by key
// block nor the next tile's S and dP issued before them (ptxas then waited
// for the products and spilled) helped; with one box a warp, a box's next
// 32 columns wait until its last add has read it;
// the one pass's products and its P / dS arithmetic do not overlap within a
// warpgroup; the float32 pass's two halves wait for each other twice a tile.
#include "hopper.cuh"
#include "one_pass_bwd.cuh"


namespace {

constexpr int THREADS = 256;
constexpr float LOG2E = 1.4426950408889634f;
constexpr float MASKED = -1e30f;  // the forward's masked score (log2 units)

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
// bf16: one pass on wgmma (hopper.cuh)

constexpr int QB = 64, BWG = 128, BWD_THREADS = 2 * BWG, BWD_STAGES = 2;
constexpr int WIDE_DP = 160;  // above: 64 keys a block, dK and dV split by columns

template <int DP>
__host__ __device__ constexpr bool wide() { return DP > WIDE_DP; }

// keys a block
template <int DP>
__host__ __device__ constexpr int bwd_keys() { return wide<DP>() ? 64 : 128; }

// dq's columns per consumer warpgroup: the first half of the DP / 32
// sub-tiles (rounded up) for the first, as many from there for the second;
// the two issue one product shape (a warpgroup-dependent shape would
// serialize the products), and columns at or past DP are computed from the
// next panel's bytes and dropped
template <int DP>
__host__ __device__ constexpr int dq_cols() { return 32 * ((DP / 32 + 1) / 2); }

// dK's and dV's columns per consumer warpgroup: all of them, or above
// WIDE_DP the dq split
template <int DP>
__host__ __device__ constexpr int kv_cols() { return wide<DP>() ? dq_cols<DP>() : DP; }

// dq's columns a product: above WIDE_DP with 128 columns a warpgroup (DP
// 224, 256), two products of 64, the second after the first's atomics, so
// that dq's registers beside dK's and dV's (64 + 64) stay within 255
template <int DP>
__host__ __device__ constexpr int dq_step() {
  return wide<DP>() && dq_cols<DP>() > 96 ? dq_cols<DP>() / 2 : dq_cols<DP>();
}

// keys of one S / dP product: from DP 128 on, dK and dV take DP fp32
// registers a thread, and S and dP of 64 keys (64 more) spill
template <int DP>
__host__ __device__ constexpr int sdp_keys() { return DP >= 128 ? 32 : 64; }

// above WIDE_DP, dq's partial sums leave through shared memory: a float32
// box of [16 rows][32 columns] for each of the 8 warps, added to the
// accumulator by TMA's bulk reduce-add
constexpr int DQ_BOX_BYTES = 16 * 32 * 4;
template <int DP>
__host__ __device__ constexpr int dq_stage_bytes() { return wide<DP>() ? 8 * DQ_BOX_BYTES : 0; }

// K and V panels [KB][DP]; per stage q and dO panels [QB][DP] and the
// tile's lse and delta rows; P and dS panels [QB][KB]; the dq boxes; the
// mbarriers
template <int DP>
constexpr int one_pass_smem_bytes() {
  constexpr int KB = bwd_keys<DP>();
  return 1024 + 2 * KB * DP * 2 + BWD_STAGES * (2 * QB * DP * 2 + 2 * QB * 4) +
         2 * QB * KB * 2 + dq_stage_bytes<DP>() + (1 + BWD_STAGES) * 8;
}

template <int DP>
__global__ void __launch_bounds__(BWD_THREADS, 1) flash_bwd_one_pass_kernel(
    const __grid_constant__ CUtensorMap qmap, const __grid_constant__ CUtensorMap kmap,
    const __grid_constant__ CUtensorMap vmap, const __grid_constant__ CUtensorMap dmap,
    const __grid_constant__ CUtensorMap dqmap, const float* __restrict__ lse,
    const float* __restrict__ delta, float* __restrict__ dq_acc,
    bf16* __restrict__ dk, bf16* __restrict__ dv, int Nq, int Nk, int n_real, int D, int lsa,
    Drop drop, float s_log2, float dk_scale) {
  using namespace hopper;
  constexpr int KB = bwd_keys<DP>(), WK = KB / 2;  // WK: a warpgroup's keys of S and dP
  constexpr int KV_BYTES = KB * DP * 2, QP_BYTES = QB * DP * 2, PS_BYTES = QB * KB * 2;
  constexpr int DQC = dq_cols<DP>(), DQS = dq_step<DP>(), KVC = kv_cols<DP>();
  constexpr int SK = sdp_keys<DP>();
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
  // above WIDE_DP, [8 warps] dq boxes (1024-byte aligned: every region
  // before them is a multiple of 1024 bytes)
  unsigned char* dq_boxes = reinterpret_cast<unsigned char*>(Dl + BWD_STAGES * QB);

  uint64_t* kv_full = reinterpret_cast<uint64_t*>(dq_boxes + dq_stage_bytes<DP>());
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

  // warpgroup c owns keys WK c .. WK c + WK - 1 of the block for S and dP;
  // the rows (keys) krow0 .. krow0 + 63 and columns kvcol0 .. kvcol0 + KVC
  // - 1 of dK and dV (its 64 keys, every column; above WIDE_DP the block's
  // keys, its half of the columns); and dq's columns DQC c .. DQC c + DQC -
  // 1 (those below DP) of every query tile
  const int c = tid / BWG, lane = tid & 31, warp = (tid / 32) & 3;
  const int g = lane >> 2, t = lane & 3;
  const int kcol0 = WK * c;
  const int krow0 = wide<DP>() ? 0 : 64 * c, kvcol0 = wide<DP>() ? KVC * c : 0;
  const uint32_t k_s = smem_u32(Ks), v_s = smem_u32(Vs), q_s = smem_u32(Qs),
                 do_s = smem_u32(dOs), p_s = smem_u32(Ps), ds_s = smem_u32(dSs);
  float dk_acc[KVC / 2], dv_acc[KVC / 2];
#pragma unroll
  for (int i = 0; i < KVC / 2; ++i) dk_acc[i] = dv_acc[i] = 0.f;

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
    // rounded as the plain version rounds lse * log2 e (no FMA contraction):
    // a row whose every key is masked then gets P = 2^(MASKED - lse) = 1 / n
    const float lse0 = __fmul_rn(Ls[st * QB + lr0], s_log2);
    const float lse1 = __fmul_rn(Ls[st * QB + lr1], s_log2);
    const float del0 = Dl[st * QB + lr0], del1 = Dl[st * QB + lr1];

    // S = q k^T and dP = dO v^T for the tile's 64 queries x SK of the
    // group's keys at a time; P and dS from them, the keep mask drawn once
    // per element (rows are queries, as in the forward)
#pragma unroll 1
    for (int h = 0; h < WK / SK; ++h) {
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
          const float l = (e >> 1) ? lse1 : lse0;
          float p;
          if (!edge) {
            p = ex2(fmaf(s[4 * ni + e], s_log2, -l));
          } else {
            // keys past Nk and queries past Nq are the tiles' zero fill:
            // nothing; a masked key carries the plain version's masked
            // score (P 0 but in a row with every key masked)
            const int key = kbase + ni * 8 + 2 * t + (e & 1), row = (e >> 1) ? r1 : r0;
            const bool masked = key >= n_real || (lsa && key == row);
            p = key >= Nk || row >= Nq ? 0.f : ex2(masked ? MASKED - l : fmaf(s[4 * ni + e], s_log2, -l));
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

    // dv += (Z P)^T dO, dk += dS^T q (M = the group's 64 keys, N = its
    // columns, K = the tile's queries), dq[:, cols] = dS k (M = queries, K =
    // the block's keys), DQS of the group's DQC columns at a time
    float dq[DQS / 2];
    auto dq_product = [&](int part) {
#pragma unroll
      for (int ks = 0; ks < KB / 16; ++ks)
        wgmma::Mma<DQS>::template ss<0, 1>(dq, desc_k(ds_s, QB, 0, ks),
                                           desc_mn(k_s, KB, (c * DQC + part * DQS) / 32, ks),
                                           ks > 0);
    };
    // dq's partial sums into the float32 accumulator, four columns an
    // atomic: lanes t and t ^ 1 swap halves so that an even lane holds
    // (row g, columns 2t .. 2t + 3) and an odd one (row g + 8, columns
    // 2t - 2 .. 2t + 1). The key blocks add in no fixed order. Columns D ..
    // DP - 1 add zeros (k is zero there); columns past DP are dropped.
    // Above WIDE_DP, where blocks of 64 keys double these adds, each warp
    // writes its 16 rows into its box 32 columns at a time and lane 0 adds
    // the box with TMA's bulk reduce-add (whole lines, not 16-byte atomics;
    // rows past Nq and columns past DP dropped, boxes from D on not sent).
    auto dq_add = [&](int part) {
      if constexpr (wide<DP>()) {
        unsigned char* box = dq_boxes + (c * 4 + warp) * DQ_BOX_BYTES;
#pragma unroll
        for (int b = 0; b < DQS / 32; ++b) {
          const int col0 = c * DQC + part * DQS + 32 * b;
          if (col0 >= D) break;
          if (lane == 0) bulk_wait_read<0>();  // the box's last add has read it
          __syncwarp();
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int h = 0; h < 2; ++h)
              *reinterpret_cast<float2*>(box + f32_box_at(g + 8 * h, 8 * i + 2 * t)) =
                  make_float2(dq[4 * (4 * b + i) + 2 * h], dq[4 * (4 * b + i) + 2 * h + 1]);
          fence_async_smem();
          __syncwarp();
          if (lane == 0) {
            tma_reduce_add(box, &dqmap, col0, it * QB + 16 * warp, bh);
            bulk_commit();
          }
        }
        return;
      }
      const int odd = t & 1, col0 = c * DQC + part * DQS + 2 * (t - odd);
      const int row = odd ? r1 : r0;
      float* acc_row = dq_acc + ((size_t)bh * Nq + row) * DP + col0;
#pragma unroll
      for (int i = 0; i < DQS / 8; ++i) {
        const float send0 = odd ? dq[4 * i + 0] : dq[4 * i + 2];
        const float send1 = odd ? dq[4 * i + 1] : dq[4 * i + 3];
        const float got0 = __shfl_xor_sync(0xffffffffu, send0, 1);
        const float got1 = __shfl_xor_sync(0xffffffffu, send1, 1);
        const float4 add = odd ? make_float4(got0, got1, dq[4 * i + 2], dq[4 * i + 3])
                               : make_float4(dq[4 * i + 0], dq[4 * i + 1], got0, got1);
        if (row < Nq && col0 + 8 * i < DP)
          atomicAdd(reinterpret_cast<float4*>(acc_row + 8 * i), add);
      }
    };
    mma_fence();
#pragma unroll
    for (int ks = 0; ks < QB / 16; ++ks)
      wgmma::Mma<KVC>::template ss<1, 1>(dv_acc, desc_mn(p_s, QB, krow0 / 32, ks),
                                         desc_mn(dot_s, QB, kvcol0 / 32, ks), 1);
#pragma unroll
    for (int ks = 0; ks < QB / 16; ++ks)
      wgmma::Mma<KVC>::template ss<1, 1>(dk_acc, desc_mn(ds_s, QB, krow0 / 32, ks),
                                         desc_mn(qt_s, QB, kvcol0 / 32, ks), 1);
    dq_product(0);
    mma_commit();
    mma_wait<0>();
    fence_regs(dv_acc);
    fence_regs(dk_acc);
    fence_regs(dq);
    dq_add(0);
#pragma unroll 1
    for (int part = 1; part < DQC / DQS; ++part) {
      mma_fence();
      dq_product(part);
      mma_commit();
      mma_wait<0>();
      fence_regs(dq);
      dq_add(part);
    }
  }

  if constexpr (wide<DP>()) {
    if (lane == 0) bulk_wait<0>();  // this warp's dq adds are complete
  }

  // dk and dv of the group's 64 keys and KVC columns: accumulator rows are
  // keys; columns past DP (the second group's above WIDE_DP) are dropped
  const float dv_scale = drop.on() ? drop.scale : 1.f;
#pragma unroll
  for (int i = 0; i < KVC / 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int key = kb * KB + krow0 + 16 * warp + g + 8 * (e >> 1);
      const int col = kvcol0 + 8 * i + 2 * t + (e & 1);
      if (key < Nk && (!wide<DP>() || col < DP)) {
        const size_t at = ((size_t)bh * Nk + key) * DP + col;
        dk[at] = __float2bfloat16_rn(col < D ? dk_acc[4 * i + e] * dk_scale : 0.f);
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
// float32: one pass on FFMA

constexpr int F32_QT = 32;  // queries per tile

// keys per block: dK and dV of KB keys are KB * DP / 128 fp32 registers a
// thread (each half of the block accumulates one of them)
template <int DP>
__host__ __device__ constexpr int f32_keys() { return DP <= 160 ? 64 : 32; }

// K and V tiles [KB][DP + 4]; per stage the q and dO tiles [QT][DP + 4] and
// the lse and delta rows; the Z P and P / dS tiles [QT][KB + 4]
template <int DP>
constexpr int f32_smem_bytes() {
  constexpr int KB = f32_keys<DP>();
  return (2 * KB * (DP + 4) + 2 * 2 * F32_QT * (DP + 4) + 2 * F32_QT * (KB + 4) +
          2 * 2 * F32_QT) * (int)sizeof(float);
}

// named barriers (0 is __syncthreads): wait for `count` threads, or arrive
// without waiting
__device__ __forceinline__ void named_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

__device__ __forceinline__ void named_arrive(int id, int count) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

template <int DP>
__global__ void __launch_bounds__(THREADS, 1) flash_bwd_f32_kernel(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    const float* __restrict__ dohm, const float* __restrict__ lse,
    const float* __restrict__ delta, float* __restrict__ dq, float* __restrict__ dk,
    float* __restrict__ dv, int Nq, int Nk, int n_real, int D, int lsa, Drop drop) {
  constexpr int KB = f32_keys<DP>(), QT = F32_QT, LD = DP + 4, PLD = KB + 4, NQ4 = DP / 4;
  constexpr int KG = KB / 4;                 // groups of 4 keys
  constexpr int QG = 128 / KG, QA = QT / QG; // S / dP: query groups, queries a thread
  constexpr int DG = 128 / KG;               // dK / dV: column groups (of quads)
  constexpr int JB = (NQ4 + DG - 1) / DG;    // dK / dV: quads a thread
  constexpr int JC = NQ4 / 8;                // dq: quads a thread (8 column groups)
  constexpr int KH = KB / 2;                 // dq: keys of each half of the block
  static_assert(QA * QG == QT && QT == 32 && NQ4 % 8 == 0, "tile shape");
  extern __shared__ __align__(16) float fsm[];
  float* Ks = fsm;                // [KB][LD]
  float* Vs = Ks + KB * LD;       // [KB][LD]
  float* Qs = Vs + KB * LD;       // [2][QT][LD]
  float* dOs = Qs + 2 * QT * LD;  // [2][QT][LD]
  float* Ps = dOs + 2 * QT * LD;  // [QT][PLD] Z P (the 1 / keep scale is dv's, at the end)
  float* Hs = Ps + QT * PLD;      // [QT][PLD] P with the keep bit as its sign, then dS
  float* Ls = Hs + QT * PLD;      // [2][QT] lse
  float* Dl = Ls + 2 * QT;        // [2][QT] delta

  // the first half of the block (grp 0) computes S, P and dV; the second
  // dP, dS and dK; both compute dq, over half of the block's keys each
  const int tid = threadIdx.x, grp = tid >> 7, i = tid & 127;
  const int kb = blockIdx.x, bh = blockIdx.y;
  const float* qg = q + (size_t)bh * Nq * DP;
  const float* dog = dohm + (size_t)bh * Nq * DP;
  const float* kg = k + (size_t)bh * Nk * DP;
  const float* vg = v + (size_t)bh * Nk * DP;
  const float* lrow = lse + (size_t)bh * Nq;
  const float* drow = delta + (size_t)bh * Nq;

  for (int x = tid; x < KB * NQ4; x += THREADS) {
    const int r = x / NQ4, c = (x % NQ4) * 4, key = kb * KB + r;
    const bool valid = key < Nk;
    const size_t off = valid ? (size_t)key * DP + c : 0;
    cp_async16(Ks + r * LD + c, kg + off, valid);
    cp_async16(Vs + r * LD + c, vg + off, valid);
  }
  // the copies of query tile it + 1 run while tile it is computed
  auto load_tile = [&](int it) {
    const int s = it & 1;
    for (int x = tid; x < QT * NQ4; x += THREADS) {
      const int r = x / NQ4, c = (x % NQ4) * 4, row = it * QT + r;
      const bool valid = row < Nq;
      const size_t off = valid ? (size_t)row * DP + c : 0;
      cp_async16(Qs + (s * QT + r) * LD + c, qg + off, valid);
      cp_async16(dOs + (s * QT + r) * LD + c, dog + off, valid);
    }
    if (tid < QT) {
      const int row = it * QT + tid;
      hopper::cp_async4(Ls + s * QT + tid, lrow + (row < Nq ? row : 0), row < Nq);
      hopper::cp_async4(Dl + s * QT + tid, drow + (row < Nq ? row : 0), row < Nq);
    }
    cp_async_commit();
  };
  const int ntiles = (Nq + QT - 1) / QT;
  load_tile(0);  // commits the K and V tiles with it

  // S / dP, P, dS: keys 4 ka .. 4 ka + 3 (one Philox group), queries qa + QG j
  const int ka = i / QG, qa = i % QG, key0 = kb * KB + 4 * ka;
  // dV / dK: keys 4 kd .. 4 kd + 3, quads dd + DG j
  const int kd = i / DG, dd = i % DG;
  // dq: queries qc and qc + 16, quads dc + 8 j
  const int qc = i / 8, dc = i % 8;
  float4 acc[4][JB];  // dV (grp 0) or dK (grp 1) of keys 4 kd + e
#pragma unroll
  for (int e = 0; e < 4; ++e)
#pragma unroll
    for (int j = 0; j < JB; ++j) acc[e][j] = make_float4(0.f, 0.f, 0.f, 0.f);

  for (int it = 0; it < ntiles; ++it) {
    const int st = it & 1;
    cp_async_wait<0>();
    __syncthreads();  // tile it has landed; every thread is done with tile it - 1
    if (it + 1 < ntiles) load_tile(it + 1);
    const float* q_t = Qs + st * QT * LD;
    const float* do_t = dOs + st * QT * LD;

    // S^T = K q^T (grp 0) or dP^T = V dO^T (grp 1), float4 loads along d
    float s[4][QA];
#pragma unroll
    for (int e = 0; e < 4; ++e)
#pragma unroll
      for (int j = 0; j < QA; ++j) s[e][j] = 0.f;
    {
      const float* a_rows = (grp ? Vs : Ks) + 4 * ka * LD;
      const float* b_rows = (grp ? do_t : q_t) + qa * LD;
#pragma unroll 2
      for (int d = 0; d < DP; d += 4) {
        float4 a[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) a[e] = *reinterpret_cast<const float4*>(a_rows + e * LD + d);
#pragma unroll
        for (int j = 0; j < QA; ++j) {
          const float4 b = *reinterpret_cast<const float4*>(b_rows + j * QG * LD + d);
#pragma unroll
          for (int e = 0; e < 4; ++e) s[e][j] = dot4(s[e][j], a[e], b);
        }
      }
    }
    if (grp == 0) {
      // P, its keep mask (one Philox per query), Z P and the signed hand-over
#pragma unroll
      for (int j = 0; j < QA; ++j) {
        const int ql = qa + QG * j, row = it * QT + ql;
        const float l2 = __fmul_rn(Ls[st * QT + ql], LOG2E);
        uint4 w = make_uint4(0u, 0u, 0u, 0u);
        if (drop.on()) w = keep_words(drop, (uint32_t)bh, (uint32_t)row, (uint32_t)key0 >> 2);
        // only keys at or past n_real, a query past Nq or LSA mask
        const bool edge = key0 + 4 > n_real || row >= Nq || lsa;
        float zp[4], sp[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = key0 + e;
          float p;
          if (!edge) {
            p = exp2f(s[e][j] * LOG2E - l2);
          } else {
            const bool masked = key >= n_real || (lsa && key == row);
            p = key >= Nk || row >= Nq ? 0.f : exp2f((masked ? MASKED : s[e][j] * LOG2E) - l2);
          }
          const bool keep = !drop.on() || word_of(w, e) < drop.threshold;
          zp[e] = keep ? p : 0.f;
          sp[e] = keep ? p : -p;  // P >= 0; a dropped P of 0 adds 0 either way
        }
        *reinterpret_cast<float4*>(Ps + ql * PLD + 4 * ka) = make_float4(zp[0], zp[1], zp[2], zp[3]);
        *reinterpret_cast<float4*>(Hs + ql * PLD + 4 * ka) = make_float4(sp[0], sp[1], sp[2], sp[3]);
      }
    }
    __syncthreads();  // P and Z P are in shared memory
    if (grp == 1) {
      // dS = P (Z dP - delta), over P's hand-over slot
#pragma unroll
      for (int j = 0; j < QA; ++j) {
        const int ql = qa + QG * j;
        const float del = Dl[st * QT + ql];
        float4* slot = reinterpret_cast<float4*>(Hs + ql * PLD + 4 * ka);
        const float4 h = *slot;
        float ds[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float pk = lane4(h, e);
          const float z = drop.on() ? (pk > 0.f ? drop.scale : 0.f) : 1.f;
          ds[e] = fabsf(pk) * (z * s[e][j] - del);
        }
        *slot = make_float4(ds[0], ds[1], ds[2], ds[3]);
      }
      named_arrive(1, THREADS);  // dS is in shared memory, for grp 0's dq
      named_sync(2, 128);        // ... and for this half's dK
    }

    // dV += (Z P)^T dO (grp 0) or dK += dS^T q (grp 1): float4 loads along
    // the keys (A) and along d (B)
    {
      const float* a_t = (grp ? Hs : Ps) + 4 * kd;
      const float* b_t = (grp ? q_t : do_t) + 4 * dd;
#pragma unroll 4
      for (int qq = 0; qq < QT; ++qq) {
        const float4 a = *reinterpret_cast<const float4*>(a_t + qq * PLD);
#pragma unroll
        for (int j = 0; j < JB; ++j) {
          if (NQ4 % DG == 0 || dd + DG * j < NQ4) {
            const float4 b = *reinterpret_cast<const float4*>(b_t + qq * LD + 4 * DG * j);
            fma4(acc[0][j], a.x, b);
            fma4(acc[1][j], a.y, b);
            fma4(acc[2][j], a.z, b);
            fma4(acc[3][j], a.w, b);
          }
        }
      }
    }
    if (grp == 0) named_sync(1, THREADS);  // dS is in shared memory

    // dq[tile rows] += dS[:, half's keys] K[half's keys, :], float4 loads
    // along the keys (A) and along d (B), added to dq with float4 atomics
    {
      float4 g[2][JC];
#pragma unroll
      for (int r = 0; r < 2; ++r)
#pragma unroll
        for (int j = 0; j < JC; ++j) g[r][j] = make_float4(0.f, 0.f, 0.f, 0.f);
      const float* a0 = Hs + qc * PLD + KH * grp;
      const float* a1 = a0 + 16 * PLD;
      const float* k_t = Ks + KH * grp * LD + 4 * dc;
#pragma unroll 2
      for (int kk = 0; kk < KH; kk += 4) {
        const float4 x0 = *reinterpret_cast<const float4*>(a0 + kk);
        const float4 x1 = *reinterpret_cast<const float4*>(a1 + kk);
#pragma unroll
        for (int e = 0; e < 4; ++e)
#pragma unroll
          for (int j = 0; j < JC; ++j) {
            const float4 b = *reinterpret_cast<const float4*>(k_t + (kk + e) * LD + 32 * j);
            fma4(g[0][j], lane4(x0, e), b);
            fma4(g[1][j], lane4(x1, e), b);
          }
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = it * QT + qc + 16 * r;
        if (row < Nq) {
          float* dst = dq + ((size_t)bh * Nq + row) * DP + 4 * dc;
#pragma unroll
          for (int j = 0; j < JC; ++j) atomicAdd(reinterpret_cast<float4*>(dst + 32 * j), g[r][j]);
        }
      }
    }
  }

  // dV (grp 0, times 1 / keep) and dK (grp 1) of the block's keys, zero past D
  const float out_scale = grp == 0 && drop.on() ? drop.scale : 1.f;
  float* out = (grp ? dk : dv) + (size_t)bh * Nk * DP;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int key = kb * KB + 4 * kd + e;
    if (key >= Nk) continue;
#pragma unroll
    for (int j = 0; j < JB; ++j) {
      const int col = 4 * (dd + DG * j);
      if (NQ4 % DG != 0 && col >= DP) continue;
      const float4 x = acc[e][j];
      *reinterpret_cast<float4*>(out + (size_t)key * DP + col) =
          make_float4(col < D ? x.x * out_scale : 0.f, col + 1 < D ? x.y * out_scale : 0.f,
                      col + 2 < D ? x.z * out_scale : 0.f, col + 3 < D ? x.w * out_scale : 0.f);
    }
  }
}

// ---------------------------------------------------------------------------

template <int DP>
int launch_one_pass(const void* q, const void* k, const void* v, const void* dohm,
                    const float* lse, const float* delta, float* dq_acc, bf16* dk, bf16* dv,
                    int BH, int Nq, int Nk, int n_real, int D, int lsa, Drop drop, float s_log2,
                    float dk_scale, cudaStream_t stream) {
  constexpr int bytes = one_pass_smem_bytes<DP>();
  const cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_one_pass_kernel<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  constexpr int KB = bwd_keys<DP>();
  CUtensorMap qmap, kmap, vmap, dmap, dqmap{};  // dqmap: above WIDE_DP only
  int rc;
  if ((rc = hopper::make_panel_map(&qmap, q, BH, Nq, DP, QB)) != 0 ||
      (rc = hopper::make_panel_map(&dmap, dohm, BH, Nq, DP, QB)) != 0 ||
      (rc = hopper::make_panel_map(&kmap, k, BH, Nk, DP, KB)) != 0 ||
      (rc = hopper::make_panel_map(&vmap, v, BH, Nk, DP, KB)) != 0 ||
      (wide<DP>() && (rc = hopper::make_f32_map(&dqmap, dq_acc, BH, Nq, DP, 16)) != 0))
    return rc;
  flash_bwd_one_pass_kernel<DP><<<dim3((Nk + KB - 1) / KB, BH), BWD_THREADS, bytes, stream>>>(
      qmap, kmap, vmap, dmap, dqmap, lse, delta, dq_acc, dk, dv, Nq, Nk, n_real, D, lsa, drop,
      s_log2, dk_scale);
  return (int)cudaGetLastError();
}

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
    // the key blocks add dq's partial sums into dq itself
    err = cudaMemsetAsync(dq, 0, (size_t)rows * DP * sizeof(float), stream);
    if (err != cudaSuccess) return (int)err;
    constexpr int bytes = f32_smem_bytes<DP>();
    err = cudaFuncSetAttribute(flash_bwd_f32_kernel<DP>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return (int)err;
    constexpr int KB = f32_keys<DP>();
    flash_bwd_f32_kernel<DP><<<dim3((Nk + KB - 1) / KB, BH), THREADS, bytes, stream>>>(
        (const float*)q, (const float*)k, (const float*)v, (const float*)dohm,
        (const float*)lse, (const float*)delta, (float*)dq, (float*)dk, (float*)dv, Nq, Nk,
        n_real, D, lsa, drop);
    return (int)cudaGetLastError();
  }
  flash_bwd_prep_kernel<bf16><<<prep_blocks, THREADS, 0, stream>>>(
      (const bf16*)o, (const bf16*)dout, (const float*)dlse, (bf16*)dohm, (float*)delta, BH, Nq,
      D, DP, ol);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  if (dq_acc == nullptr) return (int)cudaErrorInvalidValue;
  const long long n4 = rows * DP / 4;
  err = cudaMemsetAsync(dq_acc, 0, (size_t)n4 * 16, stream);
  if (err != cudaSuccess) return (int)err;
  const int rc = one_pass::launch(q, k, v, dohm, (const float*)lse, (const float*)delta,
                                  (float*)dq_acc, (bf16*)dk, (bf16*)dv, BH, Nq, Nk, n_real, D,
                                  DP, lsa, drop, LOG2E, 1.f, stream);
  if (rc != 0) return rc;
  flash_bwd_dq_convert_kernel<<<(unsigned)((n4 + THREADS - 1) / THREADS), THREADS, 0, stream>>>(
      (const float4*)dq_acc, (bf16*)dq, n4);
  return (int)cudaGetLastError();
}

}  // namespace

int one_pass::launch(const void* q, const void* k, const void* v, const void* dohm,
                     const float* lse, const float* delta, float* dq_acc, bf16* dk, bf16* dv,
                     int BH, int Nq, int Nk, int n_real, int D, int DP, int lsa, Drop drop,
                     float s_log2, float dk_scale, cudaStream_t stream) {
  if (BH < 1 || BH > 65535 || D > DP || n_real > Nk || Nq < 1 || Nk < 1)
    return (int)cudaErrorInvalidValue;
  switch (DP) {
    case 32: return launch_one_pass<32>(q, k, v, dohm, lse, delta, dq_acc, dk, dv, BH, Nq, Nk, n_real, D, lsa, drop, s_log2, dk_scale, stream);
    case 64: return launch_one_pass<64>(q, k, v, dohm, lse, delta, dq_acc, dk, dv, BH, Nq, Nk, n_real, D, lsa, drop, s_log2, dk_scale, stream);
    case 96: return launch_one_pass<96>(q, k, v, dohm, lse, delta, dq_acc, dk, dv, BH, Nq, Nk, n_real, D, lsa, drop, s_log2, dk_scale, stream);
    case 128: return launch_one_pass<128>(q, k, v, dohm, lse, delta, dq_acc, dk, dv, BH, Nq, Nk, n_real, D, lsa, drop, s_log2, dk_scale, stream);
    case 160: return launch_one_pass<160>(q, k, v, dohm, lse, delta, dq_acc, dk, dv, BH, Nq, Nk, n_real, D, lsa, drop, s_log2, dk_scale, stream);
    case 192: return launch_one_pass<192>(q, k, v, dohm, lse, delta, dq_acc, dk, dv, BH, Nq, Nk, n_real, D, lsa, drop, s_log2, dk_scale, stream);
    case 224: return launch_one_pass<224>(q, k, v, dohm, lse, delta, dq_acc, dk, dv, BH, Nq, Nk, n_real, D, lsa, drop, s_log2, dk_scale, stream);
    case 256: return launch_one_pass<256>(q, k, v, dohm, lse, delta, dq_acc, dk, dv, BH, Nq, Nk, n_real, D, lsa, drop, s_log2, dk_scale, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

// Returns a CUDA error code (0 on success). q (BH, Nq, DP), k, v (BH, Nk,
// DP) as the forward read them (bf16 when f32 == 0, float32 when 1; DP =
// 32, 64, ..., 256); o and dout at element (bh, row, d) -> (bh / H) *
// o_batch + (bh % H) * o_head + row * o_row + d, d < D, in the same dtype;
// lse (BH, Nq) float32 natural log from the forward; dlse (BH, Nq) float32
// or null. Writes dq (BH, Nq, DP), dk and dv (BH, Nk, DP), zero past D.
// dohm (BH, Nq, DP) in the dtype and delta (BH, Nq) float32 are scratch,
// and dq_acc (BH, Nq, DP) float32 for bf16 (null for float32).
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
int bwd_smem(bool f32) {
  return f32 ? f32_smem_bytes<DP>() : one_pass_smem_bytes<DP>();
}
}  // namespace

// Dynamic shared memory of a block of the backward's main kernel at padded
// head width dp: in bf16 the one pass (which attention_bwd.cu launches too
// up to DP 160), with f32 the float32 pass. 0 for a width it is not built
// for.
extern "C" int v1t_flash_attention_bwd_smem(int dp, int f32) {
  const bool f = f32 != 0;
  switch (dp) {
    case 32: return bwd_smem<32>(f);
    case 64: return bwd_smem<64>(f);
    case 96: return bwd_smem<96>(f);
    case 128: return bwd_smem<128>(f);
    case 160: return bwd_smem<160>(f);
    case 192: return bwd_smem<192>(f);
    case 224: return bwd_smem<224>(f);
    case 256: return bwd_smem<256>(f);
    default: return 0;
  }
}
