// flash_attention: o = softmax(q.k^T, masked) v per (batch * head), with the
// natural-log log-sum-exp of every row, for the composed attention path.
//
// Replaces v1t_tpu/ops/flash_attention.py _flash_forward (:435) ->
// _fwd_kernel_fullk (:279) / _fwd_kernel (:225), and _flash_forward_dt
// (:603) -> _fwd_kernel_dt (:545): the TPU's whole-K, blocked and
// transposed variants compute one function, ported once. q (BH, Nq, DP), k
// and v (BH, Nk, DP), each row zero-padded from D to DP (a multiple of 32),
// bf16 or float32; the softmax scale is already folded into q (and q rounded
// to its dtype, :1308-1312). Keys at or past n_real_k are masked (the TPU's
// MASK_VALUE, :201); with lsa (Nq == Nk) the diagonal too. Online softmax in
// float32 in base 2 (the scores times log2 e). Dropout: the row sum is taken
// before the keep mask and kept probabilities are divided by the keep rate
// (:251-261), the division folded into 1/l; mask element (bh, query, key) of
// the site's Philox stream (common.cuh), the TPU's per-tile hardware bits
// having no counterpart. lse = m + log(l) in natural log (:273-274), 1/l = 1
// where l == 0 (:272). o is written through strides, so that it lands in a
// (B, N, H, D) buffer: element (bh, row, d) at (bh / H) * o_batch +
// (bh % H) * o_head + row * o_row + d.
//
// bf16: wgmma, warp-specialised (hopper.cuh), FlashAttention-3's design.
// A block of three warpgroups owns 128 query rows. In warpgroup 0 one thread
// starts TMA copies: the block's q panel once, then key and value tiles of
// 64 (32 above DP 160) into a ring of 3 stages (2 above DP 192), each stage
// an mbarrier that the copies complete and another that the consumers
// release; the warpgroup gives up its registers (setmaxnreg 40 / 232).
// Warpgroups 1 and 2 own 64 rows each: S = q k^T is wgmma m64n64k16 with q
// and k from shared memory, o += P v is m64nDPk16 with P from registers.
// The accumulator's layout is mma.sync m16n8's C fragment per warp, so the
// online softmax's row shuffles and keep_frag_rows carry over. The pipeline
// within a warpgroup: S of tile j + 1 and P_j v_j are issued together, and
// tile j + 1's exp2 and Philox run while P_j v_j is on the tensor cores; o
// is rescaled when no product is in flight. Only tiles that reach masked
// keys (n_real_k, the LSA diagonal) mask element by element; elsewhere p =
// 2^(s log2 e - m) is one FFMA and one ex2. TMA, not cp.async: 16-byte
// cp.async copies from the loading warpgroup left the tensor cores waiting
// on an H100; a TMA copy is one instruction a sub-tile. The tensor map's
// encoder lives in libcuda and is reached through
// cudaGetDriverEntryPointByVersion; the map travels as a __grid_constant__
// parameter, its boxes one [rows][32] sub-tile in the 64-byte swizzle.
// float32: FFMA on the CUDA cores, not TF32 (the fp32 model exists for
// exact arithmetic). FFMA on an H100 outruns shared memory: its 128 lanes
// of FMA a cycle face 128 bytes of shared loads a cycle, so each loaded
// float must feed several FMAs, and that sets the tiles. A block of 256
// threads owns 128 query rows (64 above DP 160, so that o fits the
// registers); key tiles of 64. q, K and V lie in shared memory row-major,
// rows padded by four floats (and four more every 8 rows), brought by
// 16-byte cp.async: q once, K and V taking turns in a two-stage ring (V_j
// copied while S_j is computed, K_j+1 while P_j v_j is), two __syncthreads
// a tile. Lane 2 cl + rl of a warp owns rows rl + 2 i of the warp's 16 (8):
// S for keys 4 cl .. 4 cl + 3 (one Philox group) from float4s of q and k
// along d, 128 FMAs for 12 shared loads; the row max over the 16 lanes of
// a row (4 shuffles), the row sum kept per lane until the end; the kept P
// written [query][key] to the warp's own rows of a P tile, then o for the
// same 8 rows at float2 columns cl + 16 j (DP / 16 columns, 80 registers at
// DP 160) from float4s of P along the keys and float2s of v along the
// columns: 320 FMAs for 28 shared loads. P never leaves the warp
// (__syncwarp).
//
// Bound on the H100: 4 * BH * Nq * Nk * D FLOP (two products) over ~3 x
// BH * N * D * dtype bytes: at the full-resolution shape (BH 8, N 34,114,
// D 155, bf16) 5.77 TFLOP, ~5.8 ms of bf16 tensor-core time against 0.03 ms
// of bytes; at the fp32 flagship (BH 256, N 1654) 0.434 TFLOP, 6.5 ms at
// the 67 TFLOP/s fp32 rate. Bound by operations.
// The training kernel's keep mask (2.3e9 Philox draws at full resolution)
// runs on the integer pipe of the consumer warps and hides only in part
// behind the products; drawn in the loading warpgroup instead, it fell
// behind the tensor cores (four warps of Philox against eight of softmax).
// Taking turns between the two consumer warpgroups' products (named
// barriers, FlashAttention-3's ping-pong) did not shorten it either. The
// float32 kernel ran slower on an H100 with 4-row x 20-column o tiles
// (float4 loads of v: more shared bytes per FMA) and with 32-key tiles in a
// ring of (K, V) pairs (more barriers and rescales per key); one block a SM
// (203 KB at DP 160) leaves its 8 warps' loads to hide behind each other's
// FMAs.
#include "hopper.cuh"

namespace {

constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;
constexpr float MASKED = -1e30f;

// ---------------------------------------------------------------------------
// bf16 (wgmma, warp-specialised)

// A block of three warpgroups owns BQ = 128 query rows of one (batch, head):
// warpgroup 0 loads, warpgroups 1 and 2 each own 64 of the rows.
constexpr int BQ = 128, WG = 128, FWD_THREADS = 3 * WG;
constexpr int PRODUCER_REGS = 40, CONSUMER_REGS = 232;

template <int DP>
__host__ __device__ constexpr int fwd_bkv() { return DP <= 160 ? 64 : 32; }
template <int DP>
__host__ __device__ constexpr int fwd_stages() { return DP <= 192 ? 3 : 2; }

// Q panel [BQ][DP], then per stage a K and a V panel [BKV][DP], then the
// mbarriers; 1024 bytes of slack to align the base
template <int DP>
constexpr int bf16_smem_bytes() {
  return 1024 + (BQ + 2 * fwd_stages<DP>() * fwd_bkv<DP>()) * DP * (int)sizeof(bf16) +
         (1 + 2 * fwd_stages<DP>()) * 8;
}

template <int DP, bool TRAIN>
__global__ void __launch_bounds__(FWD_THREADS, 1) flash_fwd_wgmma_kernel(
    const __grid_constant__ CUtensorMap qmap, const __grid_constant__ CUtensorMap kmap,
    const __grid_constant__ CUtensorMap vmap, bf16* __restrict__ out, float* __restrict__ lse,
    int Nq, int Nk, int n_real, int D, RowLayout ol, int lsa, Drop drop) {
  using namespace hopper;
  constexpr int BKV = fwd_bkv<DP>(), STAGES = fwd_stages<DP>();
  constexpr int Q_BYTES = BQ * DP * 2, KV_BYTES = BKV * DP * 2;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~(uintptr_t)1023);
  unsigned char* Qs = base;
  unsigned char* Ks = Qs + Q_BYTES;             // [STAGES] K panels
  unsigned char* Vs = Ks + STAGES * KV_BYTES;   // [STAGES] V panels
  uint64_t* q_full = reinterpret_cast<uint64_t*>(Vs + STAGES * KV_BYTES);
  uint64_t* full = q_full + 1;                  // [STAGES] K and V landed
  uint64_t* empty = full + STAGES;              // [STAGES] consumers done

  const int wg = threadIdx.x / WG, qt = blockIdx.x, bh = blockIdx.y;
  const int ntiles = (Nk + BKV - 1) / BKV;
  if (threadIdx.x == 0) {
    bar_init(q_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      bar_init(&full[s], 1);
      bar_init(&empty[s], 2 * WG);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {  // producer: one thread starts the TMA copies of every tile
    regs_dec<PRODUCER_REGS>();
    if (threadIdx.x == 0) {
      bar_expect(q_full, Q_BYTES);
      tma_panel<DP>(Qs, &qmap, bh, qt * BQ, BQ, q_full);
      for (int j = 0; j < ntiles; ++j) {
        const int s = j % STAGES;
        if (j >= STAGES) bar_wait(&empty[s], (uint32_t)((j / STAGES - 1) & 1));
        bar_expect(&full[s], 2 * KV_BYTES);
        tma_panel<DP>(Ks + s * KV_BYTES, &kmap, bh, j * BKV, BKV, &full[s]);
        tma_panel<DP>(Vs + s * KV_BYTES, &vmap, bh, j * BKV, BKV, &full[s]);
      }
    }
    return;
  }

  // consumers: warpgroup c owns rows 64 c .. 64 c + 63 of the block
  regs_inc<CONSUMER_REGS>();
  const int c = wg - 1, lane = threadIdx.x & 31, warp = (threadIdx.x / 32) & 3;
  const int g = lane >> 2, t = lane & 3;
  const int row0 = qt * BQ + 64 * c + 16 * warp;  // this warp's 16 rows
  const int r0 = row0 + g, r1 = r0 + 8;
  const uint32_t q_s = smem_u32(Qs), k_s = smem_u32(Ks), v_s = smem_u32(Vs);

  float o[DP / 2], s[BKV / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) o[i] = 0.f;
  float m0 = MASKED, m1 = MASKED, l0 = 0.f, l1 = 0.f;

  // S = q k^T of key tile j into s (asynchronous; one commit group)
  auto issue_s = [&](int j) {
    const int st = j % STAGES;
    bar_wait(&full[st], (uint32_t)((j / STAGES) & 1));
    fence_regs(s);
    mma_fence();
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk)
      wgmma::Mma<BKV>::template ss<0, 0>(s, desc_k(q_s, BQ, 64 * c, kk),
                                         desc_k(k_s + st * KV_BYTES, BKV, 0, kk), kk > 0);
    mma_commit();
  };

  // the online softmax of tile j's scores (complete in s): the new running
  // max and sum, P into pf as bf16 A fragments; returns the rescale of o
  auto softmax = [&](int j, uint32_t (&pf)[BKV / 16][4], float& a0, float& a1) {
    fence_regs(s);
    // only a tile that holds keys at or past n_real, or the block's
    // diagonal under LSA, is masked element by element (a uniform branch);
    // its scores go to log2 units first, as the plain version masks them:
    // keys past Nk (the tile's zero fill) weigh nothing (-inf), else a row
    // with every key masked (LSA at N 1) would count them in its sum
    const bool edge = (j + 1) * BKV > n_real ||
                      (lsa && j * BKV < qt * BQ + BQ && (j + 1) * BKV > qt * BQ);
    float scale = LOG2E;  // p = 2^(s scale - m) in one FFMA
    if (edge) {
      scale = 1.f;
#pragma unroll
      for (int ni = 0; ni < BKV / 8; ++ni)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = j * BKV + ni * 8 + 2 * t + (e & 1);
          const bool masked = key >= n_real || (lsa && key == ((e >> 1) ? r1 : r0));
          s[4 * ni + e] = key >= Nk ? __int_as_float(0xff800000u)
                          : masked  ? MASKED
                                    : s[4 * ni + e] * LOG2E;
        }
    }
    float mx0 = s[0], mx1 = s[2];
#pragma unroll
    for (int ni = 0; ni < BKV / 8; ++ni) {
      mx0 = fmaxf(mx0, fmaxf(s[4 * ni + 0], s[4 * ni + 1]));
      mx1 = fmaxf(mx1, fmaxf(s[4 * ni + 2], s[4 * ni + 3]));
    }
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
    mx0 = fmaxf(m0, mx0 * scale);
    mx1 = fmaxf(m1, mx1 * scale);
    a0 = ex2(m0 - mx0);
    a1 = ex2(m1 - mx1);
    m0 = mx0;
    m1 = mx1;
    l0 *= a0;
    l1 *= a1;
#pragma unroll
    for (int ni = 0; ni < BKV / 8; ++ni) {
      float p00 = ex2(fmaf(s[4 * ni + 0], scale, -m0)), p01 = ex2(fmaf(s[4 * ni + 1], scale, -m0));
      float p10 = ex2(fmaf(s[4 * ni + 2], scale, -m1)), p11 = ex2(fmaf(s[4 * ni + 3], scale, -m1));
      l0 += p00 + p01;
      l1 += p10 + p11;
      if (TRAIN && drop.on()) {  // select only: 1/keep folds into 1/l
        bool keep[4];
        keep_frag_rows(drop, (uint32_t)bh, row0, j * BKV + ni * 8, lane, keep);
        p00 = keep[0] ? p00 : 0.f;
        p01 = keep[1] ? p01 : 0.f;
        p10 = keep[2] ? p10 : 0.f;
        p11 = keep[3] ? p11 : 0.f;
      }
      // two adjacent 8-key C tiles form one 16-key A fragment
      pf[ni >> 1][(ni & 1) * 2 + 0] = pack_bf16(p00, p01);
      pf[ni >> 1][(ni & 1) * 2 + 1] = pack_bf16(p10, p11);
    }
  };

  // FlashAttention-3's intra-warpgroup pipeline: S of tile j + 1 and o +=
  // P_j v_j are issued together, and tile j + 1's softmax (exp2, Philox)
  // runs while P_j v_j is on the tensor cores; o is rescaled only when no
  // product is in flight. The last tile has no successor and its own step,
  // so that every wait retires a known commit group.
  auto pv = [&](int j, uint32_t (&pf)[BKV / 16][4]) {
    fence_regs(o);
    mma_fence();
#pragma unroll
    for (int ks = 0; ks < BKV / 16; ++ks)
      wgmma::Mma<DP>::template rs<1>(o, pf[ks],
                                     desc_mn(v_s + (j % STAGES) * KV_BYTES, BKV, 0, ks), 1);
    mma_commit();
  };
  auto step = [&](int j, uint32_t (&pf)[BKV / 16][4], uint32_t (&pf_next)[BKV / 16][4]) {
    issue_s(j + 1);
    pv(j, pf);
    mma_wait<1>();
    float a0, a1;
    softmax(j + 1, pf_next, a0, a1);
    mma_wait<0>();
    fence_regs(o);
    fence_frags(pf);
    bar_arrive(&empty[j % STAGES]);
#pragma unroll
    for (int i = 0; i < DP / 8; ++i) {
      o[4 * i + 0] *= a0;
      o[4 * i + 1] *= a0;
      o[4 * i + 2] *= a1;
      o[4 * i + 3] *= a1;
    }
  };
  auto last = [&](int j, uint32_t (&pf)[BKV / 16][4]) {
    pv(j, pf);
    mma_wait<0>();
    fence_regs(o);
    fence_frags(pf);
  };

  uint32_t pa[BKV / 16][4], pb[BKV / 16][4];
  bar_wait(q_full, 0u);
  issue_s(0);
  mma_wait<0>();
  {
    float a0, a1;
    softmax(0, pa, a0, a1);
  }
  int j = 0;
  for (; j + 2 < ntiles; j += 2) {
    step(j, pa, pb);
    step(j + 1, pb, pa);
  }
  if (j + 1 < ntiles) {
    step(j, pa, pb);
    last(j + 1, pb);
  } else {
    last(j, pa);
  }

  // the four lanes of a quad hold partial sums of the same rows
  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  float inv0 = l0 == 0.f ? 1.f : 1.f / l0;
  float inv1 = l1 == 0.f ? 1.f : 1.f / l1;
  if (TRAIN && drop.on()) {
    inv0 *= drop.scale;
    inv1 *= drop.scale;
  }
  if (lse != nullptr && t == 0) {
    float* lrow = lse + (size_t)bh * Nq;
    if (r0 < Nq) lrow[r0] = (m0 + log2f(fmaxf(l0, 1e-37f))) * LN2;
    if (r1 < Nq) lrow[r1] = (m1 + log2f(fmaxf(l1, 1e-37f))) * LN2;
  }
#pragma unroll
  for (int i = 0; i < DP / 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = (e >> 1) ? r1 : r0;
      const int col = i * 8 + 2 * t + (e & 1);
      if (row < Nq && col < D)
        out[ol.at(bh, row) + col] = __float2bfloat16_rn(o[4 * i + e] * ((e >> 1) ? inv1 : inv0));
    }
}

// ---------------------------------------------------------------------------
// float32 (FFMA)

constexpr int F32_KB = 64, F32_THREADS = 256;

// query rows a thread owns: its o tile is f32_rows x DP / 16 fp32 registers
// (80 at DP 160 with 8 rows; 64 at DP 256 with 4)
template <int DP>
__host__ __device__ constexpr int f32_rows() { return DP <= 160 ? 8 : 4; }
template <int DP>
__host__ __device__ constexpr int f32_queries() { return 16 * f32_rows<DP>(); }

// a row-major tile of DP floats a row: row r starts r (DP + 4) + 4 (r / 8)
// floats in, so that consecutive rows, and rows four apart, fall on
// distinct 16-byte bank groups
__host__ __device__ constexpr int f32_tile_floats(int rows, int dp) {
  return rows * (dp + 4) + 4 * ((rows + 7) / 8);
}
__device__ __forceinline__ int f32_row(int r, int ld) { return r * ld + ((r >> 3) << 2); }

// q [QB rows], a K and a V tile [KB rows], P [QB][KB + 4]
template <int DP>
constexpr int f32_smem_bytes() {
  constexpr int QB = f32_queries<DP>();
  return (f32_tile_floats(QB, DP) + 2 * f32_tile_floats(F32_KB, DP) + QB * (F32_KB + 4)) *
         (int)sizeof(float);
}

template <int DP, bool TRAIN>
__global__ void __launch_bounds__(F32_THREADS, 1) flash_fwd_f32_kernel(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    float* __restrict__ out, float* __restrict__ lse, int Nq, int Nk, int n_real, int D,
    RowLayout ol, int lsa, Drop drop) {
  constexpr int RQ = f32_rows<DP>(), QB = f32_queries<DP>(), KB = F32_KB;
  constexpr int LD = DP + 4, PLD = KB + 4, NQ4 = DP / 4, CV = DP / 32;
  constexpr int QT = f32_tile_floats(QB, DP), KT = f32_tile_floats(KB, DP);
  extern __shared__ __align__(16) float fsm[];
  float* Qs = fsm;      // q rows
  float* Ks = Qs + QT;  // the K tile
  float* Vs = Ks + KT;  // the V tile
  float* Ps = Vs + KT;  // [QB][PLD] the kept probabilities, [query][key]

  // lane = 2 cl + rl: rows rbase + 2 i (i < RQ) of the warp's 2 RQ; keys
  // 4 cl .. 4 cl + 3 of a tile (one Philox group) for S, float2 columns
  // cl + 16 j (j < CV) for o
  const int tid = threadIdx.x, lane = tid & 31, cl = lane >> 1;
  const int rbase = (tid >> 5) * 2 * RQ + (lane & 1);
  const int qt = blockIdx.x, bh = blockIdx.y;
  const float* qg = q + (size_t)bh * Nq * DP;
  const float* kg = k + (size_t)bh * Nk * DP;
  const float* vg = v + (size_t)bh * Nk * DP;

  for (int x = tid; x < QB * NQ4; x += F32_THREADS) {
    const int r = x / NQ4, c = (x - r * NQ4) * 4, row = qt * QB + r;
    const bool valid = row < Nq;
    cp_async16(Qs + f32_row(r, LD) + c, qg + (valid ? (size_t)row * DP + c : 0), valid);
  }
  // K and V tiles take turns in a two-stage ring: V_j is copied while S_j
  // is computed, K_j+1 while P_j v_j is
  auto load = [&](float* dst, const float* src, int j) {
    for (int x = tid; x < KB * NQ4; x += F32_THREADS) {
      const int r = x / NQ4, c = (x - r * NQ4) * 4, key = j * KB + r;
      const bool valid = key < Nk;
      cp_async16(dst + f32_row(r, LD) + c, src + (valid ? (size_t)key * DP + c : 0), valid);
    }
    cp_async_commit();
  };
  const int ntiles = (Nk + KB - 1) / KB;
  load(Ks, kg, 0);  // commits q with it

  float2 o[RQ][CV];
  float m[RQ], l[RQ];
#pragma unroll
  for (int i = 0; i < RQ; ++i) {
    m[i] = MASKED;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < CV; ++j) o[i][j] = make_float2(0.f, 0.f);
  }

  for (int kt = 0; kt < ntiles; ++kt) {
    cp_async_wait<0>();
    __syncthreads();  // K_kt has landed; every thread is done with V_kt-1
    load(Vs, vg, kt);

    // S = q k^T: float4s along d, RQ rows x 4 keys a thread
    float s[RQ][4];
#pragma unroll
    for (int i = 0; i < RQ; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[i][e] = 0.f;
#pragma unroll 2
    for (int d = 0; d < DP; d += 4) {
      float4 a[RQ], b[4];
#pragma unroll
      for (int i = 0; i < RQ; ++i)
        a[i] = *reinterpret_cast<const float4*>(Qs + f32_row(rbase + 2 * i, LD) + d);
#pragma unroll
      for (int e = 0; e < 4; ++e)
        b[e] = *reinterpret_cast<const float4*>(Ks + f32_row(4 * cl + e, LD) + d);
#pragma unroll
      for (int i = 0; i < RQ; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[i][e] = dot4(s[i][e], a[i], b[e]);
    }

    // the online softmax in log2 units: keys past Nk (the tile's zero
    // fill) weigh nothing, keys at or past n_real and the LSA diagonal are
    // masked as the plain version masks them; the row max over the 16
    // lanes of a row, one Philox per row for the thread's 4 keys
    const int key0 = kt * KB + 4 * cl;
#pragma unroll
    for (int i = 0; i < RQ; ++i) {
      const int row = qt * QB + rbase + 2 * i;
      float mx = MASKED;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = key0 + e;
        float x = s[i][e] * LOG2E;
        if (key >= Nk) x = __int_as_float(0xff800000u);  // -inf
        else if (key >= n_real || (lsa && key == row)) x = MASKED;
        s[i][e] = x;
        mx = fmaxf(mx, x);
      }
#pragma unroll
      for (int off = 2; off < 32; off <<= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      mx = fmaxf(m[i], mx);
      const float alpha = exp2f(m[i] - mx);
      m[i] = mx;
      l[i] *= alpha;
#pragma unroll
      for (int j = 0; j < CV; ++j) {
        o[i][j].x *= alpha;
        o[i][j].y *= alpha;
      }
      uint4 w = make_uint4(0u, 0u, 0u, 0u);
      if (TRAIN && drop.on()) w = keep_words(drop, (uint32_t)bh, (uint32_t)row, (uint32_t)key0 >> 2);
      float p[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        p[e] = exp2f(s[i][e] - mx);
        l[i] += p[e];
        if (TRAIN && drop.on() && word_of(w, e) >= drop.threshold) p[e] = 0.f;
      }
      *reinterpret_cast<float4*>(Ps + (rbase + 2 * i) * PLD + 4 * cl) =
          make_float4(p[0], p[1], p[2], p[3]);
    }
    __syncwarp();  // a warp reads back only its own rows of P

    cp_async_wait<0>();
    __syncthreads();  // V_kt has landed; every thread is done with K_kt
    if (kt + 1 < ntiles) load(Ks, kg, kt + 1);

    // o += P v: float4s of P along the keys, float2s of v along the columns
#pragma unroll 2
    for (int kk = 0; kk < KB; kk += 4) {
      float4 pv[RQ];
#pragma unroll
      for (int i = 0; i < RQ; ++i)
        pv[i] = *reinterpret_cast<const float4*>(Ps + (rbase + 2 * i) * PLD + kk);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float* vr = Vs + f32_row(kk + e, LD) + 2 * cl;
#pragma unroll
        for (int j = 0; j < CV; ++j) {
          const float2 b = *reinterpret_cast<const float2*>(vr + 32 * j);
#pragma unroll
          for (int i = 0; i < RQ; ++i) {
            const float pe = lane4(pv[i], e);
            o[i][j].x = fmaf(pe, b.x, o[i][j].x);
            o[i][j].y = fmaf(pe, b.y, o[i][j].y);
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < RQ; ++i) {
    float li = l[i];  // the 16 lanes of a row hold partial sums
#pragma unroll
    for (int off = 2; off < 32; off <<= 1) li += __shfl_xor_sync(0xffffffffu, li, off);
    const int row = qt * QB + rbase + 2 * i;
    if (row >= Nq) continue;
    float inv = li == 0.f ? 1.f : 1.f / li;
    if (TRAIN && drop.on()) inv *= drop.scale;
    if (lse != nullptr && cl == 0)
      lse[(size_t)bh * Nq + row] = (m[i] + log2f(fmaxf(li, 1e-37f))) * LN2;
    float* orow = out + ol.at(bh, row);
#pragma unroll
    for (int j = 0; j < CV; ++j) {
      const int col = 2 * cl + 32 * j;
      if (col < D) orow[col] = o[i][j].x * inv;
      if (col + 1 < D) orow[col + 1] = o[i][j].y * inv;
    }
  }
}

// ---------------------------------------------------------------------------

template <int DP, bool TRAIN>
int launch_dp(bool f32, const void* q, const void* k, const void* v, void* out, void* lse,
              int BH, int Nq, int Nk, int n_real, int D, RowLayout ol, int lsa, Drop drop,
              cudaStream_t stream) {
  cudaError_t err;
  if (f32) {
    constexpr int bytes = f32_smem_bytes<DP>();
    err = cudaFuncSetAttribute(flash_fwd_f32_kernel<DP, TRAIN>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return (int)err;
    constexpr int QB = f32_queries<DP>();
    flash_fwd_f32_kernel<DP, TRAIN><<<dim3((Nq + QB - 1) / QB, BH), F32_THREADS, bytes, stream>>>(
        (const float*)q, (const float*)k, (const float*)v, (float*)out, (float*)lse, Nq, Nk,
        n_real, D, ol, lsa, drop);
  } else {
    constexpr int bytes = bf16_smem_bytes<DP>();
    CUtensorMap qmap, kmap, vmap;
    int rc;
    if ((rc = hopper::make_panel_map(&qmap, q, BH, Nq, DP, BQ)) != 0 ||
        (rc = hopper::make_panel_map(&kmap, k, BH, Nk, DP, fwd_bkv<DP>())) != 0 ||
        (rc = hopper::make_panel_map(&vmap, v, BH, Nk, DP, fwd_bkv<DP>())) != 0)
      return rc;
    err = cudaFuncSetAttribute(flash_fwd_wgmma_kernel<DP, TRAIN>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return (int)err;
    flash_fwd_wgmma_kernel<DP, TRAIN><<<dim3((Nq + BQ - 1) / BQ, BH), FWD_THREADS, bytes,
                                        stream>>>(qmap, kmap, vmap, (bf16*)out, (float*)lse, Nq,
                                                  Nk, n_real, D, ol, lsa, drop);
  }
  return (int)cudaGetLastError();
}

template <int DP>
int launch(bool f32, bool train, const void* q, const void* k, const void* v, void* out,
           void* lse, int BH, int Nq, int Nk, int n_real, int D, RowLayout ol, int lsa,
           Drop drop, cudaStream_t stream) {
  if (train)
    return launch_dp<DP, true>(f32, q, k, v, out, lse, BH, Nq, Nk, n_real, D, ol, lsa, drop,
                               stream);
  return launch_dp<DP, false>(f32, q, k, v, out, lse, BH, Nq, Nk, n_real, D, ol, lsa, drop,
                              stream);
}

template <int DP>
int fwd_smem(bool f32) { return f32 ? f32_smem_bytes<DP>() : bf16_smem_bytes<DP>(); }

}  // namespace

// Returns a CUDA error code (0 on success). q (BH, Nq, DP), k and v (BH, Nk,
// DP), bf16 (f32 == 0) or float32 (f32 == 1), rows zero-padded from D to
// DP = 32, 64, ..., 256; out in the same dtype at element (bh, row, d) ->
// (bh / H) * o_batch + (bh % H) * o_head + row * o_row + d, d < D; lse, when
// not null, (BH, Nq) float32 natural-log log-sum-exp. Keys at or past
// n_real_k are masked, with lsa also key == row. threshold > 0 applies the
// keep mask of (seed, site) to the probabilities (the training kernel),
// scaling kept ones by drop_scale.
extern "C" int v1t_flash_attention(const void* q, const void* k, const void* v, void* out,
                                   void* lse, int BH, int Nq, int Nk, int n_real_k, int D,
                                   int DP, int H, int o_batch, int o_head, int o_row, int f32,
                                   int lsa, unsigned seed, unsigned site, unsigned threshold,
                                   float drop_scale, void* stream) {
  if (BH < 1 || BH > 65535 || H < 1 || D > DP || n_real_k > Nk || Nq < 1 || Nk < 1)
    return (int)cudaErrorInvalidValue;
  const Drop drop{seed, site, threshold, drop_scale};
  const RowLayout ol{H, o_batch, o_head, o_row};
  const bool train = threshold != 0u || lse != nullptr;
  cudaStream_t s = (cudaStream_t)stream;
  const bool f = f32 != 0;
  switch (DP) {
    case 32: return launch<32>(f, train, q, k, v, out, lse, BH, Nq, Nk, n_real_k, D, ol, lsa, drop, s);
    case 64: return launch<64>(f, train, q, k, v, out, lse, BH, Nq, Nk, n_real_k, D, ol, lsa, drop, s);
    case 96: return launch<96>(f, train, q, k, v, out, lse, BH, Nq, Nk, n_real_k, D, ol, lsa, drop, s);
    case 128: return launch<128>(f, train, q, k, v, out, lse, BH, Nq, Nk, n_real_k, D, ol, lsa, drop, s);
    case 160: return launch<160>(f, train, q, k, v, out, lse, BH, Nq, Nk, n_real_k, D, ol, lsa, drop, s);
    case 192: return launch<192>(f, train, q, k, v, out, lse, BH, Nq, Nk, n_real_k, D, ol, lsa, drop, s);
    case 224: return launch<224>(f, train, q, k, v, out, lse, BH, Nq, Nk, n_real_k, D, ol, lsa, drop, s);
    case 256: return launch<256>(f, train, q, k, v, out, lse, BH, Nq, Nk, n_real_k, D, ol, lsa, drop, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// Dynamic shared memory of a block of the bf16 (f32 == 0) or float32
// (f32 == 1) kernel at padded head width dp (0 for a width it is not built
// for).
extern "C" int v1t_flash_attention_smem(int dp, int f32) {
  const bool f = f32 != 0;
  switch (dp) {
    case 32: return fwd_smem<32>(f);
    case 64: return fwd_smem<64>(f);
    case 96: return fwd_smem<96>(f);
    case 128: return fwd_smem<128>(f);
    case 160: return fwd_smem<160>(f);
    case 192: return fwd_smem<192>(f);
    case 224: return fwd_smem<224>(f);
    case 256: return fwd_smem<256>(f);
    default: return 0;
  }
}
