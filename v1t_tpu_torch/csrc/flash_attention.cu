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
// Persistent: one block of three warpgroups a SM walks items of 128 query
// rows of one plane (block b takes items b, b + gridDim.x, ...). In
// warpgroup 0 one thread starts TMA copies: each item's q panel, into one
// of two panels up to DP 160 (the next item's q lands while this one's
// last tiles and epilogue run), then its key and value tiles of 64 into a
// ring of 3 stages (2 at DP 256) that runs on across items, each stage an
// mbarrier that the copies complete and another that the consumers
// release; the warpgroup gives up its registers (setmaxnreg 40 / 232).
// Above DP 160 (fwd_wide; o alone is DP / 2 fp32 a thread, 128 at DP 256)
// the block changes in four ways, each for what readings on an H100 showed:
// (1) one q panel, so that key tiles of 64 fit beside it (a second panel
// cost 32-key tiles: twice the barriers, rescales and waits per key); the
// next item's first key tiles go into the ring before its q, which is
// copied once the epilogue has left the panel; (2) K and V in rings of
// their own, each stage released when its product ends, K_j after S_j
// (early in step j - 1), V_j after P_j v_j: with one (K, V) stage a tile,
// the stage of tile j freed at the end of step j while step j + 1 opens
// with S of tile j + 2, and at DP 256, where 2 stages fit, every tile
// waited for its copy; (3) one set of P fragments, not two: P_j v_j goes as
// two commit groups (keys 0-31, 32-63) and tile j + 1's P is written into
// each half's fragments once that half's product is complete, the keep
// mask drawn one Philox at a time into a 32-bit mask (a loop not unrolled)
// while both run, and o rescaled only when its row max moved (a factor of
// 1 is exact); (4) setmaxnreg 24 / 240. ptxas allocates each region up to
// its setmaxnreg bound: at 40 / 232 the consumers spilled at DP 192-256. A
// producer warp instead (9 warps) held ptxas to 168 a thread (3 warps on
// one of an SM's four 16K-register files) and spilled more; no producer (8
// warps, 255 a thread), the copies started by a consumer thread, tied the
// two warpgroups together and ran slower.
// (At the flagship's 26 key tiles an item, against 534 at full resolution,
// an item's start and end weigh: here they overlap the next item's copies.
// The wide block at DP 160 ran row 1's core 6-10% slower on an H100 80GB
// HBM3 at 700 W, full resolution within 1%: tools/ab_forward_pipelines.py.)
// Warpgroups 1 and 2 own 64 rows each: S = q k^T is wgmma m64n64k16 with q
// and k from shared memory, o += P v is m64nDPk16 with P from registers.
// The accumulator's layout is mma.sync m16n8's C fragment per warp, so the
// online softmax's row shuffles and keep_frag_rows carry over. The pipeline
// within a warpgroup: S of tile j + 1 and P_j v_j are issued together, and
// tile j + 1's exp2 and Philox run while P_j v_j is on the tensor cores; o
// is rescaled when no product is in flight. Only tiles that reach masked
// keys (n_real_k, the LSA diagonal) mask element by element; elsewhere p =
// 2^(s log2 e - m) is one FFMA and one ex2. The same kernel is attention.cu's
// (the fused sublayer's core, wgmma_fwd.cuh): q_scale given, each consumer
// warpgroup scales its 64 rows of the Q panel in shared memory once, q_s =
// bf16(q scale_h log2 e), before its first product (a generic-proxy store
// that wgmma reads: fence.proxy.async and a named barrier of the
// warpgroup), and the scores and the LSE stay in log2 units. TMA, not cp.async: 16-byte
// cp.async copies from the loading warpgroup left the tensor cores waiting
// on an H100; a TMA copy is one instruction a sub-tile. The tensor map's
// encoder lives in libcuda and is reached through
// cudaGetDriverEntryPointByVersion; the map travels as a __grid_constant__
// parameter, its boxes one [rows][32] sub-tile in the 64-byte swizzle.
// float32 up to DP 256: FFMA on the CUDA cores, not TF32 (the fp32 model
// exists for float32 arithmetic; past 256, 3xTF32 keeps it, below). FFMA on an H100 outruns shared memory: its 128 lanes
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
// of bytes; at the sweep's widest heads (BH 64, N 1654, D 256) 0.179 TFLOP,
// 0.181 ms; at the fp32 flagship (BH 256, N 1654) 0.434 TFLOP, 6.5 ms at
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
// Above DP 256, in both types: the column groups, a block a (query tile,
// group of o's columns, plane). Up to 8 groups (DP 2048) the groups of a
// query tile are one cluster that sums the partial scores over each
// group's columns in distributed shared memory, so S is computed once:
// bf16 on wgmma (flash_fwd_cluster_kernel), float32 in 3xTF32 on the
// tensor cores (flash_fwd_f32_cluster_kernel, tf32.cuh). Past 8 groups
// every group recomputes S over the whole DP: bf16 flash_fwd_wide_kernel,
// float32 FFMA (flash_fwd_f32_wide_kernel). At the emb-768 path's shape
// (B*H 256, N 1654, D 768) the one-pass count is 2.15 TFLOP, a 2.18 ms
// bound in bf16, 32.1 ms at the fp32 rate and 13.0 ms as 3xTF32 (the
// products three times at 495 TFLOP/s); three groups recomputing S make it
// 4.3 TFLOP of products.
#include <cooperative_groups.h>

#include "hopper.cuh"
#include "tf32.cuh"
#include "wgmma_fwd.cuh"

namespace {

constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;
constexpr float MASKED = -1e30f;

// ---------------------------------------------------------------------------
// bf16 (wgmma, warp-specialised)

// A block owns BQ = 128 query rows of one (batch, head), in two consumer
// warpgroups of 64 rows. Up to DP 160 a third warpgroup, the first, loads;
// above (fwd_wide), one consumer thread.
constexpr int BQ = 128, WG = 128, FWD_THREADS = 3 * WG;

constexpr int BKV = 64;  // keys a tile
template <int DP>
__host__ __device__ constexpr bool fwd_wide() { return DP > 160; }
template <int DP>
__host__ __device__ constexpr int fwd_q_panels() { return fwd_wide<DP>() ? 1 : 2; }
// setmaxnreg: the producer's registers a thread, and the consumers' (at most
// 512 a thread across one warp of each warpgroup on each of an SM's four
// register files)
template <int DP>
__host__ __device__ constexpr int producer_regs() { return fwd_wide<DP>() ? 24 : 40; }
template <int DP>
__host__ __device__ constexpr int consumer_regs() { return fwd_wide<DP>() ? 240 : 232; }
template <int DP>
__host__ __device__ constexpr int fwd_stages() { return DP <= 224 ? 3 : 2; }

// fwd_q_panels Q panels [BQ][DP] (an item's and the next one's), then per
// stage a K and a V panel [BKV][DP], then the mbarriers (a pair per stage,
// above DP 160 one for K and one for V); 1024 bytes of slack to align the
// base
template <int DP>
constexpr int bf16_smem_bytes() {
  return 1024 +
         (fwd_q_panels<DP>() * BQ + 2 * fwd_stages<DP>() * BKV) * DP * (int)sizeof(bf16) +
         (4 + 2 * fwd_stages<DP>() * (fwd_wide<DP>() ? 2 : 1)) * 8;
}

// q_s = bf16(q sc) in place over the 64 rows of the Q panel from row0 (a
// consumer warpgroup's), columns at or past D set to zero; the stores are
// then made visible to wgmma's reads (the async proxy) and the warpgroup's
// 128 threads meet at named barrier 1 + c before its first product
template <int DP>
__device__ __forceinline__ void scale_q_rows(unsigned char* Qs, int row0, float sc, int D,
                                             int tid, int c) {
  constexpr int CHUNKS = 64 * DP / 8;  // 16-byte chunks of the 64 rows
  for (int i = tid; i < CHUNKS; i += WG) {
    const int sub = i >> 8, r = row0 + ((i >> 2) & 63), ch = i & 3;
    uint4* p = reinterpret_cast<uint4*>(Qs + sub * BQ * hopper::ROW_BYTES +
                                        r * hopper::ROW_BYTES + ch * 16);
    // the 64-byte swizzle moves whole 16-byte chunks: this one holds the
    // row's columns col .. col + 7
    const int col = sub * 32 + ((ch ^ ((r >> 1) & 3)) << 3);
    const uint4 in = *p;
    const uint32_t w[4] = {in.x, in.y, in.z, in.w};
    uint32_t o[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const __nv_bfloat162 pair = *reinterpret_cast<const __nv_bfloat162*>(&w[j]);
      o[j] = pack_bf16(col + 2 * j < D ? __low2float(pair) * sc : 0.f,
                       col + 2 * j + 1 < D ? __high2float(pair) * sc : 0.f);
    }
    *p = make_uint4(o[0], o[1], o[2], o[3]);
  }
  hopper::fence_async_smem();
  hopper::named_sync(1 + c, WG);
}

template <int DP, bool TRAIN>
__global__ void __launch_bounds__(FWD_THREADS, 1) flash_fwd_wgmma_kernel(
    const __grid_constant__ CUtensorMap qmap, const __grid_constant__ CUtensorMap kmap,
    const __grid_constant__ CUtensorMap vmap, bf16* __restrict__ out, float* __restrict__ lse,
    int Nq, int Nk, int n_real, int D, RowLayout ol, int lsa, Drop drop,
    const float* __restrict__ q_scale, int o_pad, int q_tiles, int items) {
  using namespace hopper;
  constexpr bool WIDE = fwd_wide<DP>();
  constexpr int QP = fwd_q_panels<DP>(), STAGES = fwd_stages<DP>();
  constexpr int Q_BYTES = BQ * DP * 2, KV_BYTES = BKV * DP * 2;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~(uintptr_t)1023);
  unsigned char* Qs = base;                     // [QP] Q panels
  unsigned char* Ks = Qs + QP * Q_BYTES;        // [STAGES] K panels
  unsigned char* Vs = Ks + STAGES * KV_BYTES;   // [STAGES] V panels
  uint64_t* q_full = reinterpret_cast<uint64_t*>(Vs + STAGES * KV_BYTES);  // [QP] q landed
  uint64_t* q_empty = q_full + 2;               // [QP] consumers done with a q panel
  uint64_t* full = q_empty + 2;                 // [STAGES] K and V (WIDE: K) landed
  uint64_t* empty = full + STAGES;              // [STAGES] consumers done with them
  uint64_t* v_full = empty + STAGES;            // WIDE: [STAGES] V landed
  uint64_t* v_empty = v_full + STAGES;          // WIDE: [STAGES] consumers done with V

  // persistent: block b takes items b, b + gridDim.x, ...; item w is query
  // tile w % q_tiles of plane w / q_tiles, so that the blocks running side
  // by side share a few planes' keys in L2. The key tiles of successive
  // items run through one ring, counted across items (tile0 before item it).
  const int wg = threadIdx.x / WG;
  const int ntiles = (Nk + BKV - 1) / BKV;
  if (threadIdx.x == 0) {
    for (int i = 0; i < 2; ++i) {
      bar_init(&q_full[i], 1);
      bar_init(&q_empty[i], 2 * WG);
    }
    for (int s = 0; s < STAGES; ++s) {
      bar_init(&full[s], 1);
      bar_init(&empty[s], 2 * WG);
      if (WIDE) {
        bar_init(&v_full[s], 1);
        bar_init(&v_empty[s], 2 * WG);
      }
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {  // producer: one thread starts the TMA copies of every tile
    regs_dec<producer_regs<DP>()>();
    if (threadIdx.x == 0) {
      int tile = 0;
      for (int it = 0, w = blockIdx.x; w < items; ++it, w += gridDim.x) {
        const int qt = w % q_tiles, bh = w / q_tiles, qb = QP == 2 ? it & 1 : 0;
        auto load_q = [&]() {
          // q panel qb was item it - QP's: free once its consumers are done
          if (it >= QP) bar_wait(&q_empty[qb], (uint32_t)(((QP == 2 ? it >> 1 : it) - 1) & 1));
          bar_expect(&q_full[qb], Q_BYTES);
          tma_panel<DP>(Qs + qb * Q_BYTES, &qmap, bh, qt * BQ, BQ, &q_full[qb]);
        };
        if (!WIDE || it == 0) load_q();
        for (int j = 0; j < ntiles; ++j, ++tile) {
          const int s = tile % STAGES;
          if (tile >= STAGES) bar_wait(&empty[s], (uint32_t)((tile / STAGES - 1) & 1));
          if constexpr (WIDE) {
            bar_expect(&full[s], KV_BYTES);
            tma_panel<DP>(Ks + s * KV_BYTES, &kmap, bh, j * BKV, BKV, &full[s]);
            if (tile >= STAGES) bar_wait(&v_empty[s], (uint32_t)((tile / STAGES - 1) & 1));
            bar_expect(&v_full[s], KV_BYTES);
            tma_panel<DP>(Vs + s * KV_BYTES, &vmap, bh, j * BKV, BKV, &v_full[s]);
            // one q panel: an item's first key tiles go into the rings
            // (their stages free as the last item's products end) before
            // its q, which waits for the last item's epilogue
            if (it > 0 && j + 1 == (ntiles < STAGES ? ntiles : STAGES)) load_q();
          } else {
            bar_expect(&full[s], 2 * KV_BYTES);
            tma_panel<DP>(Ks + s * KV_BYTES, &kmap, bh, j * BKV, BKV, &full[s]);
            tma_panel<DP>(Vs + s * KV_BYTES, &vmap, bh, j * BKV, BKV, &full[s]);
          }
        }
      }
    }
    return;
  }

  // consumers: warpgroup c owns rows 64 c .. 64 c + 63 of each item's tile
  regs_inc<consumer_regs<DP>()>();
  const int c = wg - 1, lane = threadIdx.x & 31, warp = (threadIdx.x / 32) & 3;
  const int g = lane >> 2, t = lane & 3;
  const uint32_t k_s = smem_u32(Ks), v_s = smem_u32(Vs);
  // the scores' units: log2 when q is scaled here (p = 2^(s - m), the LSE
  // m + log2 l), else natural (p = 2^(s log2 e - m), the LSE times ln 2)
  const float s_log2 = q_scale != nullptr ? 1.f : LOG2E;
  int tile0 = 0;
  for (int it = 0, w = blockIdx.x; w < items; ++it, w += gridDim.x, tile0 += ntiles) {
    const int qt = w % q_tiles, bh = w / q_tiles, qb = QP == 2 ? it & 1 : 0;
    const int row0 = qt * BQ + 64 * c + 16 * warp;  // this warp's 16 rows
    const int r0 = row0 + g, r1 = r0 + 8;
    const uint32_t q_s = smem_u32(Qs + qb * Q_BYTES);

    float o[DP / 2], s[BKV / 2];
#pragma unroll
    for (int i = 0; i < DP / 2; ++i) o[i] = 0.f;
    float m0 = MASKED, m1 = MASKED, l0 = 0.f, l1 = 0.f;

    // S = q k^T of key tile j into s (asynchronous; one commit group)
    auto issue_s = [&](int j) {
      const int st = (tile0 + j) % STAGES;
      bar_wait(&full[st], (uint32_t)(((tile0 + j) / STAGES) & 1));
      fence_regs(s);
      mma_fence();
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk)
        wgmma::Mma<BKV>::template ss<0, 0>(s, desc_k(q_s, BQ, 64 * c, kk),
                                           desc_k(k_s + st * KV_BYTES, BKV, 0, kk), kk > 0);
      mma_commit();
    };

    // the online softmax of tile j's scores (complete in s), in two parts:
    // the new running max, the rescale of o and l (and the scores' factor
    // scale); then P of the 8-key groups ni0 .. ni1 - 1 into pf as bf16 A
    // fragments, their row sums into l
    auto softmax_max = [&](int j, float& scale, float& a0, float& a1) {
      fence_regs(s);
      // only a tile that holds keys at or past n_real, or the block's
      // diagonal under LSA, is masked element by element (a uniform branch);
      // its scores go to log2 units first, as the plain versions mask them:
      // keys past Nk (the tile's zero fill) weigh nothing (-inf), else a row
      // with every key masked (LSA at N 1) would count them in its sum
      const bool edge = (j + 1) * BKV > n_real ||
                        (lsa && j * BKV < qt * BQ + BQ && (j + 1) * BKV > qt * BQ);
      scale = s_log2;  // p = 2^(s scale - m) in one FFMA
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
                                      : s[4 * ni + e] * s_log2;
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
    };
    // keep_bits: WIDE's keep mask of the tile, bit 4 ni + e for element e of
    // group ni (keep_mask); otherwise the mask is drawn here
    auto softmax_p = [&](int j, uint32_t (&pf)[BKV / 16][4], float scale, int ni0, int ni1,
                         uint32_t keep_bits) {
#pragma unroll
      for (int ni = ni0; ni < ni1; ++ni) {
        float p00 = ex2(fmaf(s[4 * ni + 0], scale, -m0));
        float p01 = ex2(fmaf(s[4 * ni + 1], scale, -m0));
        float p10 = ex2(fmaf(s[4 * ni + 2], scale, -m1));
        float p11 = ex2(fmaf(s[4 * ni + 3], scale, -m1));
        l0 += p00 + p01;
        l1 += p10 + p11;
        if (TRAIN && drop.on()) {  // select only: 1/keep folds into 1/l
          bool keep[4];
          if constexpr (WIDE) {
#pragma unroll
            for (int e = 0; e < 4; ++e) keep[e] = (keep_bits >> (4 * ni + e)) & 1u;
          } else {
            keep_frag_rows(drop, (uint32_t)bh, row0, j * BKV + ni * 8, lane, keep);
          }
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
    auto softmax = [&](int j, uint32_t (&pf)[BKV / 16][4], float& a0, float& a1) {
      float scale;
      softmax_max(j, scale, a0, a1);
      softmax_p(j, pf, scale, 0, BKV / 8, 0u);
    };
    // WIDE: the keep mask of tile j's elements, one Philox draw at a time (a
    // loop that is not unrolled), so that the draws of several groups do not
    // hold registers together
    auto keep_mask = [&](int j) {
      uint32_t bits = 0u;
      if (TRAIN && drop.on()) {
#pragma unroll 1
        for (int ni = 0; ni < BKV / 8; ++ni) {
          bool keep[4];
          keep_frag_rows(drop, (uint32_t)bh, row0, j * BKV + ni * 8, lane, keep);
          bits |= ((uint32_t)keep[0] | (uint32_t)keep[1] << 1 | (uint32_t)keep[2] << 2 |
                   (uint32_t)keep[3] << 3) << (4 * ni);
        }
      }
      return bits;
    };

    // FlashAttention-3's intra-warpgroup pipeline: S of tile j + 1 and o +=
    // P_j v_j are issued together, and tile j + 1's softmax (exp2, Philox)
    // runs while P_j v_j is on the tensor cores; o is rescaled only when no
    // product is in flight. The last tile has no successor and its own step,
    // so that every wait retires a known commit group.
    // o += P v of the keys 16 ks0 .. 16 ks1 - 1 of tile j (one commit group)
    auto pv_part = [&](int j, uint32_t (&pf)[BKV / 16][4], int ks0, int ks1) {
      if constexpr (WIDE) {
        if (ks0 == 0)
          bar_wait(&v_full[(tile0 + j) % STAGES], (uint32_t)(((tile0 + j) / STAGES) & 1));
      }
      fence_regs(o);
      mma_fence();
#pragma unroll
      for (int ks = ks0; ks < ks1; ++ks)
        wgmma::Mma<DP>::template rs<1>(o, pf[ks],
                                       desc_mn(v_s + ((tile0 + j) % STAGES) * KV_BYTES, BKV, 0,
                                               ks), 1);
      mma_commit();
    };
    auto pv = [&](int j, uint32_t (&pf)[BKV / 16][4]) { pv_part(j, pf, 0, BKV / 16); };
    // the stages of tile j: WIDE releases K_j once S_j is complete and V_j
    // once P_j v_j is; otherwise both once P_j v_j is
    auto release_k = [&](int j) {
      if constexpr (WIDE) bar_arrive(&empty[(tile0 + j) % STAGES]);
    };
    auto release_v = [&](int j) {
      bar_arrive(WIDE ? &v_empty[(tile0 + j) % STAGES] : &empty[(tile0 + j) % STAGES]);
    };
    auto step = [&](int j, uint32_t (&pf)[BKV / 16][4], uint32_t (&pf_next)[BKV / 16][4]) {
      issue_s(j + 1);
      pv(j, pf);
      mma_wait<1>();
      release_k(j + 1);
      float a0, a1;
      softmax(j + 1, pf_next, a0, a1);
      mma_wait<0>();
      fence_regs(o);
      fence_frags(pf);
      release_v(j);
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
      release_v(j);  // the next item's tiles refill it
    };
    // WIDE keeps one set of P fragments (o is DP / 2 fp32 a thread): P_j v_j
    // goes as two commit groups, of keys 0-31 and 32-63, and tile j + 1's P
    // is written into each half's fragments once that half's product is
    // complete (the row max and the keep mask while both run). o is
    // rescaled only when its row max moved (a factor of 1 is exact).
    auto step_wide = [&](int j, uint32_t (&pf)[BKV / 16][4]) {
      issue_s(j + 1);
      pv_part(j, pf, 0, BKV / 32);
      pv_part(j, pf, BKV / 32, BKV / 16);
      const uint32_t bits = keep_mask(j + 1);
      mma_wait<2>();
      release_k(j + 1);
      float scale, a0, a1;
      softmax_max(j + 1, scale, a0, a1);
      mma_wait<1>();
#pragma unroll
      for (int i = 0; i < BKV / 32; ++i)
#pragma unroll
        for (int k = 0; k < 4; ++k) asm volatile("" : "+r"(pf[i][k])::"memory");
      softmax_p(j + 1, pf, scale, 0, BKV / 16, bits);
      mma_wait<0>();
      fence_regs(o);
      fence_frags(pf);
      release_v(j);
      softmax_p(j + 1, pf, scale, BKV / 16, BKV / 8, bits);
      if (a0 != 1.f || a1 != 1.f) {
#pragma unroll
        for (int i = 0; i < DP / 8; ++i) {
          o[4 * i + 0] *= a0;
          o[4 * i + 1] *= a0;
          o[4 * i + 2] *= a1;
          o[4 * i + 3] *= a1;
        }
      }
    };

    uint32_t pa[BKV / 16][4], pb[BKV / 16][4];
    bar_wait(&q_full[qb], (uint32_t)((QP == 2 ? it >> 1 : it) & 1));
    if (q_scale != nullptr)
      scale_q_rows<DP>(Qs + qb * Q_BYTES, 64 * c, q_scale[bh % ol.H] * LOG2E, D,
                       threadIdx.x % WG, c);
    issue_s(0);
    mma_wait<0>();
    release_k(0);
    if constexpr (WIDE) {
      float scale, a0, a1;
      softmax_max(0, scale, a0, a1);
      softmax_p(0, pa, scale, 0, BKV / 8, keep_mask(0));
      int j = 0;
      for (; j + 1 < ntiles; ++j) step_wide(j, pa);
      last(j, pa);
    } else {
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
      const float lse_scale = q_scale != nullptr ? 1.f : LN2;
      float* lrow = lse + (size_t)bh * Nq;
      if (r0 < Nq) lrow[r0] = (m0 + log2f(fmaxf(l0, 1e-37f))) * lse_scale;
      if (r1 < Nq) lrow[r1] = (m1 + log2f(fmaxf(l1, 1e-37f))) * lse_scale;
    }
    // o leaves through shared memory: the warp's 16 rows go into its own
    // rows of this item's q panel (its products are complete; the panel's
    // swizzle keeps the fragments' 4-byte stores apart in the banks), then
    // out a row at a time with the lanes along the columns, 64 contiguous
    // bytes a store. Stored from the fragments, each store touched 8 rows,
    // and the epilogue was a large part of an item at 26 key tiles.
    unsigned char* qp = Qs + qb * Q_BYTES;
#pragma unroll
    for (int i = 0; i < DP / 8; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float inv = h ? inv1 : inv0;
        *reinterpret_cast<uint32_t*>(qp + elem_at(BQ, 64 * c + 16 * warp + g + 8 * h,
                                                  8 * i + 2 * t)) =
            pack_bf16(o[4 * i + 2 * h] * inv, o[4 * i + 2 * h + 1] * inv);
      }
    __syncwarp();
    const bool pad = o_pad > 0 && bh % ol.H == ol.H - 1;  // the rows' pad past the last head
#pragma unroll
    for (int rb = 0; rb < 16; rb += 4) {  // four rows' loads in flight before their stores
      bf16 v[4][DP / 32];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int k = 0; k < DP / 32; ++k)
          v[r][k] = *reinterpret_cast<const bf16*>(
              qp + elem_at(BQ, 64 * c + 16 * warp + rb + r, lane + 32 * k));
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        if (row0 + rb + r >= Nq) break;
        bf16* orow = out + ol.at(bh, row0 + rb + r);
#pragma unroll
        for (int k = 0; k < DP / 32; ++k)
          if (lane + 32 * k < D) orow[lane + 32 * k] = v[r][k];
        if (pad)
          for (int i = lane; i < o_pad; i += 32) orow[D + i] = __float2bfloat16_rn(0.f);
      }
    }
    // the panel's reads are done (ordered before the async proxy's next
    // write into it): the producer may refill it for item it + QP
    fence_async_smem();
    bar_arrive(&q_empty[qb]);
  }
}

// ---------------------------------------------------------------------------
// bf16 above DP 2048 (column groups that recompute S; up to 2048 the
// cluster kernel below)
//
// o of 64 rows is DP / 2 fp32 a thread, and a K tile of 64 keys at DP 768
// is 98 KB: neither the panels nor the accumulator scale past DP 256. So a
// block owns 128 query rows (two consumer warpgroups of 64) and one group
// of o's columns, at most WIDE_OG = 256 wide: the DP columns split into
// ceil(DP / 256) groups of equal width (a multiple of 32), one block a
// (query tile, group, plane). S is accumulated over the whole DP, q and K
// arriving in chunks of 64 columns ([128][64] and [64][64], TMA boxes of
// [rows][32]) through a ring of WIDE_A_STAGES; P v runs on the group's
// columns of V ([64][256], a ring of WIDE_V_STAGES) into o (m64n256k16, P
// from registers). Every group recomputes S: at DP 768 three times, so the
// products are 4/2 of the one-pass count (S three times, P v once). The
// keep mask is keyed by element (bh, query, key), so every group draws the
// same one; group 0 writes the LSE. No producer warpgroup: thread 0 starts
// the copies and refills a stage once every consumer thread has released
// it (an mbarrier a stage), so that the consumers keep the 255 registers a
// thread of a 256-thread block (o alone is 128). Within a warpgroup S, the
// softmax and P v run in turn; the two warpgroups overlap each other.
constexpr int WIDE_OG = 256, WIDE_CW = 64, WIDE_A_STAGES = 4, WIDE_V_STAGES = 2;
constexpr int WIDE_THREADS = 2 * WG;
constexpr int WIDE_A_BYTES = (BQ + BKV) * WIDE_CW * 2;  // a q chunk and a K chunk
constexpr int WIDE_V_BYTES = BKV * WIDE_OG * 2;         // a V panel of the group's columns

__host__ __device__ constexpr int wide_fwd_smem_bytes() {
  return 1024 + WIDE_A_STAGES * WIDE_A_BYTES + WIDE_V_STAGES * WIDE_V_BYTES +
         2 * (WIDE_A_STAGES + WIDE_V_STAGES) * 8;
}

// the column groups of DP (> 256) and their width (the last may be narrower)
__host__ __device__ constexpr int wide_groups(int dp) { return (dp + WIDE_OG - 1) / WIDE_OG; }
__host__ __device__ constexpr int wide_group_width(int dp) {
  return 32 * ((dp / 32 + wide_groups(dp) - 1) / wide_groups(dp));
}

template <bool TRAIN>
__global__ void __launch_bounds__(WIDE_THREADS, 1) flash_fwd_wide_kernel(
    const __grid_constant__ CUtensorMap qmap, const __grid_constant__ CUtensorMap kmap,
    const __grid_constant__ CUtensorMap vmap, bf16* __restrict__ out, float* __restrict__ lse,
    int Nq, int Nk, int n_real, int D, int DP, RowLayout ol, int lsa, Drop drop, int gw,
    int pair) {
  using namespace hopper;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~(uintptr_t)1023);
  unsigned char* As = base;                               // [A_STAGES] q chunk, K chunk
  unsigned char* Vs = As + WIDE_A_STAGES * WIDE_A_BYTES;  // [V_STAGES] V panels
  uint64_t* a_full = reinterpret_cast<uint64_t*>(Vs + WIDE_V_STAGES * WIDE_V_BYTES);
  uint64_t* a_empty = a_full + WIDE_A_STAGES;
  uint64_t* v_full = a_empty + WIDE_A_STAGES;
  uint64_t* v_empty = v_full + WIDE_V_STAGES;

  const int qt = blockIdx.x, gi = blockIdx.y, bh = blockIdx.z, tid = threadIdx.x;
  const int g0 = gi * gw, gcols = min(gw, DP - g0);  // the group's columns
  const int nc = (DP + WIDE_CW - 1) / WIDE_CW;        // chunks of S's reduction
  const int ntiles = (Nk + BKV - 1) / BKV, a_steps = ntiles * nc;
  if (tid == 0) {
    for (int s = 0; s < WIDE_A_STAGES; ++s) {
      bar_init(&a_full[s], 1);
      bar_init(&a_empty[s], WIDE_THREADS);
    }
    for (int s = 0; s < WIDE_V_STAGES; ++s) {
      bar_init(&v_full[s], 1);
      bar_init(&v_empty[s], WIDE_THREADS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // step i of the A ring: key tile i / nc, chunk i % nc (the last chunk is 32
  // columns wide when DP is an odd multiple of 32)
  auto issue_a = [&](int i) {
    const int s = i % WIDE_A_STAGES, j = i / nc, c = i - j * nc;
    const int boxes = min(WIDE_CW, DP - c * WIDE_CW) / 32;
    unsigned char* st = As + s * WIDE_A_BYTES;
    bar_expect(&a_full[s], (uint32_t)(boxes * (BQ + BKV) * ROW_BYTES));
    for (int b = 0; b < boxes; ++b) {
      tma_box(st + b * BQ * ROW_BYTES, &qmap, c * WIDE_CW + 32 * b, qt * BQ, bh, &a_full[s]);
      tma_box(st + BQ * WIDE_CW * 2 + b * BKV * ROW_BYTES, &kmap, c * WIDE_CW + 32 * b,
              j * BKV, bh, &a_full[s]);
    }
  };
  auto issue_v = [&](int j) {
    const int s = j % WIDE_V_STAGES;
    unsigned char* st = Vs + s * WIDE_V_BYTES;
    bar_expect(&v_full[s], (uint32_t)(gcols / 32 * BKV * ROW_BYTES));
    for (int b = 0; b < gcols / 32; ++b)
      tma_box(st + b * BKV * ROW_BYTES, &vmap, g0 + 32 * b, j * BKV, bh, &v_full[s]);
  };
  if (tid == 0) {
    for (int i = 0; i < min(WIDE_A_STAGES, a_steps); ++i) issue_a(i);
    for (int j = 0; j < min(WIDE_V_STAGES, ntiles); ++j) issue_v(j);
  }
  // every thread is done with A step i: thread 0 refills its stage
  auto release_a = [&](int i) {
    const int s = i % WIDE_A_STAGES;
    bar_arrive(&a_empty[s]);
    if (tid == 0 && i + WIDE_A_STAGES < a_steps) {
      bar_wait(&a_empty[s], (uint32_t)((i / WIDE_A_STAGES) & 1));
      issue_a(i + WIDE_A_STAGES);
    }
  };
  auto release_v = [&](int j) {
    const int s = j % WIDE_V_STAGES;
    bar_arrive(&v_empty[s]);
    if (tid == 0 && j + WIDE_V_STAGES < ntiles) {
      bar_wait(&v_empty[s], (uint32_t)((j / WIDE_V_STAGES) & 1));
      issue_v(j + WIDE_V_STAGES);
    }
  };

  // warpgroup c owns rows 64 c .. 64 c + 63 of the query tile
  const int c = tid / WG, lane = tid & 31, warp = (tid / 32) & 3;
  const int g = lane >> 2, t = lane & 3;
  const int row0 = qt * BQ + 64 * c + 16 * warp;  // this warp's 16 rows
  const int r0 = row0 + g, r1 = r0 + 8;
  float o[WIDE_OG / 2], s[BKV / 2];
#pragma unroll
  for (int i = 0; i < WIDE_OG / 2; ++i) o[i] = 0.f;
  float m0 = MASKED, m1 = MASKED, l0 = 0.f, l1 = 0.f;
  uint32_t pf[BKV / 16][4];

  for (int j = 0; j < ntiles; ++j) {
    // S = q k^T of key tile j over DP, a chunk of 64 columns at a time
    for (int cc = 0; cc < nc; ++cc) {
      const int i = j * nc + cc, st = i % WIDE_A_STAGES;
      bar_wait(&a_full[st], (uint32_t)((i / WIDE_A_STAGES) & 1));
      const uint32_t q_s = smem_u32(As + st * WIDE_A_BYTES), k_s = q_s + BQ * WIDE_CW * 2;
      const int kks = min(WIDE_CW, DP - cc * WIDE_CW) / 16;
      mma_fence();
#pragma unroll
      for (int kk = 0; kk < WIDE_CW / 16; ++kk)
        if (kk < kks)
          wgmma::Mma<BKV>::template ss<0, 0>(s, desc_k(q_s, BQ, 64 * c, kk),
                                             desc_k(k_s, BKV, 0, kk), cc > 0 || kk > 0);
      mma_commit();
      if (cc > 0) {  // the previous chunk's products are done: its stage is free
        mma_wait<1>();
        release_a(i - 1);
      }
    }
    mma_wait<0>();
    fence_regs(s);
    release_a(j * nc + nc - 1);

    // the online softmax of the tile's scores (flash_fwd_wgmma_kernel's):
    // the new running max, o and l rescaled, P as bf16 A fragments
    const bool edge = (j + 1) * BKV > n_real ||
                      (lsa && j * BKV < qt * BQ + BQ && (j + 1) * BKV > qt * BQ);
    float scale = LOG2E;
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
    const float a0 = ex2(m0 - mx0), a1 = ex2(m1 - mx1);
    m0 = mx0;
    m1 = mx1;
    l0 *= a0;
    l1 *= a1;
#pragma unroll
    for (int ni = 0; ni < BKV / 8; ++ni) {
      float p00 = ex2(fmaf(s[4 * ni + 0], scale, -m0));
      float p01 = ex2(fmaf(s[4 * ni + 1], scale, -m0));
      float p10 = ex2(fmaf(s[4 * ni + 2], scale, -m1));
      float p11 = ex2(fmaf(s[4 * ni + 3], scale, -m1));
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
      pf[ni >> 1][(ni & 1) * 2 + 0] = pack_bf16(p00, p01);
      pf[ni >> 1][(ni & 1) * 2 + 1] = pack_bf16(p10, p11);
    }
    if (a0 != 1.f || a1 != 1.f) {  // no product in flight: o rescaled
#pragma unroll
      for (int i = 0; i < WIDE_OG / 8; ++i) {
        o[4 * i + 0] *= a0;
        o[4 * i + 1] *= a0;
        o[4 * i + 2] *= a1;
        o[4 * i + 3] *= a1;
      }
    }

    // o += P v over the group's columns
    const int vs = j % WIDE_V_STAGES;
    bar_wait(&v_full[vs], (uint32_t)((j / WIDE_V_STAGES) & 1));
    fence_regs(o);
    mma_fence();
#pragma unroll
    for (int ks = 0; ks < BKV / 16; ++ks)
      wgmma::Mma<WIDE_OG>::template rs<1>(o, pf[ks],
                                          desc_mn(smem_u32(Vs + vs * WIDE_V_BYTES), BKV, 0, ks), 1);
    mma_commit();
    mma_wait<0>();
    fence_regs(o);
    fence_frags(pf);
    release_v(j);
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
  if (gi == 0 && lse != nullptr && t == 0) {
    float* lrow = lse + (size_t)bh * Nq;
    if (r0 < Nq) lrow[r0] = (m0 + log2f(fmaxf(l0, 1e-37f))) * LN2;
    if (r1 < Nq) lrow[r1] = (m1 + log2f(fmaxf(l1, 1e-37f))) * LN2;
  }
  // o's group columns below D, from the fragments (two columns a store
  // where both lie below D and the layout keeps them 4-byte aligned)
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = h ? r1 : r0;
    if (row >= Nq) continue;
    const float inv = h ? inv1 : inv0;
    bf16* orow = out + ol.at(bh, row);
#pragma unroll
    for (int i = 0; i < WIDE_OG / 8; ++i) {
      const int cl = 8 * i + 2 * t, col = g0 + cl;
      if (cl >= gcols || col >= D) continue;
      const float v0 = o[4 * i + 2 * h] * inv, v1 = o[4 * i + 2 * h + 1] * inv;
      if (pair && col + 1 < D) {
        *reinterpret_cast<uint32_t*>(orow + col) = pack_bf16(v0, v1);
      } else {
        orow[col] = __float2bfloat16_rn(v0);
        if (col + 1 < D) orow[col + 1] = __float2bfloat16_rn(v1);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// bf16 above DP 256, up to 2048: the column groups of a query tile as one
// thread-block cluster that computes S once
//
// What held flash_fwd_wide_kernel (above) at DP 768: every group recomputed
// S over the whole DP (the products 4/2 of the one-pass count), and for
// every key tile all of q's and K's chunks streamed again from L2 (8.5 MB a
// block, 43 FLOP a byte: more than half the call at L2's ~5.7 TB/s), with S,
// the softmax and P v in turn and thread 0 refilling the rings after
// waiting on them. Here the G = ceil(DP / 256) <= CL_MAX_GROUPS groups of a
// 128-query tile are one cluster along grid y (flash_fwd_f32_cluster_kernel's
// design, on wgmma): block g keeps its group's q columns resident ([128][<= 256], 64
// KB, copied once), streams only its group's K and V columns (64-key tiles,
// [64][256] each), computes its partial S over those columns (wgmma
// m64n64k16), and every block adds all G partials through distributed
// shared memory in group order 0 .. G - 1: every block holds the same S
// bits, draws the same P and keep mask (keyed by element) and block 0
// writes the LSE; o += P v_g (m64n256k16, P from registers) on its own
// columns. So S is computed once (the one-pass count, 2.15 TFLOP at the
// emb-768 shape) and a block reads ~1.7 MB from L2, not 8.5; the exchange
// moves (G - 1) x 32 KB a block and key tile over the cluster's network.
// Shared memory (written down before the design): q 64 KB, a K tile 32 KB,
// a V tile 32 KB, a 128 x 64 float32 partial 32 KB; double-buffering all
// four needs 256 KB, past a block's 232,448. So K and V are double-buffered
// (128 KB) and the partial is one buffer with two cluster barriers a tile
// (229,440 bytes with the barriers): B1 after a block wrote its partial
// (P_j-1 v_j-1 runs between its arrive and wait), B2 after it read every
// partial (its wait comes after the next tile's partial products are
// issued). No empty barriers: the barriers say when a stage is free, so
// thread 0 issues K_j+2 right after B1 of tile j and V_j right after B2 of
// tile j - 1, and never waits on the consumers. Past 8 groups the
// recomputing kernel above stays.
constexpr int CL_MAX_GROUPS = 8, CL_THREADS = 2 * WG;
constexpr int CL_Q_BYTES = BQ * WIDE_OG * 2, CL_KV_BYTES = BKV * WIDE_OG * 2;
constexpr int CL_S_BYTES = BQ * BKV * 4;  // a block's partial scores, float32

__host__ __device__ constexpr int cluster_fwd_smem_bytes() {
  return 1024 + CL_Q_BYTES + 4 * CL_KV_BYTES + CL_S_BYTES + 8 * 8;
}

template <bool TRAIN>
__global__ void __launch_bounds__(CL_THREADS, 1) flash_fwd_cluster_kernel(
    const __grid_constant__ CUtensorMap qmap, const __grid_constant__ CUtensorMap kmap,
    const __grid_constant__ CUtensorMap vmap, bf16* __restrict__ out, float* __restrict__ lse,
    int Nq, int Nk, int n_real, int D, int DP, RowLayout ol, int lsa, Drop drop, int gw,
    int pair) {
  using namespace hopper;
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~(uintptr_t)1023);
  unsigned char* Qs = base;                  // [BQ][<= 256] the group's q columns
  unsigned char* Ks = Qs + CL_Q_BYTES;       // [2][BKV][<= 256] K tiles of the group's columns
  unsigned char* Vs = Ks + 2 * CL_KV_BYTES;  // [2][BKV][<= 256] V tiles
  float4* Sp = reinterpret_cast<float4*>(Vs + 2 * CL_KV_BYTES);  // [8][CL_THREADS] the partial
  uint64_t* q_full = reinterpret_cast<uint64_t*>(Sp + 8 * CL_THREADS);
  uint64_t* k_full = q_full + 1;  // [2]
  uint64_t* v_full = k_full + 2;  // [2]

  const int G = (int)cluster.num_blocks(), gi = (int)cluster.block_rank();
  const int qt = blockIdx.x, bh = blockIdx.z, tid = threadIdx.x;
  const int g0 = gi * gw, gcols = min(gw, DP - g0);  // the group's columns
  const int ntiles = (Nk + BKV - 1) / BKV;
  const uint32_t kv_bytes = (uint32_t)(gcols / 32 * BKV * ROW_BYTES);
  if (tid == 0) {
    bar_init(q_full, 1);
    for (int s = 0; s < 2; ++s) {
      bar_init(&k_full[s], 1);
      bar_init(&v_full[s], 1);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // the q and K sub-tiles past the group's columns hold zeros, so that the
  // partial scores always run over 256 columns: no product is predicated
  // (a wgmma behind a branch is serialised), and the zeros add nothing
  const int tail = (WIDE_OG - gcols) / 32;  // sub-tiles past the group's columns
  uint4* qz = reinterpret_cast<uint4*>(Qs + gcols / 32 * BQ * ROW_BYTES);
  for (int i = tid; i < tail * BQ * ROW_BYTES / 16; i += CL_THREADS) qz[i] = make_uint4(0u, 0u, 0u, 0u);
  for (int st = 0; st < 2; ++st) {
    uint4* kz = reinterpret_cast<uint4*>(Ks + st * CL_KV_BYTES + gcols / 32 * BKV * ROW_BYTES);
    for (int i = tid; i < tail * BKV * ROW_BYTES / 16; i += CL_THREADS)
      kz[i] = make_uint4(0u, 0u, 0u, 0u);
  }
  fence_async_smem();
  __syncthreads();
  auto issue_k = [&](int j) {
    unsigned char* st = Ks + (j & 1) * CL_KV_BYTES;
    bar_expect(&k_full[j & 1], kv_bytes);
    for (int b = 0; b < gcols / 32; ++b)
      tma_box(st + b * BKV * ROW_BYTES, &kmap, g0 + 32 * b, j * BKV, bh, &k_full[j & 1]);
  };
  auto issue_v = [&](int j) {
    unsigned char* st = Vs + (j & 1) * CL_KV_BYTES;
    bar_expect(&v_full[j & 1], kv_bytes);
    for (int b = 0; b < gcols / 32; ++b)
      tma_box(st + b * BKV * ROW_BYTES, &vmap, g0 + 32 * b, j * BKV, bh, &v_full[j & 1]);
  };
  if (tid == 0) {
    bar_expect(q_full, (uint32_t)(gcols / 32 * BQ * ROW_BYTES));
    for (int b = 0; b < gcols / 32; ++b)
      tma_box(Qs + b * BQ * ROW_BYTES, &qmap, g0 + 32 * b, qt * BQ, bh, q_full);
    for (int j = 0; j < min(2, ntiles); ++j) {
      issue_k(j);
      issue_v(j);
    }
  }

  // warpgroup c owns rows 64 c .. 64 c + 63 of the query tile
  const int c = tid / WG, lane = tid & 31, warp = (tid / 32) & 3;
  const int g = lane >> 2, t = lane & 3;
  const int row0 = qt * BQ + 64 * c + 16 * warp;  // this warp's 16 rows
  const int r0 = row0 + g, r1 = r0 + 8;
  const uint32_t q_s = smem_u32(Qs);
  float o[WIDE_OG / 2], s[BKV / 2];
#pragma unroll
  for (int i = 0; i < WIDE_OG / 2; ++i) o[i] = 0.f;
  float m0 = MASKED, m1 = MASKED, l0 = 0.f, l1 = 0.f;
  uint32_t pf[BKV / 16][4];
  auto pv = [&](int j) {  // o += P_j v_j over the group's columns
    const int vs = j & 1;
    bar_wait_or_trap(&v_full[vs], (uint32_t)((j >> 1) & 1));
    fence_regs(o);
    mma_fence();
#pragma unroll
    for (int ks = 0; ks < BKV / 16; ++ks)
      wgmma::Mma<WIDE_OG>::template rs<1>(
          o, pf[ks], desc_mn(smem_u32(Vs + vs * CL_KV_BYTES), BKV, 0, ks), 1);
    mma_commit();
  };
  bar_wait_or_trap(q_full, 0u);

  for (int j = 0; j < ntiles; ++j) {
    // the partial scores of key tile j over the group's columns
    bar_wait_or_trap(&k_full[j & 1], (uint32_t)((j >> 1) & 1));
    const uint32_t k_s = smem_u32(Ks + (j & 1) * CL_KV_BYTES);
    mma_fence();
#pragma unroll
    for (int kk = 0; kk < WIDE_OG / 16; ++kk)
      wgmma::Mma<BKV>::template ss<0, 0>(s, desc_k(q_s, BQ, 64 * c, kk), desc_k(k_s, BKV, 0, kk),
                                         kk > 0);
    mma_commit();
    if (j > 0) cluster_wait();  // B2 of tile j - 1: every block has read the partials
    mma_wait<0>();
    fence_regs(s);
    if (tid == 0 && j >= 2) issue_v(j);  // over v_j-2, whose products ended before B2
#pragma unroll
    for (int q = 0; q < BKV / 8; ++q)
      Sp[q * CL_THREADS + tid] = make_float4(s[4 * q], s[4 * q + 1], s[4 * q + 2], s[4 * q + 3]);
    cluster_arrive();  // B1 of tile j: this block's partial is in place
    if (j > 0) pv(j - 1);
    cluster_wait();
    // S: the groups' partials in group order, the same bits in every block
    // (into registers of their own: no wgmma accumulator is written while
    // P v runs, which ptxas would serialise)
    float sc[BKV / 2];
    for (int r = 0; r < G; ++r) {
      const float4* pr = cluster.map_shared_rank(Sp, r);
#pragma unroll
      for (int q = 0; q < BKV / 8; ++q) {
        const float4 x = pr[q * CL_THREADS + tid];
        sc[4 * q] = r == 0 ? x.x : sc[4 * q] + x.x;
        sc[4 * q + 1] = r == 0 ? x.y : sc[4 * q + 1] + x.y;
        sc[4 * q + 2] = r == 0 ? x.z : sc[4 * q + 2] + x.z;
        sc[4 * q + 3] = r == 0 ? x.w : sc[4 * q + 3] + x.w;
      }
    }
    if (j > 0) {  // P_j-1 v_j-1 is done: o and P's fragments are free
      mma_wait<0>();
      fence_regs(o);
      fence_frags(pf);
    }
    // over K_j: every thread of the block finished its products before B1
    if (tid == 0 && j + 2 < ntiles) issue_k(j + 2);
    cluster_arrive();  // B2 of tile j: this block has read every partial

    // the online softmax of the tile's scores (flash_fwd_wide_kernel's)
    const bool edge = (j + 1) * BKV > n_real ||
                      (lsa && j * BKV < qt * BQ + BQ && (j + 1) * BKV > qt * BQ);
    float scale = LOG2E;
    if (edge) {
      scale = 1.f;
#pragma unroll
      for (int ni = 0; ni < BKV / 8; ++ni)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = j * BKV + ni * 8 + 2 * t + (e & 1);
          const bool masked = key >= n_real || (lsa && key == ((e >> 1) ? r1 : r0));
          sc[4 * ni + e] = key >= Nk ? __int_as_float(0xff800000u)
                          : masked  ? MASKED
                                    : sc[4 * ni + e] * LOG2E;
        }
    }
    float mx0 = sc[0], mx1 = sc[2];
#pragma unroll
    for (int ni = 0; ni < BKV / 8; ++ni) {
      mx0 = fmaxf(mx0, fmaxf(sc[4 * ni + 0], sc[4 * ni + 1]));
      mx1 = fmaxf(mx1, fmaxf(sc[4 * ni + 2], sc[4 * ni + 3]));
    }
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
    mx0 = fmaxf(m0, mx0 * scale);
    mx1 = fmaxf(m1, mx1 * scale);
    const float a0 = ex2(m0 - mx0), a1 = ex2(m1 - mx1);
    m0 = mx0;
    m1 = mx1;
    l0 *= a0;
    l1 *= a1;
#pragma unroll
    for (int ni = 0; ni < BKV / 8; ++ni) {
      float p00 = ex2(fmaf(sc[4 * ni + 0], scale, -m0));
      float p01 = ex2(fmaf(sc[4 * ni + 1], scale, -m0));
      float p10 = ex2(fmaf(sc[4 * ni + 2], scale, -m1));
      float p11 = ex2(fmaf(sc[4 * ni + 3], scale, -m1));
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
      pf[ni >> 1][(ni & 1) * 2 + 0] = pack_bf16(p00, p01);
      pf[ni >> 1][(ni & 1) * 2 + 1] = pack_bf16(p10, p11);
    }
    if (a0 != 1.f || a1 != 1.f) {  // no product in flight: o rescaled
#pragma unroll
      for (int i = 0; i < WIDE_OG / 8; ++i) {
        o[4 * i + 0] *= a0;
        o[4 * i + 1] *= a0;
        o[4 * i + 2] *= a1;
        o[4 * i + 3] *= a1;
      }
    }
  }
  pv(ntiles - 1);
  mma_wait<0>();
  fence_regs(o);
  fence_frags(pf);
  cluster_wait();  // B2 of the last tile: no block leaves while another reads its partial

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
  if (gi == 0 && lse != nullptr && t == 0) {
    float* lrow = lse + (size_t)bh * Nq;
    if (r0 < Nq) lrow[r0] = (m0 + log2f(fmaxf(l0, 1e-37f))) * LN2;
    if (r1 < Nq) lrow[r1] = (m1 + log2f(fmaxf(l1, 1e-37f))) * LN2;
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = h ? r1 : r0;
    if (row >= Nq) continue;
    const float inv = h ? inv1 : inv0;
    bf16* orow = out + ol.at(bh, row);
#pragma unroll
    for (int i = 0; i < WIDE_OG / 8; ++i) {
      const int cl = 8 * i + 2 * t, col = g0 + cl;
      if (cl >= gcols || col >= D) continue;
      const float v0 = o[4 * i + 2 * h] * inv, v1 = o[4 * i + 2 * h + 1] * inv;
      if (pair && col + 1 < D) {
        *reinterpret_cast<uint32_t*>(orow + col) = pack_bf16(v0, v1);
      } else {
        orow[col] = __float2bfloat16_rn(v0);
        if (col + 1 < D) orow[col + 1] = __float2bfloat16_rn(v1);
      }
    }
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
// float32 above DP 256 (column groups)
//
// o of 64 rows at DP 768 would be 192 fp32 registers a thread, and q with a
// K and a V tile 600 KB of shared memory. So a block owns 64 query rows (4
// a thread, as at DP 192-256) and one group of o's columns, the bf16
// kernels' split (wide_groups, wide_group_width: at most WIDE_OG = 256
// wide), one block a (query tile, group, plane). S is accumulated over the
// whole DP from a q and a K chunk of WIDE_CW = 64 columns ([64][68] each) at
// a time, in a two-stage cp.async ring that runs on across key tiles (the
// last chunk zero-filled past DP, so that its product adds nothing); the
// group's V columns ([64][260]) are copied while the tile's first chunks
// are computed. The softmax, P through shared memory and o += P v on the
// group's columns are flash_fwd_f32_kernel's. Every group recomputes S: at
// DP 768 three times, so the products are 4/2 of the one-pass count. The
// keep mask is keyed by element, so every group draws the same one; group
// 0 writes the LSE. One instance a training flag serves every multiple of
// 32 past 8 groups (DP 2048; below, the cluster kernel) (the group's width
// is a multiple of 32; a warp skips the column blocks past it).

// the ring's two stages of a q and a K chunk, the group's V columns, P
__host__ __device__ constexpr int f32_wide_smem_bytes() {
  return (2 * 2 * f32_tile_floats(F32_KB, WIDE_CW) + f32_tile_floats(F32_KB, WIDE_OG) +
          F32_KB * (F32_KB + 4)) * (int)sizeof(float);
}

template <bool TRAIN>
__global__ void __launch_bounds__(F32_THREADS, 1) flash_fwd_f32_wide_kernel(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    float* __restrict__ out, float* __restrict__ lse, int Nq, int Nk, int n_real, int D, int DP,
    RowLayout ol, int lsa, Drop drop, int gw) {
  constexpr int RQ = 4, QB = 16 * RQ, KB = F32_KB, CW = WIDE_CW;
  constexpr int CLD = CW + 4, VLD = WIDE_OG + 4, PLD = KB + 4, C4 = CW / 4;
  constexpr int V4 = WIDE_OG / 4, CV = WIDE_OG / 32;
  constexpr int CT = f32_tile_floats(KB, CW);  // a q or a K chunk (QB == KB rows)
  static_assert(QB == KB, "a q chunk and a K chunk share one shape");
  extern __shared__ __align__(16) float fsm[];
  float* As = fsm;                             // [2 stages] q chunk, K chunk
  float* Vs = As + 4 * CT;                     // the group's V columns
  float* Ps = Vs + f32_tile_floats(KB, WIDE_OG);  // [QB][PLD] the kept probabilities

  // lane = 2 cl + rl: rows rbase + 2 i (i < RQ) of the warp's 8; keys
  // 4 cl .. 4 cl + 3 of a tile for S, float2 columns cl + 16 j of the
  // group (j < cv) for o
  const int tid = threadIdx.x, lane = tid & 31, cl = lane >> 1;
  const int rbase = (tid >> 5) * 2 * RQ + (lane & 1);
  const int qt = blockIdx.x, gi = blockIdx.y, bh = blockIdx.z;
  const int g0 = gi * gw, gcols = min(gw, DP - g0), cv = gcols / 32;
  const int nc = (DP + CW - 1) / CW, ntiles = (Nk + KB - 1) / KB, steps = ntiles * nc;
  const float* qg = q + (size_t)bh * Nq * DP;
  const float* kg = k + (size_t)bh * Nk * DP;
  const float* vg = v + (size_t)bh * Nk * DP;

  // ring step i: key tile i / nc, chunk i % nc of the tile's q rows and keys
  auto load_chunk = [&](int i) {
    const int j = i / nc, c0 = (i - j * nc) * CW;
    float* st = As + (i & 1) * 2 * CT;
    for (int x = tid; x < KB * C4; x += F32_THREADS) {
      const int r = x / C4, c = (x - r * C4) * 4, col = c0 + c;
      const int row = qt * QB + r, key = j * KB + r;
      const bool qv = row < Nq && col < DP, kv = key < Nk && col < DP;
      cp_async16(st + f32_row(r, CLD) + c, qg + (qv ? (size_t)row * DP + col : 0), qv);
      cp_async16(st + CT + f32_row(r, CLD) + c, kg + (kv ? (size_t)key * DP + col : 0), kv);
    }
    cp_async_commit();
  };
  auto load_v = [&](int j) {
    for (int x = tid; x < KB * V4; x += F32_THREADS) {
      const int r = x / V4, c = (x - r * V4) * 4, key = j * KB + r;
      if (c >= gcols) continue;
      const bool valid = key < Nk;
      cp_async16(Vs + f32_row(r, VLD) + c, vg + (valid ? (size_t)key * DP + g0 + c : 0), valid);
    }
    cp_async_commit();
  };
  load_chunk(0);

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
    // S = q k^T over DP, a chunk at a time. The copies go out in the order
    // chunk i + 1, V_kt at chunk 0, so that chunk 1 waits for its own copy
    // alone; V_kt has landed by chunk 2 (DP > 256: at least 5 chunks)
    float s[RQ][4];
#pragma unroll
    for (int i = 0; i < RQ; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[i][e] = 0.f;
    for (int c = 0; c < nc; ++c) {
      const int i = kt * nc + c;
      if (c == 1) cp_async_wait<1>();
      else cp_async_wait<0>();
      // chunk i has landed; every thread is done with chunk i - 1 and, at
      // chunk 0, with P_kt-1 v_kt-1
      __syncthreads();
      if (i + 1 < steps) load_chunk(i + 1);
      if (c == 0) load_v(kt);
      const float* qs = As + (i & 1) * 2 * CT;
      const float* ks = qs + CT;
#pragma unroll 2
      for (int d = 0; d < CW; d += 4) {
        float4 a[RQ], b[4];
#pragma unroll
        for (int i2 = 0; i2 < RQ; ++i2)
          a[i2] = *reinterpret_cast<const float4*>(qs + f32_row(rbase + 2 * i2, CLD) + d);
#pragma unroll
        for (int e = 0; e < 4; ++e)
          b[e] = *reinterpret_cast<const float4*>(ks + f32_row(4 * cl + e, CLD) + d);
#pragma unroll
        for (int i2 = 0; i2 < RQ; ++i2)
#pragma unroll
          for (int e = 0; e < 4; ++e) s[i2][e] = dot4(s[i2][e], a[i2], b[e]);
      }
    }

    // the online softmax, as flash_fwd_f32_kernel's
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

    // o += P v over the group's columns (V_kt has landed: see above)
#pragma unroll 2
    for (int kk = 0; kk < KB; kk += 4) {
      float4 pv[RQ];
#pragma unroll
      for (int i = 0; i < RQ; ++i)
        pv[i] = *reinterpret_cast<const float4*>(Ps + (rbase + 2 * i) * PLD + kk);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float* vr = Vs + f32_row(kk + e, VLD) + 2 * cl;
#pragma unroll
        for (int j = 0; j < CV; ++j) {
          if (j >= cv) continue;
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
    if (gi == 0 && lse != nullptr && cl == 0)
      lse[(size_t)bh * Nq + row] = (m[i] + log2f(fmaxf(li, 1e-37f))) * LN2;
    float* orow = out + ol.at(bh, row);
#pragma unroll
    for (int j = 0; j < CV; ++j) {
      const int col = g0 + 2 * cl + 32 * j;
      if (j >= cv) continue;
      if (col < D) orow[col] = o[i][j].x * inv;
      if (col + 1 < D) orow[col + 1] = o[i][j].y * inv;
    }
  }
}

// ---------------------------------------------------------------------------
// float32 above DP 256, up to 2048: 3xTF32 in a cluster of the column groups
//
// The groups of one (64-query tile, plane) are one thread-block cluster,
// block g (its rank) owning group g's columns (wide_groups,
// wide_group_width; at most 256 wide, at most C_MAX_GROUPS = 8 groups: a
// portable cluster). Block g keeps the tile's q columns of its group in
// shared memory for the whole loop and streams its group's K and V columns
// in key tiles of 32 through cp.async rings of two stages. For each key
// tile it computes the partial scores over its own columns (a split of the
// DP reduction), the cluster meets at a barrier, and every block adds the
// partials of all groups through distributed shared memory in group order
// 0 .. G - 1: every block holds the same S bits, so it draws the same P
// and keep mask (keyed by element), and block 0 writes the LSE. The
// partials are double-buffered, so a key tile costs one cluster barrier (a
// block reuses a buffer two tiles on, after every block has passed the
// barrier between). Each block adds P v_g into its own o columns, one tile
// late: P_j-1 v_j-1 runs between the barrier's arrive and wait of tile j.
// So S is computed once, the products are the one-pass count (4 BH Nq Nk
// DP), and q is read once a block. Products on the tensor cores in 3xTF32
// (tf32.cuh): S as m16n8k8 tiles, a warp 16 queries x 16 keys over the
// group's columns (q and K by ldmatrix, split in registers, two
// accumulator sets by k-step parity); the softmax a thread a row's 8 keys (two
// Philox groups), P split into its TF32 parts in shared memory once by its
// owner; o a warp all 64 rows x 32 of the group's columns (P by ldmatrix,
// v read across its rows and split), each tile's product from zero, added
// to o by an FFMA with the rescale. Tiles swizzled by row (tf32.cuh), no
// padding: q [64][256], K and V [2][32][256], two partial score buffers and
// P's two parts [64][32]: 229,632 bytes, one block a SM. mma.sync, not
// wgmma: wgmma takes TF32 operands from shared memory only K-major, and o
// += P v is not (v would need a transposed copy, and each small part a
// tile of its own). What each cost takes, and mma.sync's TF32 rate alone:
// tools/f32_wide_costs.py.
constexpr int C_QB = 64, C_KB = 32, C_OG = 256, C_THREADS = 256, C_MAX_GROUPS = 8;
constexpr int C_TILE = C_KB * C_OG;  // floats of a K or a V tile

__host__ __device__ constexpr int f32_cluster_smem_bytes() {
  return (C_QB * C_OG + 4 * C_TILE + 2 * C_QB * C_KB + 2 * C_QB * C_KB + C_QB) *
         (int)sizeof(float);
}

template <bool TRAIN>
__global__ void __launch_bounds__(C_THREADS, 1) flash_fwd_f32_cluster_kernel(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    float* __restrict__ out, float* __restrict__ lse, int Nq, int Nk, int n_real, int D, int DP,
    RowLayout ol, int lsa, Drop drop, int gw) {
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  extern __shared__ __align__(16) float fsm[];
  float* Qs = fsm;                   // [64][256] the tile's q columns of the group
  float* Ks = Qs + C_QB * C_OG;      // [2][32][256] key tiles of the group's columns
  float* Vs = Ks + 2 * C_TILE;       // [2][32][256]
  float* Sp = Vs + 2 * C_TILE;       // [2][64][32] the partial scores over the group
  float* Pb = Sp + 2 * C_QB * C_KB;  // [64][32] the kept P, its TF32 big part
  float* Pl = Pb + C_QB * C_KB;      // [64][32] ... and its small part
  float* Al = Pl + C_QB * C_KB;      // [64] each row's rescale; at the end 1 / l

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, g = lane >> 2, t = lane & 3;
  const int G = (int)cluster.num_blocks(), gi = (int)cluster.block_rank();
  const int qt = blockIdx.x, bh = blockIdx.z;
  const int g0 = gi * gw, gcols = min(gw, DP - g0);
  const int ntiles = (Nk + C_KB - 1) / C_KB;
  const float* qg = q + (size_t)bh * Nq * DP + g0;
  const float* kg = k + (size_t)bh * Nk * DP + g0;
  const float* vg = v + (size_t)bh * Nk * DP + g0;

  // 16-byte chunks: a thread takes chunk tid % 64 of every fourth row (no
  // division), those past the group's columns left alone
  const int lc = (tid & 63) * 4, lr = tid >> 6;
  if (lc < gcols)  // committed with key tile 0
    for (int r = lr; r < C_QB; r += C_THREADS / 64) {
      const int row = qt * C_QB + r;
      const bool valid = row < Nq;
      cp_async16(Qs + tf32::at(r, lc, C_OG), qg + (valid ? (size_t)row * DP + lc : 0), valid);
    }
  // K_j goes into stage j % 2 at step j - 1, V_j at step j (P_j v_j runs
  // at step j + 1, while the cluster meets)
  auto load_rows = [&](float* dst, const float* src, int j) {
    if (lc >= gcols) return;
    for (int r = lr; r < C_KB; r += C_THREADS / 64) {
      const int key = j * C_KB + r;
      const bool valid = key < Nk;
      cp_async16(dst + (j & 1) * C_TILE + tf32::at(r, lc, C_OG),
                 src + (valid ? (size_t)key * DP + lc : 0), valid);
    }
  };
  load_rows(Ks, kg, 0);
  cp_async_commit();

  // S: warp w, queries 16 (w % 4) .. + 15, keys 16 (w / 4) .. + 15 (two n-tiles)
  const int smt = warp & 3, skh = warp >> 2;
  // the softmax: row sr (8 a warp), keys 8 t .. 8 t + 7 of the tile
  const int sr = 8 * warp + g, srow = qt * C_QB + sr;
  const int s_lo = tf32::at(sr, 8 * t, C_KB), s_hi = tf32::at(sr, 8 * t + 4, C_KB);
  // o: warp w, rows 16 i + g (+ 8) (i < 4), columns 32 w + 8 n + 2t (+ 1) of the group
  const bool pv = 32 * warp < gcols;
  float o[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[i][n][e] = 0.f;
  float m = MASKED, l = 0.f;  // row sr's running max, and this lane's part of its sum

  // o = o alpha_j + P_j v_j on the warp's 32 columns (alpha_j, P_j in shared
  // memory). The tile's product starts from zero on the tensor cores and is
  // added to o by an FFMA: the tensor cores' float32 accumulation drops
  // bits an addition, and o carried through them across all key tiles
  // strayed several times further from the plain version (in two halves of
  // the columns, so that the tile's sums take 32 registers)
  auto pv_step = [&](int j) {
    const float* vt = Vs + (j & 1) * C_TILE;
    float al[4][2];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      al[i][0] = Al[16 * i + g];
      al[i][1] = Al[16 * i + g + 8];
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float d[4][2][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int n = 0; n < 2; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) d[i][n][e] = 0.f;
#pragma unroll
      for (int k0 = 0; k0 < C_KB; k0 += 8) {
        uint32_t ab[4][4], as[4][4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          tf32::load_a(ab[i], Pb, C_KB, 16 * i, k0, lane);
          tf32::load_a(as[i], Pl, C_KB, 16 * i, k0, lane);
        }
#pragma unroll
        for (int n = 0; n < 2; ++n) {
          uint32_t bb[2], bs[2];
          tf32::load_bt(bb, bs, vt, C_OG, k0, 32 * warp + 16 * h + 8 * n, lane);
#pragma unroll
          for (int i = 0; i < 4; ++i) tf32::mma3(d[i][n], ab[i], as[i], bb, bs);
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int n = 0; n < 2; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            o[i][2 * h + n][e] = fmaf(o[i][2 * h + n][e], al[i][e >> 1], d[i][n][e]);
    }
  };

  // step j: tile j's partial scores, then (while the cluster meets) P_j-1
  // v_j-1, then tile j's softmax; step ntiles only the last P v, and its
  // barrier keeps every block until the others have read its partials
  for (int j = 0; j <= ntiles; ++j) {
    cp_async_wait<0>();
    // K_j and v_j-1 have landed; P_j-1 and its rescales are in shared
    // memory; every thread is done with K_j-1 and v_j-2
    __syncthreads();
    const bool tile = j < ntiles;
    if (j + 1 < ntiles) load_rows(Ks, kg, j + 1);
    if (tile) load_rows(Vs, vg, j);
    cp_async_commit();
    float* sp = Sp + (j & 1) * C_QB * C_KB;
    if (tile) {  // the partial scores over the group's columns
      float acc[2][4];
      tf32::product_rows(acc, tf32::RowPairLoader(Qs, Ks + (j & 1) * C_TILE, C_OG, 16 * smt,
                                                  16 * skh, lane), gcols);
#pragma unroll
      for (int n = 0; n < 2; ++n) {
        const int r0 = 16 * smt + g, c = 16 * skh + 8 * n + 2 * t;
        *reinterpret_cast<float2*>(sp + tf32::at(r0, c, C_KB)) = make_float2(acc[n][0], acc[n][1]);
        *reinterpret_cast<float2*>(sp + tf32::at(r0 + 8, c, C_KB)) =
            make_float2(acc[n][2], acc[n][3]);
      }
    }
    // every group's partial scores of tile j in place; meanwhile P_j-1 v_j-1
    hopper::cluster_arrive();
    if (j > 0 && pv) pv_step(j - 1);
    hopper::cluster_wait();
    if (!tile) break;
    __syncthreads();  // every thread is done with P_j-1 and its rescales
    {
      // S of row sr: the groups' partials in group order, alike in every
      // block; then the online softmax in log2 units, masked as
      // flash_fwd_f32_kernel masks
      float s[8];
      for (int r = 0; r < G; ++r) {
        const float* rp = cluster.map_shared_rank(sp, r);
        const float4 x0 = *reinterpret_cast<const float4*>(rp + s_lo);
        const float4 x1 = *reinterpret_cast<const float4*>(rp + s_hi);
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const float x = lane4(e < 4 ? x0 : x1, e & 3);
          s[e] = r == 0 ? x : s[e] + x;
        }
      }
      const int key0 = j * C_KB + 8 * t;
      float mx = MASKED;
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const int key = key0 + e;
        float x = s[e] * LOG2E;
        if (key >= Nk) x = __int_as_float(0xff800000u);  // -inf
        else if (key >= n_real || (lsa && key == srow)) x = MASKED;
        s[e] = x;
        mx = fmaxf(mx, x);
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      mx = fmaxf(m, mx);
      const float alpha = exp2f(m - mx);
      m = mx;
      l *= alpha;
      uint4 w0 = make_uint4(0u, 0u, 0u, 0u), w1 = w0;
      if (TRAIN && drop.on()) {
        w0 = keep_words(drop, (uint32_t)bh, (uint32_t)srow, (uint32_t)key0 >> 2);
        w1 = keep_words(drop, (uint32_t)bh, (uint32_t)srow, ((uint32_t)key0 >> 2) + 1u);
      }
      uint32_t pb[8], pl[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        float p = exp2f(s[e] - mx);
        l += p;
        if (TRAIN && drop.on() && word_of(e < 4 ? w0 : w1, e & 3) >= drop.threshold) p = 0.f;
        tf32::split(p, pb[e], pl[e]);
      }
      *reinterpret_cast<uint4*>(Pb + s_lo) = make_uint4(pb[0], pb[1], pb[2], pb[3]);
      *reinterpret_cast<uint4*>(Pb + s_hi) = make_uint4(pb[4], pb[5], pb[6], pb[7]);
      *reinterpret_cast<uint4*>(Pl + s_lo) = make_uint4(pl[0], pl[1], pl[2], pl[3]);
      *reinterpret_cast<uint4*>(Pl + s_hi) = make_uint4(pl[4], pl[5], pl[6], pl[7]);
      if (t == 0) Al[sr] = alpha;
    }
  }
  __syncthreads();  // every thread is done with the last P and its rescales

  {  // row sr's sum over its four lanes; block 0 writes the LSE
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    float inv = l == 0.f ? 1.f : 1.f / l;
    if (TRAIN && drop.on()) inv *= drop.scale;
    if (t == 0) {
      Al[sr] = inv;
      if (gi == 0 && lse != nullptr && srow < Nq)
        lse[(size_t)bh * Nq + srow] = (m + log2f(fmaxf(l, 1e-37f))) * LN2;
    }
  }
  __syncthreads();
  if (!pv) return;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = 16 * i + g + 8 * h, row = qt * C_QB + r;
      if (row >= Nq) continue;
      const float inv = Al[r];
      float* orow = out + ol.at(bh, row) + g0;
#pragma unroll
      for (int n = 0; n < 4; ++n) {
        const int col = 32 * warp + 8 * n + 2 * t;
        if (col >= gcols) continue;
        if (g0 + col < D) orow[col] = o[i][n][2 * h] * inv;
        if (g0 + col + 1 < D) orow[col + 1] = o[i][n][2 * h + 1] * inv;
      }
    }
}

// ---------------------------------------------------------------------------

template <int DP, bool TRAIN>
int launch_f32(const void* q, const void* k, const void* v, void* out, void* lse, int BH,
               int Nq, int Nk, int n_real, int D, RowLayout ol, int lsa, Drop drop,
               cudaStream_t stream) {
  constexpr int bytes = f32_smem_bytes<DP>();
  const cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_f32_kernel<DP, TRAIN>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  constexpr int QB = f32_queries<DP>();
  flash_fwd_f32_kernel<DP, TRAIN><<<dim3((Nq + QB - 1) / QB, BH), F32_THREADS, bytes, stream>>>(
      (const float*)q, (const float*)k, (const float*)v, (float*)out, (float*)lse, Nq, Nk,
      n_real, D, ol, lsa, drop);
  return (int)cudaGetLastError();
}

template <int DP>
int launch_f32_dp(bool train, const void* q, const void* k, const void* v, void* out,
                  void* lse, int BH, int Nq, int Nk, int n_real, int D, RowLayout ol, int lsa,
                  Drop drop, cudaStream_t stream) {
  if (train)
    return launch_f32<DP, true>(q, k, v, out, lse, BH, Nq, Nk, n_real, D, ol, lsa, drop, stream);
  return launch_f32<DP, false>(q, k, v, out, lse, BH, Nq, Nk, n_real, D, ol, lsa, drop, stream);
}

template <bool TRAIN>
int launch_f32_wide(const void* q, const void* k, const void* v, void* out, void* lse, int BH,
                    int Nq, int Nk, int n_real, int D, int DP, RowLayout ol, int lsa, Drop drop,
                    cudaStream_t stream) {
  constexpr int bytes = f32_wide_smem_bytes();
  const cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_f32_wide_kernel<TRAIN>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)((Nq + F32_KB - 1) / F32_KB), (unsigned)wide_groups(DP), (unsigned)BH);
  flash_fwd_f32_wide_kernel<TRAIN><<<grid, F32_THREADS, bytes, stream>>>(
      (const float*)q, (const float*)k, (const float*)v, (float*)out, (float*)lse, Nq, Nk,
      n_real, D, DP, ol, lsa, drop, wide_group_width(DP));
  return (int)cudaGetLastError();
}

// the float32 column groups up to C_MAX_GROUPS groups: one cluster a (query
// tile, plane); a refused cluster launch returns its error
template <bool TRAIN>
int launch_f32_cluster(const void* q, const void* k, const void* v, void* out, void* lse,
                       int BH, int Nq, int Nk, int n_real, int D, int DP, RowLayout ol, int lsa,
                       Drop drop, cudaStream_t stream) {
  constexpr int bytes = f32_cluster_smem_bytes();
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_f32_cluster_kernel<TRAIN>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  const int groups = wide_groups(DP);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)((Nq + C_QB - 1) / C_QB), (unsigned)groups, (unsigned)BH);
  cfg.blockDim = dim3(C_THREADS, 1u, 1u);
  cfg.dynamicSmemBytes = (size_t)bytes;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1u;
  attr[0].val.clusterDim.y = (unsigned)groups;
  attr[0].val.clusterDim.z = 1u;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, flash_fwd_f32_cluster_kernel<TRAIN>, (const float*)q,
                           (const float*)k, (const float*)v, (float*)out, (float*)lse, Nq, Nk,
                           n_real, D, DP, ol, lsa, drop, wide_group_width(DP));
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

template <int DP, bool TRAIN>
int launch_wgmma(const bf16* q, const bf16* k, const bf16* v, bf16* out, float* lse, int BH,
                 int Nq, int Nk, int n_real, int D, RowLayout ol, int lsa, Drop drop,
                 const float* q_scale, int o_pad, cudaStream_t stream) {
  constexpr int bytes = bf16_smem_bytes<DP>();
  CUtensorMap qmap, kmap, vmap;
  int rc;
  if ((rc = hopper::make_panel_map(&qmap, q, BH, Nq, DP, BQ)) != 0 ||
      (rc = hopper::make_panel_map(&kmap, k, BH, Nk, DP, BKV)) != 0 ||
      (rc = hopper::make_panel_map(&vmap, v, BH, Nk, DP, BKV)) != 0)
    return rc;
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_wgmma_kernel<DP, TRAIN>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  int device = 0, sms = 0;
  if ((err = cudaGetDevice(&device)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device)) != cudaSuccess)
    return (int)err;
  const int q_tiles = (Nq + BQ - 1) / BQ, items = q_tiles * BH;  // one block a SM
  flash_fwd_wgmma_kernel<DP, TRAIN><<<items < sms ? items : sms, FWD_THREADS, bytes, stream>>>(
      qmap, kmap, vmap, out, lse, Nq, Nk, n_real, D, ol, lsa, drop, q_scale, o_pad, q_tiles,
      items);
  return (int)cudaGetLastError();
}

template <int DP>
int launch_wgmma_dp(bool train, const bf16* q, const bf16* k, const bf16* v, bf16* out,
                    float* lse, int BH, int Nq, int Nk, int n_real, int D, RowLayout ol,
                    int lsa, Drop drop, const float* q_scale, int o_pad, cudaStream_t stream) {
  if (train)
    return launch_wgmma<DP, true>(q, k, v, out, lse, BH, Nq, Nk, n_real, D, ol, lsa, drop,
                                  q_scale, o_pad, stream);
  return launch_wgmma<DP, false>(q, k, v, out, lse, BH, Nq, Nk, n_real, D, ol, lsa, drop,
                                 q_scale, o_pad, stream);
}

template <bool TRAIN>
int launch_wide(const bf16* q, const bf16* k, const bf16* v, bf16* out, float* lse, int BH,
                int Nq, int Nk, int n_real, int D, int DP, RowLayout ol, int lsa, Drop drop,
                cudaStream_t stream) {
  constexpr int bytes = wide_fwd_smem_bytes();
  CUtensorMap qmap, kmap, vmap;
  int rc;
  if ((rc = hopper::make_panel_map(&qmap, q, BH, Nq, DP, BQ)) != 0 ||
      (rc = hopper::make_panel_map(&kmap, k, BH, Nk, DP, BKV)) != 0 ||
      (rc = hopper::make_panel_map(&vmap, v, BH, Nk, DP, BKV)) != 0)
    return rc;
  const cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_wide_kernel<TRAIN>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  const int pair = D % 2 == 0 && ol.batch % 2 == 0 && ol.head % 2 == 0 && ol.row % 2 == 0 &&
                   (reinterpret_cast<uintptr_t>(out) & 3) == 0;
  const dim3 grid((unsigned)((Nq + BQ - 1) / BQ), (unsigned)wide_groups(DP), (unsigned)BH);
  flash_fwd_wide_kernel<TRAIN><<<grid, WIDE_THREADS, bytes, stream>>>(
      qmap, kmap, vmap, out, lse, Nq, Nk, n_real, D, DP, ol, lsa, drop, wide_group_width(DP),
      pair);
  return (int)cudaGetLastError();
}

template <bool TRAIN>
int launch_cluster(const bf16* q, const bf16* k, const bf16* v, bf16* out, float* lse, int BH,
                   int Nq, int Nk, int n_real, int D, int DP, RowLayout ol, int lsa, Drop drop,
                   cudaStream_t stream) {
  constexpr int bytes = cluster_fwd_smem_bytes();
  CUtensorMap qmap, kmap, vmap;
  int rc;
  if ((rc = hopper::make_panel_map(&qmap, q, BH, Nq, DP, BQ)) != 0 ||
      (rc = hopper::make_panel_map(&kmap, k, BH, Nk, DP, BKV)) != 0 ||
      (rc = hopper::make_panel_map(&vmap, v, BH, Nk, DP, BKV)) != 0)
    return rc;
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_cluster_kernel<TRAIN>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  const int pair = D % 2 == 0 && ol.batch % 2 == 0 && ol.head % 2 == 0 && ol.row % 2 == 0 &&
                   (reinterpret_cast<uintptr_t>(out) & 3) == 0;
  const int groups = wide_groups(DP);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)((Nq + BQ - 1) / BQ), (unsigned)groups, (unsigned)BH);
  cfg.blockDim = dim3(CL_THREADS, 1u, 1u);
  cfg.dynamicSmemBytes = (size_t)bytes;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1u;
  attr[0].val.clusterDim.y = (unsigned)groups;
  attr[0].val.clusterDim.z = 1u;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, flash_fwd_cluster_kernel<TRAIN>, qmap, kmap, vmap, out, lse, Nq,
                           Nk, n_real, D, DP, ol, lsa, drop, wide_group_width(DP), pair);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace

int wgmma_fwd::launch(const bf16* q, const bf16* k, const bf16* v, bf16* out, float* lse,
                      int BH, int Nq, int Nk, int n_real, int D, int DP, RowLayout ol, int lsa,
                      Drop drop, const float* q_scale, int o_pad, bool train,
                      cudaStream_t stream) {
  if (BH < 1 || BH > 65535 || D > DP || n_real > Nk || Nq < 1 || Nk < 1)
    return (int)cudaErrorInvalidValue;
  if (DP > 256) {  // the column groups, in natural-log units only: a cluster up to 8
    if (DP % 32 != 0 || q_scale != nullptr || o_pad != 0) return (int)cudaErrorInvalidValue;
    if (wide_groups(DP) <= CL_MAX_GROUPS)
      return train ? launch_cluster<true>(q, k, v, out, lse, BH, Nq, Nk, n_real, D, DP, ol, lsa,
                                          drop, stream)
                   : launch_cluster<false>(q, k, v, out, lse, BH, Nq, Nk, n_real, D, DP, ol, lsa,
                                           drop, stream);
    return train ? launch_wide<true>(q, k, v, out, lse, BH, Nq, Nk, n_real, D, DP, ol, lsa, drop,
                                     stream)
                 : launch_wide<false>(q, k, v, out, lse, BH, Nq, Nk, n_real, D, DP, ol, lsa,
                                      drop, stream);
  }
  switch (DP) {
    case 32: return launch_wgmma_dp<32>(train, q, k, v, out, lse, BH, Nq, Nk, n_real, D, ol, lsa, drop, q_scale, o_pad, stream);
    case 64: return launch_wgmma_dp<64>(train, q, k, v, out, lse, BH, Nq, Nk, n_real, D, ol, lsa, drop, q_scale, o_pad, stream);
    case 96: return launch_wgmma_dp<96>(train, q, k, v, out, lse, BH, Nq, Nk, n_real, D, ol, lsa, drop, q_scale, o_pad, stream);
    case 128: return launch_wgmma_dp<128>(train, q, k, v, out, lse, BH, Nq, Nk, n_real, D, ol, lsa, drop, q_scale, o_pad, stream);
    case 160: return launch_wgmma_dp<160>(train, q, k, v, out, lse, BH, Nq, Nk, n_real, D, ol, lsa, drop, q_scale, o_pad, stream);
    case 192: return launch_wgmma_dp<192>(train, q, k, v, out, lse, BH, Nq, Nk, n_real, D, ol, lsa, drop, q_scale, o_pad, stream);
    case 224: return launch_wgmma_dp<224>(train, q, k, v, out, lse, BH, Nq, Nk, n_real, D, ol, lsa, drop, q_scale, o_pad, stream);
    case 256: return launch_wgmma_dp<256>(train, q, k, v, out, lse, BH, Nq, Nk, n_real, D, ol, lsa, drop, q_scale, o_pad, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

int wgmma_fwd::smem(int dp) {
  if (dp > 256)
    return dp % 32 != 0                        ? 0
           : wide_groups(dp) <= CL_MAX_GROUPS ? cluster_fwd_smem_bytes()
                                               : wide_fwd_smem_bytes();
  switch (dp) {
    case 32: return bf16_smem_bytes<32>();
    case 64: return bf16_smem_bytes<64>();
    case 96: return bf16_smem_bytes<96>();
    case 128: return bf16_smem_bytes<128>();
    case 160: return bf16_smem_bytes<160>();
    case 192: return bf16_smem_bytes<192>();
    case 224: return bf16_smem_bytes<224>();
    case 256: return bf16_smem_bytes<256>();
    default: return 0;
  }
}

// Returns a CUDA error code (0 on success). q (BH, Nq, DP), k and v (BH, Nk,
// DP), bf16 (f32 == 0) or float32 (f32 == 1), rows zero-padded from D to
// DP any multiple of 32 (above 256 on column groups); out in the same dtype at element (bh, row, d) ->
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
  if (f32 == 0)
    return wgmma_fwd::launch((const bf16*)q, (const bf16*)k, (const bf16*)v, (bf16*)out,
                             (float*)lse, BH, Nq, Nk, n_real_k, D, DP, ol, lsa, drop, nullptr, 0,
                             train, s);
  if (DP > 256) {  // the column groups: a cluster of them up to 8, else FFMA
    if (DP % 32 != 0) return (int)cudaErrorInvalidValue;
    if (wide_groups(DP) <= C_MAX_GROUPS)
      return train ? launch_f32_cluster<true>(q, k, v, out, lse, BH, Nq, Nk, n_real_k, D, DP, ol,
                                              lsa, drop, s)
                   : launch_f32_cluster<false>(q, k, v, out, lse, BH, Nq, Nk, n_real_k, D, DP, ol,
                                               lsa, drop, s);
    return train ? launch_f32_wide<true>(q, k, v, out, lse, BH, Nq, Nk, n_real_k, D, DP, ol,
                                         lsa, drop, s)
                 : launch_f32_wide<false>(q, k, v, out, lse, BH, Nq, Nk, n_real_k, D, DP, ol,
                                          lsa, drop, s);
  }
  switch (DP) {
    case 32: return launch_f32_dp<32>(train, q, k, v, out, lse, BH, Nq, Nk, n_real_k, D, ol, lsa, drop, s);
    case 64: return launch_f32_dp<64>(train, q, k, v, out, lse, BH, Nq, Nk, n_real_k, D, ol, lsa, drop, s);
    case 96: return launch_f32_dp<96>(train, q, k, v, out, lse, BH, Nq, Nk, n_real_k, D, ol, lsa, drop, s);
    case 128: return launch_f32_dp<128>(train, q, k, v, out, lse, BH, Nq, Nk, n_real_k, D, ol, lsa, drop, s);
    case 160: return launch_f32_dp<160>(train, q, k, v, out, lse, BH, Nq, Nk, n_real_k, D, ol, lsa, drop, s);
    case 192: return launch_f32_dp<192>(train, q, k, v, out, lse, BH, Nq, Nk, n_real_k, D, ol, lsa, drop, s);
    case 224: return launch_f32_dp<224>(train, q, k, v, out, lse, BH, Nq, Nk, n_real_k, D, ol, lsa, drop, s);
    case 256: return launch_f32_dp<256>(train, q, k, v, out, lse, BH, Nq, Nk, n_real_k, D, ol, lsa, drop, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// Dynamic shared memory of a block of the bf16 (f32 == 0) or float32
// (f32 == 1) kernel at padded head width dp (0 for a width it is not built
// for; above 256: the column groups', one size at every width).
extern "C" int v1t_flash_attention_smem(int dp, int f32) {
  if (f32 == 0) return wgmma_fwd::smem(dp);
  if (dp > 256)
    return dp % 32 != 0 ? 0
           : wide_groups(dp) <= C_MAX_GROUPS ? f32_cluster_smem_bytes() : f32_wide_smem_bytes();
  switch (dp) {
    case 32: return f32_smem_bytes<32>();
    case 64: return f32_smem_bytes<64>();
    case 96: return f32_smem_bytes<96>();
    case 128: return f32_smem_bytes<128>();
    case 160: return f32_smem_bytes<160>();
    case 192: return f32_smem_bytes<192>();
    case 224: return f32_smem_bytes<224>();
    case 256: return f32_smem_bytes<256>();
    default: return 0;
  }
}
