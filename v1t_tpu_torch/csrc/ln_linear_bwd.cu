// ln_linear_bwd: the backward of ln_linear.cu, in two kernels.
//
// Replaces the projection backwards inside two TPU kernels:
//   v1t_tpu/ops/fused_mha.py _mha_bwd_kernel_dt2 (:676): the out-projection's
//     masked cotangent (:701-712), do = Wp dout (:714-718), the QKV
//     backward d(ln) = [dq; dk; dv] Wqkv (:824-827), the weight gradients
//     (:828-835) and the LayerNorm backward with the residual and bias_row
//     cotangents (:837-857);
//   v1t_tpu/ops/fused_mlp.py _mlp_bwd_kernel (:150): both dropout masks, the
//     fc2 and fc1 backwards with GELU' and the LayerNorm backward.
// attention_bwd.cu carries the attention core between them.
//
// 1. ln_linear_dx: dX = dY' W, where dY' is dY (row-major (M, N), or
//    head-major (S, B, heads, rows, head_pad) as ln_linear writes q/k/v and
//    attention_bwd writes dq/dk/dv) with its keep mask applied and scaled.
//    Each dY' element is read from device memory and its keep word drawn
//    once a call, for K up to 160 and wherever the block's dY' rows fit in
//    shared memory (dx_plan). A block of 128 rows (8 warps of mma.sync
//    m16n8k16, 32 rows x 80 columns each) owns an output tile of 160
//    columns and walks the reduction in chunks of 32 stored columns through
//    a ring of up to 4 stages of 16-byte cp.async, each stage one W^T chunk
//    (160 x 32, from L2, shared by the block's rows) and one dY chunk:
//    - long reduction, K <= 160 (qkv: 1860 -> 155; fc1: 488 -> 155): dY
//      streams once. A head-major dY is read as it lies, 160 columns per
//      (s, h) plane, against W^T padded per head to head_pad (the wrapper
//      builds it), so its pad columns meet zero weights;
//    - short reduction, wide output (out-projection: 155 -> 620; fc2: 155
//      -> 488): the block's dY' rows stay in shared memory ("resident"),
//      copied and masked once, for every 160-column output tile while W^T
//      streams;
//    - otherwise (K > 160 and dY too wide to stay: the sweep's qkv at emb
//      192-256) dY streams once per output tile.
//    Rows of 155 bf16 are not 16-byte aligned: each row's segment is copied
//    as the aligned granules that hold it and unpacked in shared memory,
//    where the keep mask is applied (one Philox per 4 columns); aligned rows
//    go straight into the product's tile (masked in place). 64-row blocks
//    serve the widest LayerNorms. Epilogues:
//    - plain: through an fp32 tile, 4 columns a thread and rows written
//      whole: dX in bf16, optionally with fc1's keep mask (one Philox) and
//      GELU'(pre) on the way (the fc2 backward emits fc1's dY' directly,
//      from the saved pre-GELU activation);
//    - LayerNorm (K <= 640, ln_linear.cu's limit): the block keeps its
//      BM x K fp32 d(ln) rows in shared memory, over the freed ring when K
//      fits one tile (92 KB a block: two blocks a SM, at 128 registers a
//      thread); one warp per row, 4 rows at a time, recomputes z = x (+
//      row), its mean and rstd as ln_linear.cu did, and the row sums
//      mean(d(ln) gamma) and mean(d(ln) gamma xhat); then one column a
//      thread over the block's rows writes dz = rstd (d(ln) gamma - mean(.)
//      - xhat mean(. xhat)) (+ the residual's cotangent) and the recomputed
//      bf16 LayerNorm output for the weight gradient, and writes the block's
//      d(gamma), d(beta) and per-batch d(bias_row) sums as partials (one
//      row a block, or a (block, batch) pair), which a small kernel adds in
//      an order fixed by the shape: the same bits every run, with or
//      without --deterministic. It replaced one float atomic a column and
//      block: qkv 0.645 and fc1 0.283 ms against the parent's 0.652 and
//      0.296 (tools/ab_fixed_order.py, an NVIDIA H100 80GB HBM3 at 700 W).
//      A LayerNorm past wx::LN_MAX_K (2048; no configuration reaches it)
//      sends each output tile's fp32 products to (M, K) float32 scratch in
//      device memory (dln), shared memory keeps the 4 statistics a row, and
//      the same block reads its rows back (L2) for the row sums and dz. One
//      block a SM (255 registers a thread: the 128-register bound of two
//      spilled).
//    Past K 640 (ViT-Base width: qkv and fc1 at K 768, the out-projection
//    and fc2 at K 3072, and the sweep's out-projections and fc2 past 640)
//    every dX runs on wx::dx_wgmma_kernel, which is bound by operations
//    (2 M N K over ~2 (M N + N K + M K) bytes: ~480 FLOP/byte at emb 768):
//    - the products on wgmma m64n256k16 (both operands in shared memory,
//      fp32 accumulators in registers): a block owns 128 rows x 256 output
//      columns, two consumer warpgroups of 64 rows (setmaxnreg 232); a
//      producer thread fills a ring of 4 stages of 64 reduction columns
//      ([128][64] of dY', [256][64] of W^T, 48 KB, 128-byte swizzled TMA
//      boxes) behind mbarriers. A head-major dY is read as it lies, in
//      chunks within each (s, h) plane (a 3-D map over column, row, plane;
//      zeros past head_pad), so its pad columns meet zero weights and a row
//      tile lies within a batch;
//    - each block copies its own stages. TMA multicast of dY' to the
//      blocks of a row tile was built and timed first, and was slower: a
//      stage then has to be free in every block before any block's copy
//      may land in it, and the cross-block releases (remote mbarrier
//      arrivals, from the consumers or forwarded by the producer) sat on
//      the products' path. A row tile's blocks run side by side (one
//      cluster, or consecutive blocks), so that all but the first find each
//      dY' chunk in L2: dY' comes from device memory about once;
//    - dY's keep mask is drawn once per element: a masked or unaligned
//      row-major dY is first written masked into (M, NS) aligned scratch by
//      dx_prep_kernel (one Philox per 4 columns; a read and a write of dY,
//      tools/ab_dx.py times the out-projection with and without it), since
//      drawing it in each block would redraw every word once per output
//      tile (12 times at K 3072);
//    - the epilogues work from the fp32 tile staged over the freed ring
//      (rolled loops, coalesced 8- or 16-byte accesses). Plain: 4 columns
//      an item, fc1's keep mask (one Philox) and GELU'(pre), loads of 8
//      items ahead of their arithmetic (the producer asks L2 for the
//      tile's pre rows before the products start). LayerNorm: the row lies
//      in one cluster of ceil(K / 256) blocks (3 at K 768); each block's
//      per-row sums of z, of the squared deviations from its own mean, of
//      d(ln) gamma and of d(ln) gamma (z - its mean) are added across the
//      cluster in distributed shared memory in rank order, in one exchange
//      (the variance by Chan et al.'s pairwise update); then 8 columns a
//      thread over the tile's rows write dz (+ the residual's cotangent)
//      and the LayerNorm output, and the tile's d(gamma), d(beta) and
//      d(bias_row) partials (one a tile: a tile lies within a batch), which
//      ln_dx_column_sums_kernel adds in a fixed order. No (M, K) scratch, no
//      float atomic.
// 2. ln_linear_wgrad: dW = dY'^T A and db = colsum(dY') over the M =
//    B x N rows, A the layer's input (the saved activation, or the LayerNorm
//    output from 1); the TPU kernels' per-batch weight-gradient products
//    (fused_mha.py :814-821 qkv and out-projection, fused_mlp.py :194-197
//    and :207-210). Bound at the flagship: dY + A once (qkv 406 + 33 MB,
//    0.13 ms at 3.35 TB/s; 61 GFLOP, 0.06 ms of tensor cores): bytes. The
//    product is dW^T = A^T dY' on wgmma (hopper.cuh) with both operands
//    MN-major in shared memory: a block owns an output tile of KT = 192 A
//    columns (three consumer warpgroups, a 64-column slab each, fp32
//    accumulators in registers) x NT <= 160 dY columns (one head's plane of
//    head_pad for a head-major dY, so that its pad columns meet nothing
//    else) and walks a fixed range of 64-row chunks. A producer warpgroup
//    feeds it: one warp copies each chunk, by TMA where rows are 16-byte
//    aligned (head-major planes through a 3-D map over (column, row,
//    plane), rows past a batch read as zeros; fc1's dY and fc2's hidden
//    layer), else as the contiguous span of the chunk's whole rows (rows of
//    155 bf16, 310 bytes: 64 rows are one span of 19,840 bytes) or, where a
//    tile takes part of each row (the out-projection's o, 1240-byte rows),
//    one bulk copy a row; three warps unpack the copied rows into the
//    panels, 16 bytes a store. Two rings (mbarriers): the copied rows, freed
//    once unpacked, and the panels, freed once multiplied, so that copy,
//    unpack and products of different chunks overlap at ring depths 2-4.
//    dY's keep mask is applied to the chunk's panel in shared memory by the
//    consumers before their products (one Philox per 4 columns), and db is
//    the column sum of the same masked tiles. Each dY element is copied
//    once a call where dY's columns split across tiles (qkv, fc1) and once
//    per 192-column tile of A otherwise (out-projection: 4, fc2: 3; those
//    tiles of a slice run side by side, so that all but the first read it
//    from L2; a 155 x 620 fp32 output does not fit one SM's registers). The
//    rows split into slices fixed by the shape (wgrad_plan, mirrored in
//    ops/ln_linear.py): at most M / (20 K), so that the fp32 partials stay
//    within 10% of dY's bytes; a cluster of up to 8 blocks shares a slice
//    and tile and sums its tiles in distributed shared memory in rank order,
//    and the caller sums the slices in order: the same bits every run, no
//    float atomics.
//
// Bound on the H100 at the flagship shapes: every call moves more bytes
// than its FLOPs need time (100..150 FLOP/byte, under the ~295 ridge of bf16):
// bound by memory bytes, like the forward.
// Not yet: ln_linear_dx on wgmma at K <= 640; the wgmma dX's epilogue
// overlapped with the next tile's products (a persistent block); dY
// multicast to the tiles of A in ln_linear_wgrad; the two halves in one pass.
#include <cooperative_groups.h>
#include <initializer_list>
#include <string.h>

#include "hopper.cuh"

namespace {

// ln_linear_dx: a block's output tile is DX_KT columns wide (all of them
// up to K 160), its reduction walks chunks of DX_BC stored columns, each
// chunk's rows DX_LD apart (80 bytes: ldmatrix rows on distinct banks)
constexpr int DX_KT = 160, DX_BC = 32, DX_LD = DX_BC + 8, DX_GRAN = DX_LD / 8;
constexpr int DX_MAX_SMEM = 232448;  // a block's shared memory on an H100
// the LayerNorm backward keeps its BM x K fp32 d(ln) rows in shared memory
// up to K = MAX_LN_K; wider ones go to device memory (dln_global)
constexpr int MAX_LN_K = 640;

__host__ __device__ constexpr int cdiv(int a, int b) { return (a + b - 1) / b; }

// ln_linear_dx past MAX_LN_K on wgmma (wx::dx_wgmma_kernel): a block owns
// a tile of ROWS rows x TILE output columns, STAGES stages of CHUNK
// reduction columns. A LayerNorm's row lies in one cluster of ceil(K /
// TILE) <= MAX_CLUSTER blocks, which add its sums in distributed shared
// memory (K <= LN_MAX_K; wider ones keep dln_global); the plain form needs
// no cluster.
namespace wx {
constexpr int ROWS = 128, TILE = 256, CHUNK = 64, STAGES = 4;
constexpr int MAX_CLUSTER = 8, LN_MAX_K = MAX_CLUSTER * TILE;
constexpr int A_BYTES = ROWS * CHUNK * 2, STAGE_BYTES = A_BYTES + TILE * CHUNK * 2;
constexpr int HEAD = 8192;  // barriers, the rows' partial sums and their statistics
constexpr int SMEM = 1024 + HEAD + STAGES * STAGE_BYTES;
}  // namespace wx

// Where logical element (row, col) of an (M, N) operand lives: row-major, or
// head-major (N / (heads * head_dim), B, heads, rows_per_batch, head_pad).
struct Layout {
  int N, rows_per_batch, batches, heads, head_dim, head_pad;
};

__device__ __forceinline__ float gelu_grad(float x) {
  return 0.5f * (1.f + erff(x * 0.70710678118654752f)) +
         x * __expf(-0.5f * x * x) * 0.3989422804014327f;
}

// The launch of one ln_linear_dx call (dx_plan; ops/ln_linear.py mirrors it)
struct DxPlan {
  int bm;        // rows a block: 128 (8 warps) or 64 (4 warps)
  int stages;    // depth of the copy ring
  int resident;  // the block's dY' rows stay in shared memory for every output tile
  int k_tiles;   // output tiles of DX_KT columns
  int aligned;   // dY' rows copied straight into the product's tiles (else staged)
  int a_off, s_off, e_off, smem;  // byte offsets of the regions; the total
  int dln_global;  // LayerNorm past wx::LN_MAX_K: the d(ln) rows in (M, K) fp32 scratch
  int wgmma;       // past MAX_LN_K: wx::dx_wgmma_kernel, k_tiles of wx::TILE
  int cluster;     // its blocks a cluster: a LayerNorm's k_tiles, else 1
};

// Shared memory, from 0: the W^T ring [stages][DX_KT][DX_LD]; the dY' tiles
// (resident: [bm][NS + 8], all chunks; else a ring of [bm][DX_LD], `stages`
// deep when copied straight in, 2 when unpacked from staging); staging
// [stages][bm][DX_LD] for rows that are not 16-byte aligned; the fp32
// products: plain, one output tile [bm][DX_KT + 4] after the ring;
// LayerNorm, the d(ln) rows [bm][K + 4] and 4 statistics a row, over the
// ring once it is free when K fits one output tile (else after it); past
// MAX_LN_K only the statistics, after the ring (the rows go to scratch in
// device memory).
// Resident is chosen over the rest, 128 rows over 64; then the deepest
// ring of 4, 3, 2 that leaves room for two blocks a SM, else the deepest
// that fits; smem 0 when no launch fits. Past MAX_LN_K every K goes to
// wx::dx_wgmma_kernel, but a LayerNorm past wx::LN_MAX_K (more than a
// cluster's 8 x 256 columns; no configuration reaches it), which keeps
// its d(ln) rows in device memory.
DxPlan dx_plan(int K, int NS, bool aligned, bool ln) {
  DxPlan p{};
  p.aligned = aligned;
  if (K > MAX_LN_K && !(ln && K > wx::LN_MAX_K)) {
    p.wgmma = 1;
    p.bm = wx::ROWS;
    p.stages = wx::STAGES;
    p.k_tiles = cdiv(K, wx::TILE);
    p.cluster = ln ? p.k_tiles : 1;
    p.smem = wx::SMEM;
    return p;
  }
  p.cluster = 1;
  p.k_tiles = (K + DX_KT - 1) / DX_KT;
  p.dln_global = ln && K > MAX_LN_K;
  for (int resident = p.k_tiles > 1; resident >= 0; --resident)
    for (int bm = 128; bm >= 64; bm /= 2)
      for (int limit : {DX_MAX_SMEM / 2 - 1024, DX_MAX_SMEM})
        for (int st = 4; st >= 2; --st) {
          const int w = st * DX_KT * DX_LD * 2;
          const int a = resident ? bm * (NS + 8) * 2 : (aligned ? st : 2) * bm * DX_LD * 2;
          const int ring = w + a + (aligned ? 0 : st * bm * DX_LD * 2);
          const int e = p.dln_global ? bm * 16
                        : ln ? bm * (p.k_tiles * DX_KT + 4) * 4 + bm * 16
                             : bm * (DX_KT + 4) * 4;
          const int e_off = ln && p.k_tiles == 1 && e <= ring ? 0 : ring;
          const int smem = e_off + e > ring ? e_off + e : ring;
          if (smem > limit) continue;
          p.bm = bm;
          p.stages = st;
          p.resident = resident;
          p.a_off = w;
          p.s_off = w + a;
          p.e_off = e_off;
          p.smem = smem;
          return p;
        }
  return p;
}

__device__ __forceinline__ void cp_async_wait_ring(int stages) {
  if (stages == 4) cp_async_wait<2>();
  else if (stages == 3) cp_async_wait<1>();
  else cp_async_wait<0>();
}

// dX = dY' W (W^T given as wt) for the block's BM rows. dy is 16-byte
// aligned with dy_shift = 0 when P.aligned; else it is dY's start rounded
// down to 16 bytes and dY's element e lies at dy[dy_shift + e].
// (two blocks a SM where the d(ln) rows share shared memory with the ring;
// past MAX_LN_K one, so that the 8-warp block keeps its registers unspilled)
template <int WM, bool LN, bool DLN_GLOBAL = false>
__global__ void __launch_bounds__(64 * WM, LN && !DLN_GLOBAL ? 2 : 1) ln_linear_dx_kernel(
    const bf16* __restrict__ dy, Layout L, int dy_shift, Drop drop_in,
    const bf16* __restrict__ wt, bf16* __restrict__ dx, int M, int K, int NS, DxPlan P,
    // plain epilogue: fc1's pre-GELU activation and keep mask
    const bf16* __restrict__ pre, Drop drop_out,
    // LayerNorm epilogue
    const bf16* __restrict__ x, const bf16* __restrict__ pro_row,
    const float* __restrict__ gamma, const float* __restrict__ beta,
    const bf16* __restrict__ dres, bf16* __restrict__ ln_out, float* __restrict__ col_part,
    int brow, float* __restrict__ dln) {
  constexpr int BM = 32 * WM, T = 64 * WM, NW = T / 32;
  constexpr int DY_COPIES = BM * (DX_BC / 8) / T;  // aligned dY granules a thread, a chunk
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Ws = reinterpret_cast<bf16*>(smem_raw);             // W^T chunks
  bf16* As = reinterpret_cast<bf16*>(smem_raw + P.a_off);   // dY' tiles
  bf16* Ss = reinterpret_cast<bf16*>(smem_raw + P.s_off);   // staged dY rows
  float* Es = reinterpret_cast<float*>(smem_raw + P.e_off); // fp32 products
  const int ELD = (LN ? P.k_tiles * DX_KT : DX_KT) + 4;
  const int ST = P.stages, NC = NS / DX_BC, steps = P.k_tiles * NC, N = L.N;
  const int a_ld = P.resident ? NS + 8 : DX_LD;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int warp_m = warp >> 1, warp_n = warp & 1;  // 32 rows x 80 columns a warp
  const int m0 = blockIdx.x * BM, rows = min(BM, M - m0);

  // where chunk c of step s lies for the products
  auto a_tile = [&](int c, int s) -> bf16* {
    if (P.resident) return As + c * DX_BC;
    return As + (s % (P.aligned ? ST : 2)) * BM * DX_LD;
  };

  // the element offset of each aligned dY row this thread copies, chunk 0
  // (head-major: within the (s, h) plane; -1 past M)
  long long row_off[DY_COPIES];
#pragma unroll
  for (int j = 0; j < DY_COPIES; ++j) {
    const int r = (tid + j * T) >> 2, row = m0 + r;
    row_off[j] = -1;
    if (row < M && L.heads) {
      const int b = row / L.rows_per_batch, n = row - b * L.rows_per_batch;
      row_off[j] = ((long long)b * L.heads * L.rows_per_batch + n) * L.head_pad;
    } else if (row < M) {
      row_off[j] = (long long)row * N;
    }
  }
  const long long plane = (long long)L.batches * L.heads * L.rows_per_batch * L.head_pad;

  // chunk c of the block's dY rows, 16-byte cp.async: head-major, each
  // (s, h) plane's rows of head_pad as they lie (chunks never straddle
  // planes); row-major with aligned rows the same; otherwise every row's
  // segment through the (at most DX_GRAN) aligned granules that hold it,
  // into staging. Zero-filled outside the operand.
  auto load_dy = [&](int c, int s) {
    if (P.aligned) {
      bf16* dst = a_tile(c, s);
      long long chunk = c * DX_BC;  // head-major: (s, h)'s plane and d0
      int d0 = c * DX_BC;
      if (L.heads) {
        const int p = d0 / L.head_pad, sb = p / L.heads;
        d0 -= p * L.head_pad;
        chunk = sb * plane + (long long)(p - sb * L.heads) * L.rows_per_batch * L.head_pad + d0;
      }
#pragma unroll
      for (int j = 0; j < DY_COPIES; ++j) {
        const int i = tid + j * T, r = i >> 2, q = (i & 3) * 8;
        const bool valid = row_off[j] >= 0 && (L.heads || d0 + q < N);
        cp_async16(dst + r * a_ld + q, dy + (valid ? row_off[j] + chunk + q : 0), valid);
      }
    } else {
      bf16* dst = Ss + (s % ST) * BM * DX_LD;
      const int nvalid = min(N - c * DX_BC, DX_BC);
      for (int i = tid; i < BM * DX_GRAN; i += T) {
        const int r = i / DX_GRAN, q = i - r * DX_GRAN;
        const long long e0 = (long long)(m0 + r) * N + c * DX_BC + dy_shift;
        const long long gran = (e0 >> 3) + q;
        const bool valid = r < rows && 8 * gran < e0 + nvalid;
        cp_async16(dst + r * DX_LD + 8 * q, dy + (valid ? 8 * gran : 0), valid);
      }
    }
  };
  auto load_w = [&](int s) {
    const int kt = s / NC, c = s - kt * NC;
    bf16* dst = Ws + (s % ST) * DX_KT * DX_LD;
    const bf16* src = wt + (size_t)kt * DX_KT * NS + c * DX_BC;
    for (int i = tid; i < DX_KT * (DX_BC / 8); i += T) {
      const int r = i >> 2, q = (i & 3) * 8;
      const bool valid = kt * DX_KT + r < K;
      cp_async16(dst + r * DX_LD + q, valid ? src + (size_t)r * NS + q : wt, valid);
    }
  };
  // one commit group a step: its W^T chunk and, the first time the chunk
  // is needed, its dY' chunk
  auto prefetch = [&](int s) {
    if (s < steps) {
      load_w(s);
      if (!P.resident || s < NC) load_dy(s % NC, s);
    }
    cp_async_commit();
  };

  // dY' of chunk c, once: unpacked from staging (or in place), the keep
  // mask applied and scaled (one Philox per 4 logical columns of a row),
  // zero outside the M x N operand and past each head's D. A head-major
  // group of 4 stored columns may span two logical groups when D % 4 != 0,
  // and then draws both (no caller masks a head-major dY).
  auto finish = [&](int c, int s) {
    bf16* dst = a_tile(c, s);
    const bf16* src = P.aligned ? dst : Ss + (s % ST) * BM * DX_LD;
    const int src_ld = P.aligned ? a_ld : DX_LD;
    int lc0 = c * DX_BC, nv = N - c * DX_BC;  // logical column of the chunk's first; valid ones
    if (L.heads) {
      const int p = lc0 / L.head_pad, d0 = lc0 - p * L.head_pad;
      lc0 = p * L.head_dim + d0;
      nv = L.head_dim - d0;
    }
#pragma unroll 4
    for (int i = tid; i < BM * (DX_BC / 4); i += T) {
      const int r = i >> 3, j = (i & 7) * 4, row = m0 + r;
      const int sh = P.aligned ? 0 : (int)(((long long)row * N + c * DX_BC + dy_shift) & 7);
      const bf16* sp = src + r * src_ld + sh + j;
      float v[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) v[e] = r < rows && j + e < nv ? to_f(sp[e]) : 0.f;
      if (drop_in.on() && r < rows) {
        const int lc = lc0 + j;
        const uint4 w0 = keep_words(drop_in, 0u, (uint32_t)row, (uint32_t)lc >> 2);
        const uint4 w1 = (lc & 3) ? keep_words(drop_in, 0u, (uint32_t)row, ((uint32_t)lc >> 2) + 1u) : w0;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int at = (lc + e) & 3;
          const uint32_t word = ((lc + e) >> 2) == (lc >> 2) ? word_of(w0, at) : word_of(w1, at);
          v[e] = word < drop_in.threshold ? v[e] * drop_in.scale : 0.f;
        }
      }
      *reinterpret_cast<uint2*>(dst + r * a_ld + j) =
          make_uint2(pack_bf16(v[0], v[1]), pack_bf16(v[2], v[3]));
    }
  };

  // acc += the chunk's dY' (BM x 32) times its W^T chunk (32 x DX_KT),
  // mma.sync m16n8k16 on ldmatrix fragments
  float acc[2][10][4];
  auto products = [&](const bf16* at, const bf16* wtile) {
#pragma unroll
    for (int kk = 0; kk < DX_BC; kk += 16) {
      uint32_t a[2][4], b[5][4];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
        ldmatrix_x4(a[mi], at + (warp_m * 32 + mi * 16 + (lane & 15)) * a_ld + kk + (lane >> 4) * 8);
#pragma unroll
      for (int nj = 0; nj < 5; ++nj)
        ldmatrix_x4(b[nj], wtile + (warp_n * 80 + nj * 16 + (lane & 7) + ((lane >> 4) << 3)) * DX_LD +
                               kk + ((lane >> 3) & 1) * 8);
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int nj = 0; nj < 5; ++nj) {
          const uint32_t b0[2] = {b[nj][0], b[nj][1]}, b1[2] = {b[nj][2], b[nj][3]};
          mma_16816(acc[mi][2 * nj], a[mi], b0);
          mma_16816(acc[mi][2 * nj + 1], a[mi], b1);
        }
    }
  };
  // a tile's fp32 products into Es (LayerNorm: into the d(ln) rows; past
  // MAX_LN_K into the scratch rows of device memory)
  auto keep_tile = [&](int kt) {
    if constexpr (DLN_GLOBAL) {
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int ni = 0; ni < 10; ++ni)
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const int r = warp_m * 32 + mi * 16 + g + half * 8;
            const int col = kt * DX_KT + warp_n * 80 + ni * 8 + 2 * t;
            if (r >= rows) continue;
            float* dst = dln + (size_t)(m0 + r) * K + col;
            if (col < K) dst[0] = acc[mi][ni][2 * half];
            if (col + 1 < K) dst[1] = acc[mi][ni][2 * half + 1];
          }
      return;
    }
    float* et = Es + (LN ? kt * DX_KT : 0);
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int ni = 0; ni < 10; ++ni)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int r = warp_m * 32 + mi * 16 + g + half * 8;
          *reinterpret_cast<float2*>(et + r * ELD + warp_n * 80 + ni * 8 + 2 * t) =
              make_float2(acc[mi][ni][2 * half], acc[mi][ni][2 * half + 1]);
        }
  };

  const bool finish_needed = !P.aligned || drop_in.on();
  for (int s = 0; s < ST - 1; ++s) prefetch(s);
  for (int s = 0; s < steps; ++s) {
    const int kt = s / NC, c = s - kt * NC;
    cp_async_wait_ring(ST);
    __syncthreads();  // step s's copies have landed; every warp is done with step s - 1
    prefetch(s + ST - 1);
    if (finish_needed && (!P.resident || kt == 0)) {
      finish(c, s);
      __syncthreads();
    }
    if (c == 0) {
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int ni = 0; ni < 10; ++ni)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0.f;
    }
    products(a_tile(c, s), Ws + (s % ST) * DX_KT * DX_LD);
    if (c != NC - 1) continue;
    if (LN) {  // the last tile waits for the ring to be free (it may share it)
      if (DLN_GLOBAL || kt + 1 < P.k_tiles) keep_tile(kt);
      continue;
    }

    // plain epilogue: 4 columns a thread (one Philox group of fc1's mask),
    // rows written whole by consecutive threads
    keep_tile(kt);
    __syncthreads();
    const int k0 = kt * DX_KT;
#pragma unroll 4
    for (int i = tid; i < BM * (DX_KT / 4); i += T) {
      const int r = i / (DX_KT / 4), j = (i - r * (DX_KT / 4)) * 4, col = k0 + j;
      if (r >= rows || col >= K) continue;
      const float4 a4 = *reinterpret_cast<const float4*>(Es + r * ELD + j);
      float v[4] = {a4.x, a4.y, a4.z, a4.w};
      const size_t at = (size_t)(m0 + r) * K + col;
      const bool vec = (K & 3) == 0;  // 8-byte aligned groups of 4
      if (pre != nullptr) {
        float p[4];
        if (vec) {
          const uint2 bits = *reinterpret_cast<const uint2*>(pre + at);
          p[0] = __uint_as_float(bits.x << 16);
          p[1] = __uint_as_float(bits.x & 0xffff0000u);
          p[2] = __uint_as_float(bits.y << 16);
          p[3] = __uint_as_float(bits.y & 0xffff0000u);
        } else {
#pragma unroll
          for (int e = 0; e < 4; ++e) p[e] = col + e < K ? to_f(pre[at + e]) : 0.f;
        }
        uint4 w = make_uint4(0u, 0u, 0u, 0u);
        if (drop_out.on()) w = keep_words(drop_out, 0u, (uint32_t)(m0 + r), (uint32_t)col >> 2);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if (drop_out.on())
            v[e] = word_of(w, e) < drop_out.threshold ? v[e] * drop_out.scale : 0.f;
          v[e] *= gelu_grad(p[e]);
        }
      }
      if (vec) {
        *reinterpret_cast<uint2*>(dx + at) = make_uint2(pack_bf16(v[0], v[1]), pack_bf16(v[2], v[3]));
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (col + e < K) dx[at + e] = __float2bfloat16_rn(v[e]);
      }
    }
  }
  if (!LN) return;

  cp_async_wait<0>();
  __syncthreads();  // the ring is free
  if (!DLN_GLOBAL) keep_tile(P.k_tiles - 1);
  __syncthreads();  // every d(ln) row is in shared memory (or the block's scratch rows)
  // the d(ln) rows: row r's element k at E[r * eld + k]
  const float* E = DLN_GLOBAL ? dln + (size_t)m0 * K : Es;
  const int eld = DLN_GLOBAL ? K : ELD;

  // LayerNorm backward. 1) each row's statistics, one warp per row, 4 rows
  // at a time (independent shuffle chains); the per-lane sums run in the
  // order of ln_linear.cu's registers
  constexpr int LN_ROWS = 4;
  float* stats = Es + (DLN_GLOBAL ? 0 : BM * ELD);  // [BM][4]: mean, rstd, mean(dxh), mean(dxh xhat)
  auto z_at = [&](const bf16* xr, const bf16* br, int k) {
    float z = to_f(xr[k]);
    if (br != nullptr) z = round_bf16(z + to_f(br[k]));
    return z;
  };
  for (int r0 = warp; r0 < rows; r0 += LN_ROWS * NW) {
    const bf16* xr[LN_ROWS];
    const bf16* br[LN_ROWS];
    float s0[LN_ROWS], mean[LN_ROWS], var[LN_ROWS], rstd[LN_ROWS], s1[LN_ROWS], s2[LN_ROWS];
#pragma unroll
    for (int u = 0; u < LN_ROWS; ++u) {
      const int row = m0 + min(r0 + u * NW, rows - 1);  // a row past the block repeats its last
      xr[u] = x + (size_t)row * K;
      br[u] = pro_row ? pro_row + (size_t)(row / L.rows_per_batch) * K : nullptr;
      s0[u] = var[u] = s1[u] = s2[u] = 0.f;
    }
    for (int k = lane; k < K; k += 32)
#pragma unroll
      for (int u = 0; u < LN_ROWS; ++u) s0[u] += z_at(xr[u], br[u], k);
#pragma unroll
    for (int u = 0; u < LN_ROWS; ++u) mean[u] = warp_sum(s0[u]) / K;
    for (int k = lane; k < K; k += 32)
#pragma unroll
      for (int u = 0; u < LN_ROWS; ++u) {
        const float d = z_at(xr[u], br[u], k) - mean[u];
        var[u] += d * d;
      }
#pragma unroll
    for (int u = 0; u < LN_ROWS; ++u) rstd[u] = rsqrtf(warp_sum(var[u]) / K + 1e-5f);
    for (int k = lane; k < K; k += 32)
#pragma unroll
      for (int u = 0; u < LN_ROWS; ++u) {
        const int r = min(r0 + u * NW, rows - 1);
        const float dxh = E[r * eld + k] * gamma[k];
        s1[u] += dxh;
        s2[u] += dxh * ((z_at(xr[u], br[u], k) - mean[u]) * rstd[u]);
      }
#pragma unroll
    for (int u = 0; u < LN_ROWS; ++u) {
      s1[u] = warp_sum(s1[u]) / K;
      s2[u] = warp_sum(s2[u]) / K;
      const int r = r0 + u * NW;
      if (lane == 0 && r < rows) {
        stats[r * 4 + 0] = mean[u];
        stats[r * 4 + 1] = rstd[u];
        stats[r * 4 + 2] = s1[u];
        stats[r * 4 + 3] = s2[u];
      }
    }
  }
  __syncthreads();  // every row's statistics
  // 2) dz, the LayerNorm output and the column sums, one column a thread
  // over the block's rows; the block's d(gamma) and d(beta) sums go to rows
  // blockIdx.x of col_part's first two [blocks][K] arrays and its d(bias_row)
  // sum over the rows of batch b to row blockIdx.x + b of the third (the
  // pairs (block, batch) in order, one row each), which
  // ln_dx_column_sums_kernel adds in a fixed order
  float* gpart = col_part + (size_t)blockIdx.x * K;
  float* bpart = gpart + (size_t)gridDim.x * K;
  float* rpart = col_part + 2 * (size_t)gridDim.x * K;
  for (int k = tid; k < K; k += T) {
    const float gk = gamma[k], bk = beta[k];
    float dg = 0.f, db = 0.f;
    for (int r0 = 0; r0 < rows;) {  // the rows of one batch at a time
      const int b = (m0 + r0) / L.rows_per_batch;
      const int r1 = min(rows, (b + 1) * L.rows_per_batch - m0);
      const bf16* br = pro_row ? pro_row + (size_t)b * K : nullptr;
      float dr = 0.f;
#pragma unroll 8
      for (int r = r0; r < r1; ++r) {
        const size_t at = (size_t)(m0 + r) * K + k;
        const float xhat = (z_at(x + at - k, br, k) - stats[r * 4 + 0]) * stats[r * 4 + 1];
        const float dl = E[r * eld + k];
        dg += dl * xhat;
        db += dl;
        if (ln_out != nullptr) ln_out[at] = __float2bfloat16_rn(xhat * gk + bk);
        float dz = stats[r * 4 + 1] * (dl * gk - stats[r * 4 + 2] - xhat * stats[r * 4 + 3]);
        if (dres != nullptr) dz += to_f(dres[at]);
        dr += dz;
        dx[at] = __float2bfloat16_rn(dz);
      }
      if (brow) rpart[((size_t)blockIdx.x + b) * K + k] = dr;
      r0 = r1;
    }
    gpart[k] = dg;
    bpart[k] = db;
  }
}

// d(gamma), d(beta) and the per-batch d(bias_row) from ln_linear_dx_kernel's
// partials (col_part: [blocks][K], [blocks][K], then with brow [blocks +
// batches - 1][K]), in an order fixed by the shape: blockIdx.y 0 and 1 sum
// d(gamma) and d(beta) over the blocks, 2 + b d(bias_row) of batch b over
// the blocks that hold its rows; a block takes 32 columns, warp w the
// partials w, w + SUM_WARPS, ... in turn, and its first warp adds the warps'
// sums in warp order. wx::dx_wgmma_kernel's row tiles lie within a batch,
// tiles_pb of them a batch (0: ln_linear_dx_kernel's blocks of bm rows):
// its d(bias_row) partials are [blocks][K], one a tile.
constexpr int SUM_WARPS = 32;

__global__ void __launch_bounds__(SUM_WARPS * 32) ln_dx_column_sums_kernel(
    const float* __restrict__ col_part, float* __restrict__ dgamma, float* __restrict__ dbeta,
    float* __restrict__ dbrow, int K, int blocks, int bm, int rows_per_batch, int tiles_pb) {
  __shared__ float sums[SUM_WARPS][33];
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5, k = blockIdx.x * 32 + lane;
  const float* part;
  float* out;
  int n;
  if (blockIdx.y < 2) {
    part = col_part + (size_t)blockIdx.y * blocks * K;
    out = blockIdx.y ? dbeta : dgamma;
    n = blocks;
  } else if (tiles_pb) {
    const long long b = blockIdx.y - 2;
    part = col_part + (2 * (size_t)blocks + b * tiles_pb) * K;
    out = dbrow + b * K;
    n = tiles_pb;
  } else {
    const long long b = blockIdx.y - 2;
    const int first = (int)(b * rows_per_batch / bm);
    const int last = (int)(((b + 1) * rows_per_batch - 1) / bm);
    part = col_part + (2 * (size_t)blocks + first + b) * K;
    out = dbrow + b * K;
    n = last - first + 1;
  }
  float sum = 0.f;
  if (k < K)
    for (int i = w; i < n; i += SUM_WARPS) sum += part[(size_t)i * K + k];
  sums[w][lane] = sum;
  __syncthreads();
  if (w == 0 && k < K) {
    float total = 0.f;
#pragma unroll 8
    for (int j = 0; j < SUM_WARPS; ++j) total += sums[j][lane];
    out[k] = total;
  }
}

template <int WM, bool LN, bool DLN_GLOBAL = false>
int launch_dx(const DxPlan& P, cudaStream_t stream, const bf16* dy, Layout L, int dy_shift,
              Drop din, const bf16* wt, bf16* dx, int M, int K, int NS, const bf16* pre,
              Drop dout, const bf16* x, const bf16* pro_row, const float* gamma,
              const float* beta, const bf16* dres, bf16* ln_out, float* dgamma, float* dbeta,
              float* dbrow, float* col_part, float* dln) {
  cudaError_t err = cudaFuncSetAttribute(ln_linear_dx_kernel<WM, LN, DLN_GLOBAL>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, P.smem);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (M + 32 * WM - 1) / (32 * WM);
  ln_linear_dx_kernel<WM, LN, DLN_GLOBAL><<<(unsigned)blocks, 64 * WM, P.smem, stream>>>(
      dy, L, dy_shift, din, wt, dx, M, K, NS, P, pre, dout, x, pro_row, gamma, beta, dres,
      ln_out, col_part, dbrow != nullptr, dln);
  if ((err = cudaGetLastError()) != cudaSuccess || !LN) return (int)err;
  const int rows = dbrow != nullptr ? L.batches : 0;
  ln_dx_column_sums_kernel<<<dim3((unsigned)((K + 31) / 32), 2 + rows), SUM_WARPS * 32, 0,
                             stream>>>(col_part, dgamma, dbeta, dbrow, K, blocks, 32 * WM,
                                       L.rows_per_batch, 0);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// ln_linear_dx past MAX_LN_K on wgmma

namespace wx {

constexpr int THREADS = 384;                      // two consumer warpgroups, a producer warpgroup
constexpr int PRODUCER_REGS = 40, CONSUMER_REGS = 232;

struct Args {
  int K, NS;                    // dX (., K) over NS stored reduction columns
  int rows, batches, tiles_pb;  // the row space: batches x rows, tiles_pb tiles a batch
  int heads, head_pad;          // head-major dY: (NS / (heads head_pad), batches, heads, rows, head_pad)
  int ctiles;                   // output tiles of a row tile
  int vec;                      // K % 8 == 0 and every (M, K) operand 16-byte aligned
};

constexpr int ELD = TILE + 8;  // row stride of the staged fp32 tile: float2 stores on distinct banks

// columns k .. k + W - 1 of a row (element `at` is column k) written in
// bf16, those from K on left alone; vec: one 8- or 16-byte store
template <int W>
__device__ __forceinline__ void store_cols(bf16* p, size_t at, int k, int K, bool vec,
                                           const float (&v)[W]) {
  if (vec) {
    uint32_t w[W / 2];
#pragma unroll
    for (int i = 0; i < W / 2; ++i) w[i] = pack_bf16(v[2 * i], v[2 * i + 1]);
    if constexpr (W == 8)
      *reinterpret_cast<uint4*>(p + at) = make_uint4(w[0], w[1], w[2], w[3]);
    else
      *reinterpret_cast<uint2*>(p + at) = make_uint2(w[0], w[1]);
  } else {
#pragma unroll
    for (int e = 0; e < W; ++e)
      if (k + e < K) p[at + e] = __float2bfloat16_rn(v[e]);
  }
}

// the same columns read in float, zeros from K on
template <int W>
__device__ __forceinline__ void load_cols(const bf16* p, size_t at, int k, int K, bool vec,
                                          float (&v)[W]) {
  if (vec && k < K) {
    uint32_t w[W / 2];
    if constexpr (W == 8) {
      const uint4 u = *reinterpret_cast<const uint4*>(p + at);
      w[0] = u.x, w[1] = u.y, w[2] = u.z, w[3] = u.w;
    } else {
      const uint2 u = *reinterpret_cast<const uint2*>(p + at);
      w[0] = u.x, w[1] = u.y;
    }
#pragma unroll
    for (int i = 0; i < W / 2; ++i) {
      v[2 * i] = __uint_as_float(w[i] << 16);
      v[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  } else {
#pragma unroll
    for (int e = 0; e < W; ++e) v[e] = k + e < K ? to_f(p[at + e]) : 0.f;
  }
}

// dX = dY' W for a tile of ROWS rows and TILE output columns a block. dymap
// reads dY' (row-major (batches, rows, NS), or head-major) in boxes of
// [ROWS][CHUNK], wmap W^T (K, NS) in boxes of [TILE][CHUNK], both in
// 128-byte swizzled rows. Block c of a row tile owns output columns k0 = c
// TILE ..; a LayerNorm's row tile is one cluster (ctiles blocks, rank c).
// Each block copies its stages itself: a row tile's blocks run side by side
// (one cluster, or consecutive block indices), so that all but the first
// find each dY' chunk in L2.
template <bool LN>
__global__ void __launch_bounds__(THREADS, 1) dx_wgmma_kernel(
    const __grid_constant__ CUtensorMap dymap, const __grid_constant__ CUtensorMap wmap, Args g,
    bf16* __restrict__ dx, const bf16* __restrict__ pre, Drop drop_out,
    const bf16* __restrict__ x, const bf16* __restrict__ pro_row,
    const float* __restrict__ gamma, const float* __restrict__ beta,
    const bf16* __restrict__ dres, bf16* __restrict__ ln_out, float* __restrict__ col_part,
    int brow) {
  using namespace hopper;
  namespace cg = cooperative_groups;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = smem_raw + ((1024u - (smem_u32(smem_raw) & 1023u)) & 1023u);
  uint64_t* full = reinterpret_cast<uint64_t*>(base);  // [STAGES] a stage's boxes landed
  uint64_t* empty = full + STAGES;                     // [STAGES] its products are done
  float* part = reinterpret_cast<float*>(base + 1024);  // [4][ROWS] the rows' partial sums
  float4* stats = reinterpret_cast<float4*>(base + 3072);  // [ROWS]: mean, rstd, mean(dxh), mean(dxh xhat)
  unsigned char* ring = base + HEAD;
  const int tid = threadIdx.x, wgi = tid / 128;
  const int tile = blockIdx.x / g.ctiles, k0 = (blockIdx.x - tile * g.ctiles) * TILE;
  const int b = tile / g.tiles_pb, n0 = (tile - b * g.tiles_pb) * ROWS;
  // chunks of the reduction: head-major, cpp a (s, h) plane of head_pad
  const int cpp = g.heads ? cdiv(g.head_pad, CHUNK) : 0;
  const int NC = g.heads ? g.NS / g.head_pad * cpp : cdiv(g.NS, CHUNK);

  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      bar_init(&full[s], 1);
      bar_init(&empty[s], 2);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wgi == 2) {
    // the producer: one thread keeps the ring full; first its warp asks L2
    // for the tile's rows of fc1's pre-GELU activation, so that they are
    // there when the products are done (the LayerNorm's x and dres were
    // slower so: they evict what the products stream)
    regs_dec<PRODUCER_REGS>();
    if (!LN && pre != nullptr && tid < 288 && g.vec && k0 < g.K) {
      const uint32_t bytes = (uint32_t)min(TILE, g.K - k0) * 2;
      for (int r = tid - 256; r < min(ROWS, g.rows - n0); r += 32)
        prefetch_l2(pre + ((size_t)b * g.rows + n0 + r) * g.K + k0, bytes);
    }
    if (tid == 256) {
      for (int it = 0; it < NC; ++it) {
        const int s = it % STAGES;
        if (it >= STAGES) bar_wait_or_trap(&empty[s], (uint32_t)((it / STAGES - 1) & 1));
        unsigned char* st = ring + s * STAGE_BYTES;
        bar_expect(&full[s], STAGE_BYTES);
        // chunk it: columns col .. col + 63 of dY's plane `plane` (head-major:
        // plane (s, h)'s chunk j, zeros past head_pad), W^T's columns wcol ..
        int col = it * CHUNK, plane = b, wcol = col;
        if (g.heads) {
          const int p = it / cpp, hs = p / g.heads;
          col = (it - p * cpp) * CHUNK;
          wcol = p * g.head_pad + col;
          plane = (hs * g.batches + b) * g.heads + (p - hs * g.heads);
        }
        tma_box(st, &dymap, col, n0, plane, &full[s]);
        tma_box(st + A_BYTES, &wmap, wcol, k0, 0, &full[s]);
      }
    }
    __syncwarp();
    if (LN)
      for (int i = 0; i < 2; ++i) cg::this_cluster().sync();  // the consumers' exchange, exit
    return;
  }

  // consumers: warpgroup wgi owns the tile's rows 64 wgi .. 64 wgi + 63
  regs_inc<CONSUMER_REGS>();
  float acc[TILE / 2];
#pragma unroll
  for (int i = 0; i < TILE / 2; ++i) acc[i] = 0.f;
  fence_regs(acc);
  for (int it = 0; it < NC; ++it) {
    const int s = it % STAGES;
    bar_wait_or_trap(&full[s], (uint32_t)((it / STAGES) & 1));
    const uint32_t a_s = smem_u32(ring + s * STAGE_BYTES), b_s = a_s + A_BYTES;
    mma_fence();
#pragma unroll
    for (int kk = 0; kk < CHUNK / 16; ++kk)
      wgmma::Mma<TILE>::template ss<0, 0>(acc, desc_k128(a_s, 64 * wgi, kk),
                                          desc_k128(b_s, 0, kk), 1);
    mma_commit();
    mma_wait<1>();  // the previous stage's products are done: free it
    if (it > 0 && (tid & 127) == 0) bar_arrive(&empty[(it - 1) % STAGES]);
  }
  mma_wait<0>();
  fence_regs(acc);

  // the tile in fp32 over the freed ring, [ROWS][ELD], so that the
  // epilogues below walk it in rolled loops with coalesced accesses
  named_sync(1, 256);  // both warpgroups are done with the ring
  float* Es = reinterpret_cast<float*>(ring);
  {
    const int w = (tid >> 5) & 3, lane = tid & 31;
    float* er = Es + (64 * wgi + 16 * w + (lane >> 2)) * ELD + 2 * (lane & 3);
#pragma unroll
    for (int j = 0; j < TILE / 8; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        *reinterpret_cast<float2*>(er + 8 * h * ELD + 8 * j) =
            make_float2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
  }
  named_sync(1, 256);
  const int K = g.K, nr = min(ROWS, g.rows - n0);  // the tile's rows
  const bool vec = g.vec != 0;
  const size_t m0 = (size_t)b * g.rows + n0;       // its first row of dX

  if constexpr (!LN) {
    // plain epilogue: 4 columns an item (one Philox group of fc1's mask),
    // rows written whole by consecutive threads; the loads of BATCH items
    // issued before any of their arithmetic
    constexpr int ITEMS = ROWS * (TILE / 4) / 256, BATCH = 8;
#pragma unroll 1
    for (int u0 = 0; u0 < ITEMS; u0 += BATCH) {
      float v[BATCH][4], p[BATCH][4];
#pragma unroll
      for (int u = 0; u < BATCH; ++u) {
        const int i = tid + 256 * (u0 + u), r = i / (TILE / 4), c = (i - r * (TILE / 4)) * 4;
        const float4 a4 = *reinterpret_cast<const float4*>(Es + r * ELD + c);
        v[u][0] = a4.x, v[u][1] = a4.y, v[u][2] = a4.z, v[u][3] = a4.w;
        if (pre != nullptr && r < nr && k0 + c < K)
          load_cols<4>(pre, (m0 + r) * K + k0 + c, k0 + c, K, vec, p[u]);
      }
#pragma unroll
      for (int u = 0; u < BATCH; ++u) {
        const int i = tid + 256 * (u0 + u), r = i / (TILE / 4), k = k0 + (i - r * (TILE / 4)) * 4;
        if (r >= nr || k >= K) continue;
        const size_t at = (m0 + r) * K + k;
        if (pre != nullptr) {
          uint4 kw = make_uint4(0u, 0u, 0u, 0u);
          if (drop_out.on()) kw = keep_words(drop_out, 0u, (uint32_t)(m0 + r), (uint32_t)k >> 2);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            if (drop_out.on())
              v[u][e] = word_of(kw, e) < drop_out.threshold ? v[u][e] * drop_out.scale : 0.f;
            v[u][e] *= gelu_grad(p[u][e]);
          }
        }
        store_cols<4>(dx, at, k, K, vec, v[u]);
      }
    }
    return;
  } else {
    // LayerNorm epilogue. 1) the rows' statistics: warp wi takes rows RW wi
    // .. RW wi + RW - 1, lane l the block's columns 8 l .. 8 l + 7. Each
    // block sums, for each row over its columns, z, the squared deviations
    // from its own mean mb, d(ln) gamma and d(ln) gamma (z - mb) (the lane's
    // columns, then the warp: warp_sum), and the cluster adds the blocks'
    // sums in rank order in distributed shared memory, exactly as one pass
    // over the row (Chan et al.'s pairwise update for the variance; the
    // deviations re-centred on the row's mean): one exchange, the same
    // bits in every block and every run.
    cg::cluster_group cluster = cg::this_cluster();
    const int C = (int)cluster.num_blocks();
    constexpr int RW = ROWS / 8;
    const int wi = tid >> 5, lane = tid & 31, kl = k0 + 8 * lane;
    const int nk = min(TILE, K - k0);  // the block's columns
    const bf16* br = pro_row != nullptr ? pro_row + (size_t)b * K : nullptr;
    float rb[8], gm[8];
    if (br != nullptr) load_cols<8>(br, kl, kl, K, vec, rb);
#pragma unroll
    for (int e = 0; e < 8; ++e) gm[e] = kl + e < K ? gamma[kl + e] : 0.f;
#pragma unroll 4
    for (int u = 0; u < RW; ++u) {
      const int r = RW * wi + u;
      float z[8];
      if (r < nr && kl < K) {
        load_cols<8>(x, (m0 + r) * K + kl, kl, K, vec, z);
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e) z[e] = 0.f;
      }
      if (br != nullptr)
#pragma unroll
        for (int e = 0; e < 8; ++e) z[e] = kl + e < K ? round_bf16(z[e] + rb[e]) : 0.f;
      const float* er = Es + r * ELD + 8 * lane;
      const float4 d0 = *reinterpret_cast<const float4*>(er);
      const float4 d1 = *reinterpret_cast<const float4*>(er + 4);
      const float dl[8] = {d0.x, d0.y, d0.z, d0.w, d1.x, d1.y, d1.z, d1.w};
      float sz = 0.f;
#pragma unroll
      for (int e = 0; e < 8; ++e) sz += z[e];
      sz = warp_sum(sz);
      const float mb = sz / nk;
      float d2 = 0.f, a = 0.f, c = 0.f;
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const float d = kl + e < K ? z[e] - mb : 0.f, dxh = dl[e] * gm[e];
        d2 += d * d;
        a += dxh;
        c += dxh * d;
      }
      d2 = warp_sum(d2);
      a = warp_sum(a);
      c = warp_sum(c);
      if (lane == 0) {
        part[r] = sz;
        part[ROWS + r] = d2;
        part[2 * ROWS + r] = a;
        part[3 * ROWS + r] = c;
      }
    }
    cluster.sync();
    if (lane < RW) {  // lane u: row RW wi + u over the cluster's blocks, in rank order
      const int r = RW * wi + lane;
      float v[4][MAX_CLUSTER];
#pragma unroll
      for (int q = 0; q < MAX_CLUSTER; ++q)
        if (q < C) {
          const float* pq = cluster.map_shared_rank(part, q);
#pragma unroll
          for (int i = 0; i < 4; ++i) v[i][q] = pq[i * ROWS + r];
        }
      float mu = 0.f, m2 = 0.f, s1 = 0.f, s2 = 0.f;
#pragma unroll
      for (int q = 0; q < MAX_CLUSTER; ++q)
        if (q < C) mu += v[0][q];
      mu /= K;
#pragma unroll
      for (int q = 0; q < MAX_CLUSTER; ++q)
        if (q < C) {
          const int n = min(TILE, K - q * TILE);
          const float shift = v[0][q] / n - mu;  // the block's mean from the row's
          m2 += v[1][q] + n * shift * shift;
          s1 += v[2][q];
          s2 += v[3][q] + shift * v[2][q];
        }
      const float rs = rsqrtf(m2 / K + 1e-5f);
      stats[r] = make_float4(mu, rs, s1 / K, rs * s2 / K);
    }
    named_sync(1, 256);  // every row's statistics

    // 2) dz (+ the residual's cotangent), the LayerNorm output and the
    // column sums: thread (rg, cg) takes the block's columns 8 cg .. 8 cg + 7
    // of rows rg, rg + 8, ..., RB rows at a time with their loads issued
    // first; its sums run over its rows in order, then over the 8 row
    // groups in order (shared memory)
    constexpr int RB = 8;
    const int rg = tid >> 5, kc = k0 + 8 * lane;
    float gk[8], bk[8], rk[8], dg[8], db[8], dr[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      gk[e] = kc + e < K ? gamma[kc + e] : 0.f;
      bk[e] = kc + e < K ? beta[kc + e] : 0.f;
      rk[e] = dg[e] = db[e] = dr[e] = 0.f;
    }
    if (br != nullptr && kc < K) load_cols<8>(br, kc, kc, K, vec, rk);
#pragma unroll 1
    for (int r0 = rg; r0 < ROWS; r0 += 8 * RB) {
      float xv[RB][8], rv[RB][8];
#pragma unroll
      for (int u = 0; u < RB; ++u) {
        const int r = r0 + 8 * u;
        const size_t at = (m0 + r) * K + kc;
#pragma unroll
        for (int e = 0; e < 8; ++e) xv[u][e] = rv[u][e] = 0.f;
        if (r < nr && kc < K) {
          load_cols<8>(x, at, kc, K, vec, xv[u]);
          if (dres != nullptr) load_cols<8>(dres, at, kc, K, vec, rv[u]);
        }
      }
#pragma unroll
      for (int u = 0; u < RB; ++u) {
        const int r = r0 + 8 * u;
        if (r >= nr || kc >= K) continue;
        const size_t at = (m0 + r) * K + kc;
        const float4 st = stats[r];
        const float* er = Es + r * ELD + 8 * lane;
        const float4 d0 = *reinterpret_cast<const float4*>(er);
        const float4 d1 = *reinterpret_cast<const float4*>(er + 4);
        const float dl[8] = {d0.x, d0.y, d0.z, d0.w, d1.x, d1.y, d1.z, d1.w};
        float lo[8], dz[8];
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          float zk = xv[u][e];
          if (br != nullptr) zk = round_bf16(zk + rk[e]);
          const float xhat = (zk - st.x) * st.y;
          dg[e] += dl[e] * xhat;
          db[e] += dl[e];
          lo[e] = xhat * gk[e] + bk[e];
          dz[e] = st.y * (dl[e] * gk[e] - st.z - xhat * st.w) + rv[u][e];
          dr[e] += dz[e];
        }
        if (ln_out != nullptr) store_cols<8>(ln_out, at, kc, K, vec, lo);
        store_cols<8>(dx, at, kc, K, vec, dz);
      }
    }
    float* cs = Es + ROWS * ELD;  // [3][8][TILE]: each row group's column sums
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      cs[(0 * 8 + rg) * TILE + 8 * lane + e] = dg[e];
      cs[(1 * 8 + rg) * TILE + 8 * lane + e] = db[e];
      cs[(2 * 8 + rg) * TILE + 8 * lane + e] = dr[e];
    }
    named_sync(1, 256);
    // the tile's partials: [tiles][K] of d(gamma), of d(beta), then of
    // d(bias_row) (a tile lies within one batch), which
    // ln_dx_column_sums_kernel adds in a fixed order
    const int k = k0 + tid, tiles = g.batches * g.tiles_pb;
    if (k < K) {
      float sum[3] = {0.f, 0.f, 0.f};
#pragma unroll
      for (int q = 0; q < 3; ++q)
#pragma unroll
        for (int i = 0; i < 8; ++i) sum[q] += cs[(q * 8 + i) * TILE + tid];
      col_part[(size_t)tile * K + k] = sum[0];
      col_part[((size_t)tiles + tile) * K + k] = sum[1];
      if (brow) col_part[(2 * (size_t)tiles + tile) * K + k] = sum[2];
    }
    cluster.sync();  // no block leaves while another may read its partials
  }
}

// dY' row-major (M, NP) bf16 from dy (M, N), any 2-byte aligned start: the
// keep mask applied and scaled (one Philox a thread, 4 columns), zeros past
// N, so that TMA reads it in aligned boxes and each keep word is drawn once
__global__ void __launch_bounds__(256) dx_prep_kernel(const bf16* __restrict__ dy,
                                                      bf16* __restrict__ out, long long M, int N,
                                                      int NP, Drop drop) {
  const long long groups = M * (NP / 4);
  for (long long i = blockIdx.x * 256ll + threadIdx.x; i < groups; i += (long long)gridDim.x * 256) {
    const long long row = i / (NP / 4);
    const int c = (int)(i - row * (NP / 4)) * 4;
    uint4 kw = make_uint4(0u, 0u, 0u, 0u);
    if (drop.on()) kw = keep_words(drop, 0u, (uint32_t)row, (uint32_t)c >> 2);
    float v[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      v[e] = c + e < N ? to_f(dy[row * N + c + e]) : 0.f;
      if (drop.on()) v[e] = word_of(kw, e) < drop.threshold ? v[e] * drop.scale : 0.f;
    }
    *reinterpret_cast<uint2*>(out + row * NP + c) =
        make_uint2(pack_bf16(v[0], v[1]), pack_bf16(v[2], v[3]));
  }
}

template <bool LN>
int launch(const DxPlan& P, const CUtensorMap& dymap, const CUtensorMap& wmap, const Args& g,
           cudaStream_t stream, bf16* dx, const bf16* pre, Drop dout, const bf16* x,
           const bf16* pro_row, const float* gamma, const float* beta, const bf16* dres,
           bf16* ln_out, float* dgamma, float* dbeta, float* dbrow, float* col_part) {
  cudaError_t err = cudaFuncSetAttribute(dx_wgmma_kernel<LN>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  if (err != cudaSuccess) return (int)err;
  const int tiles = g.batches * g.tiles_pb;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(tiles * g.ctiles), 1u, 1u);
  cfg.blockDim = dim3(THREADS, 1u, 1u);
  cfg.dynamicSmemBytes = (size_t)SMEM;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)P.cluster;
  attr[0].val.clusterDim.y = 1u;
  attr[0].val.clusterDim.z = 1u;
  cfg.attrs = attr;
  cfg.numAttrs = P.cluster > 1 ? 1 : 0;
  err = cudaLaunchKernelEx(&cfg, dx_wgmma_kernel<LN>, dymap, wmap, g, dx, pre, dout, x, pro_row,
                           gamma, beta, dres, ln_out, col_part, (int)(dbrow != nullptr));
  if (err != cudaSuccess || (err = cudaGetLastError()) != cudaSuccess || !LN) return (int)err;
  ln_dx_column_sums_kernel<<<dim3((unsigned)((g.K + 31) / 32), 2 + (dbrow ? g.batches : 0)),
                             SUM_WARPS * 32, 0, stream>>>(col_part, dgamma, dbeta, dbrow, g.K,
                                                          tiles, ROWS, g.rows, g.tiles_pb);
  return (int)cudaGetLastError();
}

}  // namespace wx

// ---------------------------------------------------------------------------
// ln_linear_wgrad: dW^T = A^T dY' on wgmma (hopper.cuh)

namespace wg {

constexpr int CONSUMERS = 3;                    // consumer warpgroups: a 64-column slab of A each
constexpr int KT = 64 * CONSUMERS;              // A columns (dW columns k) a block
constexpr int MAX_NT = 160;                     // dY columns (dW rows n) a block at most
constexpr int ROWS = 64;                        // rows a chunk
constexpr int THREADS = 128 * (CONSUMERS + 1);  // and a producer warpgroup
constexpr int PREP = 96;                        // its threads that unpack (warps 1-3)
constexpr int TARGET_BLOCKS = 264;              // two blocks a SM of an H100, fixed in the plan
constexpr int MAX_CLUSTER = 8;                  // blocks that sum one slice's tile
constexpr int PARTIAL_SHARE = 20;               // slices <= M / (20 K): partials <= 10% of dY's bytes
constexpr int ELD = KT + 4;                     // row stride of the fp32 tile [n][k]
constexpr int SUB = ROWS * 64;                  // bytes of a [64][32] sub-tile
constexpr int HEAD = 1024;                      // barriers and the block's column sums
constexpr int MAX_SMEM = 232448;
enum Copy { TMA = 0, SPAN = 1, SEGMENTS = 2 };  // how an operand reaches shared memory

__host__ __device__ constexpr int up(int a, int b) { return cdiv(a, b) * b; }

// The launch of one call (ops/ln_linear.py wgrad_plan mirrors it). Rows are
// walked in chunks of 64 within a batch of the chunk space (head-major dY:
// rows_per_batch rows a batch, so that a chunk is one box of each plane;
// row-major: one batch of M rows). A block owns an output tile of NT dY
// columns x KT A columns and a contiguous range of chunks; the blocks of a
// cluster own consecutive ranges of one slice and sum their tiles in
// distributed shared memory, in rank order; each slice writes one fp32
// partial, which the caller sums in slice order. Two rings: the panels the
// products read ([64][KT] of A, [64][NT] of dY', TMA's boxes land there),
// and the rows copied whole that the prep warps unpack into them, so that a
// copied chunk's stage frees before its products run.
struct Plan {
  int nt, parts, n_tiles, k_tiles;     // parts: n-tiles a head-major plane
  int slices, cluster, chunks, cpb;    // cpb: chunks a batch
  int a_copy, dy_copy;                 // Copy of each operand
  int pstages, rstages;                // depth of the panel ring and of the copied rows' ring
  int pstage_bytes, rstage_bytes, d_off, ds_off, raw_off, smem;
};

// the staging row stride (elements) of a copied row segment of `width`
// columns: its aligned granules, one of slack at each end
__host__ __device__ constexpr int seg_ld(int width) { return width + 16; }

// M rows of dY (logical N columns; head-major: N / head_dim planes of
// head_pad) against A (M, K). The slice count depends on the shape alone.
// An operand whose rows are 16-byte aligned goes by TMA; else, where a
// tile takes whole rows, as the contiguous span of the chunk's rows (rows
// of 155 bf16: 64 rows are one span of 19,840 bytes), and otherwise as one
// copy of each row's segment (A (M, 620): 1240-byte rows); both are
// unpacked into the panels. Ring depths: the deepest pair (panels first)
// that fits.
__host__ __device__ inline Plan wgrad_plan(int M, int N, int K, int rows_per_batch, int heads,
                                          int head_dim, int head_pad, bool dy_aligned,
                                          bool a_aligned) {
  Plan p{};
  if (heads) {
    p.parts = cdiv(head_pad, MAX_NT);
    p.nt = up(cdiv(head_pad, p.parts), 32);
    p.n_tiles = N / head_dim * p.parts;
  } else {
    p.parts = 1;
    p.n_tiles = cdiv(N, MAX_NT);
    p.nt = up(cdiv(N, p.n_tiles), 32);
  }
  p.k_tiles = cdiv(K, KT);
  const int batches = heads ? M / rows_per_batch : 1, rows = heads ? rows_per_batch : M;
  p.cpb = cdiv(rows, ROWS);
  p.chunks = batches * p.cpb;
  const int tiles = p.n_tiles * p.k_tiles;
  int s = M / (PARTIAL_SHARE * K);
  s = s < 1 ? 1 : s;
  s = s < cdiv(TARGET_BLOCKS, tiles) ? s : cdiv(TARGET_BLOCKS, tiles);
  p.slices = s < p.chunks ? s : p.chunks;
  int c = cdiv(TARGET_BLOCKS, p.slices * tiles);
  c = c < MAX_CLUSTER ? c : MAX_CLUSTER;
  c = c < p.chunks / p.slices ? c : p.chunks / p.slices;
  p.cluster = c < 1 ? 1 : c;
  p.a_copy = a_aligned ? TMA : p.k_tiles == 1 ? SPAN : SEGMENTS;
  p.dy_copy = heads || dy_aligned ? TMA : p.n_tiles == 1 ? SPAN : SEGMENTS;
  auto staged = [](int copy, int row_elems, int tile) {
    return copy == SPAN ? up(ROWS * row_elems * 2 + 32, 128)
           : copy == SEGMENTS ? up(ROWS * seg_ld(tile) * 2 + 32, 128) : 0;
  };
  p.d_off = KT / 32 * SUB;  // a panel stage: A's panel, then dY's
  p.pstage_bytes = p.d_off + p.nt / 32 * SUB;
  p.ds_off = staged(p.a_copy, K, KT);  // a copied stage: A's rows, then dY's
  p.rstage_bytes = up(p.ds_off + staged(p.dy_copy, N, p.nt), 1024);
  const int tile = p.nt * ELD * 4;  // the fp32 tile, over the rings once they are drained
  const bool raw = p.rstage_bytes > 0;
  for (int ps = 4; ps >= 2 && p.smem == 0; --ps)
    for (int rs = raw ? 4 : 0; rs >= (raw ? 2 : 0) && p.smem == 0; --rs) {
      const int rings = ps * p.pstage_bytes + rs * p.rstage_bytes;
      const int smem = 1024 + HEAD + (rings > tile ? rings : tile);
      if (smem > MAX_SMEM) continue;
      p.pstages = ps;
      p.rstages = rs;
      p.raw_off = ps * p.pstage_bytes;
      p.smem = smem;
    }
  return p;
}

struct Args {
  int M, N, K, batches, rows;  // the chunk space: batches x rows (x 64-row chunks)
  int heads, head_dim, head_pad, planes;  // head-major dY: S * B * H planes of rows x head_pad
};

// Where `count` elements from element `at` of `base` lie in whole 16-byte
// granules: the first granule, the bytes (a multiple of 16), and the
// element's offset into it
__device__ __forceinline__ const unsigned char* granules(const bf16* base, long long at,
                                                         long long count, uint32_t& bytes,
                                                         int& shift) {
  const uintptr_t p = reinterpret_cast<uintptr_t>(base + at);
  const uintptr_t start = p & ~(uintptr_t)15;
  bytes = (uint32_t)(((p + (uintptr_t)count * 2 + 15) & ~(uintptr_t)15) - start);
  shift = (int)((p - start) >> 1);
  return reinterpret_cast<const unsigned char*>(start);
}

// Bulk copies (the copying warp's lanes) of a chunk's rows of a row-major
// (., W) operand that TMA cannot take: the span of rows row .. row + valid -
// 1 (lane 0), or each row's columns col0 .. col0 + width - 1 into rows
// seg_ld(tile) apart (a lane a row). Returns the lane's bytes.
__device__ __forceinline__ uint32_t copy_rows(int copy, const bf16* base, long long row,
                                              int valid, int W, int col0, int width, int tile,
                                              unsigned char* dst, uint64_t* bar, int lane,
                                              bool issue) {
  uint32_t total = 0, bytes;
  int shift;
  if (copy == SPAN) {
    if (lane == 0) {
      const unsigned char* src = granules(base, row * W, (long long)valid * W, bytes, shift);
      if (issue) hopper::bulk_copy_pieces(dst, src, bytes, bar);
      total = bytes;
    }
    return total;
  }
  for (int r = lane; r < valid; r += 32) {
    const unsigned char* src = granules(base, (row + r) * W + col0, width, bytes, shift);
    if (issue) hopper::bulk_copy(dst + r * seg_ld(tile) * 2, src, bytes, bar);
    total += bytes;
  }
  return total;
}

// The staging element index of (r, 0) of a chunk's copied rows
__device__ __forceinline__ int copied(int copy, const bf16* base, long long row, int W, int col0,
                                      int width, int tile, int r) {
  uint32_t bytes;
  int shift;
  if (copy == SPAN) {
    granules(base, row * W, 1, bytes, shift);
    return shift + r * W;
  }
  granules(base, (row + r) * W + col0, width, bytes, shift);
  return r * seg_ld(tile) + shift;
}

template <int NT>
__global__ void __launch_bounds__(THREADS, 1) wgrad_kernel(
    const __grid_constant__ CUtensorMap dymap, const __grid_constant__ CUtensorMap amap,
    const bf16* __restrict__ dy, const bf16* __restrict__ a, Args g, Plan P, Drop drop,
    float* __restrict__ dw_part, float* __restrict__ db_part) {
  using namespace hopper;
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  extern __shared__ unsigned char smem_raw[];
  // aligned by pointer arithmetic on the shared array, so that the compiler
  // keeps every access below in shared memory (LDS/STS, not generic ones)
  unsigned char* base = smem_raw + ((1024u - (smem_u32(smem_raw) & 1023u)) & 1023u);
  uint64_t* pfull = reinterpret_cast<uint64_t*>(base);  // [4] a panel stage's TMA boxes landed
  uint64_t* pready = pfull + 4;                          // [4] its unpacked rows are in
  uint64_t* pempty = pready + 4;                         // [4] its products are done
  uint64_t* rfull = pempty + 4;                          // [4] a copied stage's rows landed
  uint64_t* rempty = rfull + 4;                          // [4] they are unpacked
  float* dbs = reinterpret_cast<float*>(base + 256);     // [NT] the block's column sums
  unsigned char* ring = base + HEAD;                     // panels, then the copied rows
  unsigned char* raw = ring + P.raw_off;
  const int PS = P.pstages, RS = P.rstages;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid & 31, wgi = tid / 128;
  const int rank = (int)cluster.block_rank(), tile = blockIdx.x / P.cluster;
  const int n_tile = tile / P.k_tiles, k0 = (tile - n_tile * P.k_tiles) * KT;
  // the tile's dY columns: columns col0 .. of head-major plane `plane`, or
  // of the row-major dY
  const int plane = g.heads ? n_tile / P.parts : 0;
  const int col0 = g.heads ? (n_tile - plane * P.parts) * NT : n_tile * NT;
  const int width = g.heads ? g.head_pad - col0 : g.N - col0;  // stored columns from col0
  const int a_w = min(KT, g.K - k0), d_w = min(NT, width);      // the tile's columns of each
  const int U = P.slices * P.cluster, u = blockIdx.y * P.cluster + rank;
  const int c_begin = (int)((long long)P.chunks * u / U);
  const int c_end = (int)((long long)P.chunks * (u + 1) / U);
  const bool with_db = db_part != nullptr && k0 == 0;
  const bool prep = RS > 0;  // some operand is unpacked from copied rows
  const bool tma = P.a_copy == TMA || P.dy_copy == TMA;

  if (tid == 0) {
    for (int s = 0; s < 4; ++s) {
      bar_init(&pfull[s], 1);
      bar_init(&pready[s], PREP);
      bar_init(&pempty[s], 128 * CONSUMERS);
      bar_init(&rfull[s], 1);
      bar_init(&rempty[s], PREP);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // the panels' sub-tiles that no copy writes stay zero
  for (int i = tid; i < PS * P.pstage_bytes / 16; i += THREADS)
    reinterpret_cast<uint4*>(ring)[i] = make_uint4(0u, 0u, 0u, 0u);
  fence_async_smem();
  __syncthreads();

  // chunk c: batch b of the chunk space, its first row and valid rows
  auto chunk = [&](int c, int& b, int& row0) {
    b = c / P.cpb;
    row0 = (c - b * P.cpb) * ROWS;
    return min(ROWS, g.rows - row0);
  };

  float acc[NT / 2];  // the consumers' tile: k = k0 + 64 wgi + row, n = col0 + column
#pragma unroll
  for (int i = 0; i < NT / 2; ++i) acc[i] = 0.f;
  float dbias = 0.f;  // consumer tid < NT: column tid's sum of dY'
  if (warp == 4 * CONSUMERS) {
    // the copying warp: the copied rows (lanes) and TMA's boxes (lane 0)
    const int hs = g.heads ? plane / g.heads : 0, hh = g.heads ? plane - hs * g.heads : 0;
    for (int c = c_begin, it = 0; c < c_end; ++c, ++it) {
      const int ps = it % PS;
      int b, row0;
      const int valid = chunk(c, b, row0);
      const long long grow = (long long)b * g.rows + row0;
      if (prep) {
        const int rs = it % RS;
        if (it >= RS) bar_wait(&rempty[rs], (uint32_t)((it / RS - 1) & 1));
        unsigned char* st = raw + rs * P.rstage_bytes;
        uint32_t bytes = 0;
        if (P.a_copy != TMA)
          bytes += copy_rows(P.a_copy, a, grow, valid, g.K, k0, a_w, KT, st, &rfull[rs], lane, false);
        if (P.dy_copy != TMA)
          bytes += copy_rows(P.dy_copy, dy, grow, valid, g.N, col0, d_w, NT, st + P.ds_off, &rfull[rs], lane, false);
        bytes = __reduce_add_sync(0xffffffffu, bytes);
        if (lane == 0) bar_expect(&rfull[rs], bytes);
        __syncwarp();
        if (P.a_copy != TMA)
          copy_rows(P.a_copy, a, grow, valid, g.K, k0, a_w, KT, st, &rfull[rs], lane, true);
        if (P.dy_copy != TMA)
          copy_rows(P.dy_copy, dy, grow, valid, g.N, col0, d_w, NT, st + P.ds_off, &rfull[rs], lane, true);
      }
      if (tma) {
        if (it >= PS) bar_wait(&pempty[ps], (uint32_t)((it / PS - 1) & 1));
        unsigned char* st = ring + ps * P.pstage_bytes;
        if (lane == 0) {
          uint32_t bytes = 0;
          if (P.a_copy == TMA) bytes += (uint32_t)cdiv(a_w, 32) * SUB;
          if (P.dy_copy == TMA) bytes += (uint32_t)cdiv(d_w, 32) * SUB;
          bar_expect(&pfull[ps], bytes);
          if (P.a_copy == TMA)
            for (int i = 0; i < cdiv(a_w, 32); ++i)
              tma_box(st + i * SUB, &amap, k0 + 32 * i, row0, b, &pfull[ps]);
          if (P.dy_copy == TMA) {
            const int dplane = g.heads ? (hs * g.batches + b) * g.heads + hh : 0;
            for (int i = 0; i < cdiv(d_w, 32); ++i)
              tma_box(st + P.d_off + i * SUB, &dymap, col0 + 32 * i, row0, dplane, &pfull[ps]);
          }
        }
      }
      __syncwarp();
    }
  } else if (wgi == CONSUMERS) {
    // warps 1-3 of the producer warpgroup: the copied rows unpacked into
    // the panels, 8 columns a store. A thread keeps one unit column and
    // steps through every rps-th row, so that the loops carry no division;
    // four rows at a time, their loads all issued before any store (which
    // the compiler may not move past them: shared memory both ways)
    const int pt = tid - 128 * CONSUMERS - 32;
    const int au = up(a_w, 32) / 8, a_rps = PREP / au, a_c = (pt % au) * 8, a_r = pt / au;
    const int du = NT / 8, d_rps = PREP / du, d_c = (pt % du) * 8, d_r = pt / du;
    constexpr int RB = 4;
    for (int c = c_begin, it = 0; c < c_end && prep; ++c, ++it) {
      const int ps = it % PS, rs = it % RS;
      const unsigned char* st = raw + rs * P.rstage_bytes;
      unsigned char* pan = ring + ps * P.pstage_bytes;
      bar_wait(&rfull[rs], (uint32_t)((it / RS) & 1));
      if (it >= PS) bar_wait(&pempty[ps], (uint32_t)((it / PS - 1) & 1));
      int b, row0;
      const int valid = chunk(c, b, row0);
      const long long grow = (long long)b * g.rows + row0;
      if (P.a_copy != TMA && a_r < a_rps) {
        for (int r0 = a_r; r0 < ROWS; r0 += RB * a_rps) {
          uint4 lo[RB], hi[RB];
          int e[RB];
#pragma unroll
          for (int q = 0; q < RB; ++q) {
            const int r = r0 + q * a_rps;
            e[q] = r < valid && a_c < a_w ? copied(P.a_copy, a, grow, g.K, k0, a_w, KT, r) + a_c : -1;
            const uint4* src = reinterpret_cast<const uint4*>(st) + (e[q] < 0 ? 0 : e[q] >> 3);
            lo[q] = src[0];
            hi[q] = src[1];
          }
#pragma unroll
          for (int q = 0; q < RB; ++q) {
            const int r = r0 + q * a_rps;
            if (r >= ROWS) break;
            const uint4 v = e[q] < 0 ? make_uint4(0u, 0u, 0u, 0u)
                                     : keep_first(shift8(lo[q], hi[q], e[q] & 7), a_w - a_c);
            *reinterpret_cast<uint4*>(pan + elem_at(ROWS, r, a_c)) = v;
          }
        }
      }
      if (P.dy_copy != TMA && d_r < d_rps) {
        for (int r0 = d_r; r0 < ROWS; r0 += RB * d_rps) {
          uint4 lo[RB], hi[RB];
          int e[RB];
#pragma unroll
          for (int q = 0; q < RB; ++q) {
            const int r = r0 + q * d_rps;
            e[q] = r < valid && d_c < d_w ? copied(P.dy_copy, dy, grow, g.N, col0, d_w, NT, r) + d_c : -1;
            const uint4* src = reinterpret_cast<const uint4*>(st + P.ds_off) + (e[q] < 0 ? 0 : e[q] >> 3);
            lo[q] = src[0];
            hi[q] = src[1];
          }
#pragma unroll
          for (int q = 0; q < RB; ++q) {
            const int r = r0 + q * d_rps;
            if (r >= ROWS) break;
            const uint4 raw_v = e[q] < 0 ? make_uint4(0u, 0u, 0u, 0u)
                                         : keep_first(shift8(lo[q], hi[q], e[q] & 7), d_w - d_c);
            *reinterpret_cast<uint4*>(pan + P.d_off + elem_at(ROWS, r, d_c)) = raw_v;
          }
        }
      }
      bar_arrive(&rempty[rs]);  // the copied rows are read
      fence_async_smem();
      bar_arrive(&pready[ps]);
    }
  } else {
    // consumers: warpgroup wgi owns A columns k0 + 64 wgi .. + 63
    fence_regs(acc);
    for (int c = c_begin, it = 0; c < c_end; ++c, ++it) {
      const int ps = it % PS;
      unsigned char* st = ring + ps * P.pstage_bytes;
      if (prep) bar_wait(&pready[ps], (uint32_t)((it / PS) & 1));
      if (tma) bar_wait(&pfull[ps], (uint32_t)((it / PS) & 1));
      if (drop.on()) {
        // dY's keep mask in place, by the consumers (idle while the chunk
        // came in): one Philox per 4 columns, each element's word drawn
        // once by this block
        int b, row0;
        const int valid = chunk(c, b, row0);
        const long long grow = (long long)b * g.rows + row0;
#pragma unroll 1
        for (int i = tid; i < ROWS * (NT / 8); i += 128 * CONSUMERS) {
          const int r = i / (NT / 8), n = (i % (NT / 8)) * 8;
          if (r >= valid) continue;
          uint4* dst = reinterpret_cast<uint4*>(st + P.d_off + elem_at(ROWS, r, n));
          const uint4 rv = *dst;
          const uint32_t w[4] = {rv.x, rv.y, rv.z, rv.w};
          const uint32_t row = (uint32_t)(grow + r), grp = (uint32_t)(col0 + n) >> 2;
          const uint4 k0w = keep_words(drop, 0u, row, grp), k1w = keep_words(drop, 0u, row, grp + 1u);
          uint32_t o[4];
#pragma unroll
          for (int h = 0; h < 4; ++h) {
            const uint4& kw = h < 2 ? k0w : k1w;
            const float lo = __uint_as_float(w[h] << 16), hi = __uint_as_float(w[h] & 0xffff0000u);
            o[h] = pack_bf16(word_of(kw, (2 * h) & 3) < drop.threshold ? lo * drop.scale : 0.f,
                             word_of(kw, (2 * h + 1) & 3) < drop.threshold ? hi * drop.scale : 0.f);
          }
          *dst = make_uint4(o[0], o[1], o[2], o[3]);
        }
        fence_async_smem();
        named_sync(1, 128 * CONSUMERS);  // the chunk's dY' is complete
      }
      if (with_db && tid < NT) {  // db: column tid of the chunk's dY'
        const unsigned char* dp = st + P.d_off;
#pragma unroll 8
        for (int r = 0; r < ROWS; ++r)
          dbias += to_f(*reinterpret_cast<const bf16*>(dp + elem_at(ROWS, r, tid)));
      }
      const uint32_t a_s = smem_u32(st), d_s = smem_u32(st + P.d_off);
      mma_fence();
#pragma unroll
      for (int kk = 0; kk < ROWS / 16; ++kk)
        wgmma::Mma<NT>::template ss<1, 1>(acc, desc_mn(a_s, ROWS, 2 * wgi, kk),
                                          desc_mn(d_s, ROWS, 0, kk), 1);
      mma_commit();
      mma_wait<1>();  // the previous chunk's products are done: its stage is free
      if (it > 0) bar_arrive(&pempty[(it - 1) % PS]);
    }
    mma_wait<0>();
    fence_regs(acc);
  }
  __syncwarp();
  __syncthreads();  // every chunk consumed: the rings are free
  float* Es = reinterpret_cast<float*>(ring);  // the tile as [n][k]
  if (wgi < CONSUMERS) {
    const int w = warp & 3, gq = lane >> 2, t = lane & 3;
#pragma unroll
    for (int j = 0; j < NT / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        Es[(8 * j + 2 * t + (e & 1)) * ELD + 64 * wgi + 16 * w + gq + (e >> 1) * 8] = acc[4 * j + e];
    if (with_db && tid < NT) dbs[tid] = dbias;
  }
  cluster.sync();  // every block of the cluster holds its tile
  // block `rank` sums rows NT rank / C .. of the cluster's tiles in rank
  // order and writes them to the slice's partial
  const int C = P.cluster, nb = NT * rank / C, ne = NT * (rank + 1) / C;
  float* out = dw_part + (size_t)blockIdx.y * g.N * g.K;
  auto out_row = [&](int nl) {  // the dW row of tile row nl, or -1
    const int d = col0 + nl;
    if (g.heads) return d < g.head_dim ? plane * g.head_dim + d : -1;
    return d < g.N ? d : -1;
  };
  for (int i = tid; i < (ne - nb) * a_w; i += THREADS) {
    const int nl = nb + i / a_w, kl = i - (i / a_w) * a_w, n = out_row(nl);
    if (n < 0) continue;
    float v = 0.f;
    for (int q = 0; q < C; ++q) v += cluster.map_shared_rank(Es, q)[nl * ELD + kl];
    out[(size_t)n * g.K + k0 + kl] = v;
  }
  if (with_db)
    for (int nl = nb + tid; nl < ne; nl += THREADS) {
      const int n = out_row(nl);
      if (n < 0) continue;
      float v = 0.f;
      for (int q = 0; q < C; ++q) v += cluster.map_shared_rank(dbs, q)[nl];
      db_part[(size_t)blockIdx.y * g.N + n] = v;
    }
  cluster.sync();  // no block leaves while another reads its tile
}

template <int NT>
int launch(const Plan& P, const CUtensorMap& dymap, const CUtensorMap& amap, const bf16* dy,
           const bf16* a, const Args& g, Drop drop, float* dw_part, float* db_part,
           cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(wgrad_kernel<NT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, P.smem);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(P.cluster * P.n_tiles * P.k_tiles), (unsigned)P.slices, 1u);
  cfg.blockDim = dim3(THREADS, 1u, 1u);
  cfg.dynamicSmemBytes = (size_t)P.smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)P.cluster;
  attr[0].val.clusterDim.y = 1u;
  attr[0].val.clusterDim.z = 1u;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, wgrad_kernel<NT>, dymap, amap, dy, a, g, P, drop, dw_part,
                           db_part);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace wg
}  // namespace

// Returns a CUDA error code (0 on success). dX = mask(dy) W for dy (M, N):
// row-major when heads == 0 (any 2-byte aligned start), else head-major as
// ln_linear writes q/k/v, (N / (heads head_dim), B, heads, rows, head_pad)
// from a 16-byte aligned start, finite past head_dim (attention_bwd and
// ln_linear write zeros there; they meet zero rows of wt). wt = W^T (K, NP)
// bf16 over dy's stored columns: row-major, zero-padded from N to NP, a
// multiple of 32; head-major, each head's D columns zero-padded to head_pad
// (a multiple of 32), NP = N / head_dim * head_pad. threshold_in > 0
// applies the keep mask (seed, site_in) to dy. Plain epilogue (x == null):
// dx (M, K) bf16, with pre (M, K) set also fc1's keep mask (seed, site_out,
// threshold_out) and GELU'(pre). LayerNorm epilogue (x != null): dx receives
// dz = the LayerNorm backward of dX at z = x (+ pro_row), plus dres when not
// null; ln_out, when not null, the bf16 LayerNorm output; dgamma, dbeta (K)
// and dbrow (B, K) (null: none) receive fp32 sums, added in an order fixed by
// the shape through col_part, float32 scratch of ops/ln_linear.py
// dx_col_parts's size. K > 2048 with LayerNorm takes dln, (M, K) float32
// scratch for the d(ln) rows. Past K 640 (dx_plan's wgmma) a row-major dy
// that is masked or not 16-byte aligned is first written to dy_prep, (M, NP)
// bf16 scratch; a head-major dy takes no mask there.
extern "C" int v1t_ln_linear_dx(const void* dy, void* dx, const void* wt, int M, int N, int K,
                                int NP, int rows_per_batch, int heads, int head_dim,
                                int head_pad, unsigned seed, unsigned site_in,
                                unsigned threshold_in, const void* pre, unsigned site_out,
                                unsigned threshold_out, float drop_scale, const void* x,
                                const void* pro_row, const void* gamma, const void* beta,
                                const void* dres, void* ln_out, void* dgamma, void* dbeta,
                                void* dbrow, void* col_part, void* dln, void* dy_prep,
                                void* stream) {
  const bool ln = x != nullptr;
  const uintptr_t addr = reinterpret_cast<uintptr_t>(dy);
  const int shift = (int)((addr & 15) >> 1);
  if (M < 1 || N < 1 || K < 1 || rows_per_batch < 1 || M % rows_per_batch != 0 ||
      (ln && (col_part == nullptr || M / rows_per_batch > 65533)) || (addr & 1))
    return (int)cudaErrorInvalidValue;
  if (heads ? head_dim < 1 || head_pad < head_dim || head_pad % DX_BC != 0 ||
                  N % (heads * head_dim) != 0 || NP != N / head_dim * head_pad || shift != 0
            : NP % DX_BC != 0 || NP < N)
    return (int)cudaErrorInvalidValue;
  const bool aligned = heads || (N % 8 == 0 && shift == 0);
  const DxPlan plan = dx_plan(K, NP, aligned, ln);
  if (plan.smem == 0 || (plan.dln_global && dln == nullptr)) return (int)cudaErrorInvalidValue;
  const Drop din{seed, site_in, threshold_in, drop_scale};
  const Drop dout{seed, site_out, threshold_out, drop_scale};
  cudaStream_t s = (cudaStream_t)stream;
  auto* w = (const bf16*)wt;
  if (plan.wgmma) {
    const bool prep = !heads && (threshold_in != 0u || !aligned);
    if ((heads && threshold_in != 0u) || (prep && dy_prep == nullptr))
      return (int)cudaErrorInvalidValue;
    const bool per_batch = ln || heads;  // LayerNorm row tiles lie within a batch
    wx::Args g{K, NP, per_batch ? rows_per_batch : M, per_batch ? M / rows_per_batch : 1, 0,
               heads, head_pad, plan.k_tiles, 0};
    g.tiles_pb = cdiv(g.rows, wx::ROWS);
    if ((long long)g.batches * g.tiles_pb * g.ctiles > 0x7fffffffll)
      return (int)cudaErrorInvalidValue;
    uintptr_t ors = reinterpret_cast<uintptr_t>(dx);
    for (const void* p : {pre, x, pro_row, dres, (const void*)ln_out})
      ors |= reinterpret_cast<uintptr_t>(p);
    g.vec = K % 8 == 0 && (ors & 15) == 0;
    int rc;
    if (prep) {
      const long long groups = (long long)M * (NP / 4);
      const long long blocks = (groups + 255) / 256;
      wx::dx_prep_kernel<<<(unsigned)(blocks < 132 * 16 ? blocks : 132 * 16), 256, 0, s>>>(
          (const bf16*)dy, (bf16*)dy_prep, M, N, NP, din);
      if ((rc = (int)cudaGetLastError()) != 0) return rc;
    }
    CUtensorMap dymap, wmap;
    memset(&dymap, 0, sizeof(dymap));
    memset(&wmap, 0, sizeof(wmap));
    if (heads)
      rc = hopper::make_map128(&dymap, dy, N / head_dim * g.batches, rows_per_batch, head_pad,
                               head_pad, wx::ROWS);
    else if (prep)
      rc = hopper::make_map128(&dymap, dy_prep, g.batches, g.rows, NP, NP, wx::ROWS);
    else
      rc = hopper::make_map128(&dymap, dy, g.batches, g.rows, N, N, wx::ROWS);
    if (rc != 0 || (rc = hopper::make_map128(&wmap, wt, 1, K, NP, NP, wx::TILE)) != 0) return rc;
    if (ln)
      return wx::launch<true>(plan, dymap, wmap, g, s, (bf16*)dx, nullptr, dout, (const bf16*)x,
                              (const bf16*)pro_row, (const float*)gamma, (const float*)beta,
                              (const bf16*)dres, (bf16*)ln_out, (float*)dgamma, (float*)dbeta,
                              (float*)dbrow, (float*)col_part);
    return wx::launch<false>(plan, dymap, wmap, g, s, (bf16*)dx, (const bf16*)pre, dout, nullptr,
                             nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
                             nullptr, nullptr);
  }
  const bf16* dyb = reinterpret_cast<const bf16*>(aligned ? addr : addr & ~(uintptr_t)15);
  const Layout L{N, rows_per_batch, M / rows_per_batch, heads, head_dim, head_pad};
  const int sh = aligned ? 0 : shift;
  if (ln) {
    auto run = plan.dln_global ? (plan.bm == 128 ? &launch_dx<4, true, true> : &launch_dx<2, true, true>)
                               : (plan.bm == 128 ? &launch_dx<4, true> : &launch_dx<2, true>);
    return run(plan, s, dyb, L, sh, din, w, (bf16*)dx, M, K, NP, nullptr, dout, (const bf16*)x,
               (const bf16*)pro_row, (const float*)gamma, (const float*)beta,
               (const bf16*)dres, (bf16*)ln_out, (float*)dgamma, (float*)dbeta, (float*)dbrow,
               (float*)col_part, (float*)dln);
  }
  auto run = plan.bm == 128 ? &launch_dx<4, false> : &launch_dx<2, false>;
  return run(plan, s, dyb, L, sh, din, w, (bf16*)dx, M, K, NP, (const bf16*)pre, dout, nullptr,
             nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
             nullptr);
}

// One number of the ln_linear_dx launch for a K-wide output and NP stored
// reduction columns, dY rows 16-byte aligned (aligned != 0) or not, with
// the LayerNorm epilogue (ln != 0) or not (field: 0 rows a block, 1 ring
// stages, 2 resident, 3 output tiles, 4 dln_global, 5 wgmma, 6 blocks a
// cluster, 7 dynamic shared memory, 0 when none fits), -1 for another field.
extern "C" int v1t_ln_linear_dx_plan(int K, int NP, int aligned, int ln, int field) {
  const DxPlan p = dx_plan(K, NP, aligned != 0, ln != 0);
  const int values[8] = {p.bm, p.stages, p.resident, p.k_tiles, p.dln_global,
                         p.wgmma, p.cluster, p.smem};
  return field >= 0 && field < 8 ? values[field] : -1;
}

// Returns a CUDA error code (0 on success). dw_part (slices, N, K) float32
// receives each slice's dY'^T a and db_part (slices, N) its column sums of
// dY' (null: no bias), slices = v1t_ln_linear_wgrad_plan(..., 3); the caller
// sums them in slice order. dy as for v1t_ln_linear_dx (threshold > 0: keep
// mask (seed, site), row-major dy only); a (M, K) bf16, any 2-byte aligned
// start.
extern "C" int v1t_ln_linear_wgrad(const void* dy, const void* a, void* dw_part, void* db_part,
                                   int M, int N, int K, int rows_per_batch, int heads,
                                   int head_dim, int head_pad, unsigned seed, unsigned site,
                                   unsigned threshold, float drop_scale, void* stream) {
  const uintptr_t dy_at = reinterpret_cast<uintptr_t>(dy), a_at = reinterpret_cast<uintptr_t>(a);
  if (M < 1 || N < 1 || K < 1 || rows_per_batch < 1 || M % rows_per_batch != 0 ||
      ((dy_at | a_at) & 1))
    return (int)cudaErrorInvalidValue;
  if (heads && (head_dim < 1 || head_pad < head_dim || head_pad % 32 != 0 ||
                N % (heads * head_dim) != 0 || (dy_at & 15) || threshold != 0u))
    return (int)cudaErrorInvalidValue;
  const bool dy_aligned = heads || (N % 8 == 0 && (dy_at & 15) == 0);
  const bool a_aligned = K % 8 == 0 && (a_at & 15) == 0;
  const wg::Plan P = wg::wgrad_plan(M, N, K, rows_per_batch, heads, head_dim, head_pad,
                                    dy_aligned, a_aligned);
  if (P.smem == 0 || P.slices > 65535) return (int)cudaErrorInvalidValue;
  const wg::Args g{M, N, K, heads ? M / rows_per_batch : 1, heads ? rows_per_batch : M,
                   heads, head_dim, head_pad, heads ? N / head_dim * (M / rows_per_batch) : 1};
  CUtensorMap dymap, amap;
  memset(&dymap, 0, sizeof(dymap));
  memset(&amap, 0, sizeof(amap));
  int rc;
  if (P.a_copy == wg::TMA &&
      (rc = hopper::make_map(&amap, a, g.batches, g.rows, K, K, wg::ROWS)) != 0)
    return rc;
  if (P.dy_copy == wg::TMA &&
      (rc = heads ? hopper::make_map(&dymap, dy, g.planes, rows_per_batch, head_pad, head_pad,
                                     wg::ROWS)
                  : hopper::make_map(&dymap, dy, 1, M, N, N, wg::ROWS)) != 0)
    return rc;
  const Drop drop{seed, site, threshold, drop_scale};
  auto* d = (const bf16*)dy;
  auto* x = (const bf16*)a;
  cudaStream_t s = (cudaStream_t)stream;
  switch (P.nt) {
    case 32: return wg::launch<32>(P, dymap, amap, d, x, g, drop, (float*)dw_part, (float*)db_part, s);
    case 64: return wg::launch<64>(P, dymap, amap, d, x, g, drop, (float*)dw_part, (float*)db_part, s);
    case 96: return wg::launch<96>(P, dymap, amap, d, x, g, drop, (float*)dw_part, (float*)db_part, s);
    case 128: return wg::launch<128>(P, dymap, amap, d, x, g, drop, (float*)dw_part, (float*)db_part, s);
    case 160: return wg::launch<160>(P, dymap, amap, d, x, g, drop, (float*)dw_part, (float*)db_part, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// One number of the ln_linear_wgrad launch for these operands (field: 0 nt,
// 1 n_tiles, 2 k_tiles, 3 slices, 4 cluster, 5 panel stages, 6 shared memory
// a block, 7 chunks, 8 A's copy, 9 dY's copy: 0 TMA, 1 span, 2 row
// segments; 10 copied-row stages), rows 16-byte aligned or not.
extern "C" int v1t_ln_linear_wgrad_plan(int M, int N, int K, int rows_per_batch, int heads,
                                        int head_dim, int head_pad, int dy_aligned,
                                        int a_aligned, int field) {
  const wg::Plan P = wg::wgrad_plan(M, N, K, rows_per_batch, heads, head_dim, head_pad,
                                    dy_aligned != 0, a_aligned != 0);
  const int values[11] = {P.nt, P.n_tiles, P.k_tiles, P.slices, P.cluster, P.pstages, P.smem,
                          P.chunks, P.a_copy, P.dy_copy, P.rstages};
  return field >= 0 && field < 11 ? values[field] : -1;
}
