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
//      Past K 640 (emb 768) the BM x K rows no longer fit: each output
//      tile's fp32 products go to (M, K) float32 scratch in device memory
//      (dln), shared memory keeps the 4 statistics a row, and the same
//      block reads its rows back (L2) for the row sums and dz; the column
//      sums stay block partials in a fixed order. One block a SM (255
//      registers a thread: the 128-register bound of two spilled).
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
// Not yet: ln_linear_dx on wgmma, with W^T multicast to a cluster; dY
// multicast to the tiles of A in ln_linear_wgrad; the two halves in one pass.
#include <cooperative_groups.h>
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
  int dln_global;  // LayerNorm past MAX_LN_K: the d(ln) rows in (M, K) fp32 scratch
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
// that fits; smem 0 when no launch fits.
DxPlan dx_plan(int K, int NS, bool aligned, bool ln) {
  DxPlan p{};
  p.k_tiles = (K + DX_KT - 1) / DX_KT;
  p.aligned = aligned;
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
// sums in warp order
constexpr int SUM_WARPS = 32;

__global__ void __launch_bounds__(SUM_WARPS * 32) ln_dx_column_sums_kernel(
    const float* __restrict__ col_part, float* __restrict__ dgamma, float* __restrict__ dbeta,
    float* __restrict__ dbrow, int K, int blocks, int bm, int rows_per_batch) {
  __shared__ float sums[SUM_WARPS][33];
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5, k = blockIdx.x * 32 + lane;
  const float* part;
  float* out;
  int n;
  if (blockIdx.y < 2) {
    part = col_part + (size_t)blockIdx.y * blocks * K;
    out = blockIdx.y ? dbeta : dgamma;
    n = blocks;
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
                                       L.rows_per_batch);
  return (int)cudaGetLastError();
}

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

__host__ __device__ constexpr int cdiv(int a, int b) { return (a + b - 1) / b; }
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
// threshold_out) and GELU'(pre). LayerNorm epilogue (x != null; K > 640
// takes dln, (M, K) float32 scratch for the d(ln) rows): dx receives dz = the LayerNorm backward of dX at z = x (+ pro_row), plus
// dres when not null; ln_out, when not null, the bf16 LayerNorm output;
// dgamma, dbeta (K) and dbrow (B, K) (null: none) receive fp32 sums, added
// in an order fixed by the shape through col_part, float32 scratch of (2
// blocks + (dbrow ? blocks + B - 1 : 0)) x K floats, blocks = ceil(M / the
// plan's rows a block) (ops/ln_linear.py dx_col_parts).
extern "C" int v1t_ln_linear_dx(const void* dy, void* dx, const void* wt, int M, int N, int K,
                                int NP, int rows_per_batch, int heads, int head_dim,
                                int head_pad, unsigned seed, unsigned site_in,
                                unsigned threshold_in, const void* pre, unsigned site_out,
                                unsigned threshold_out, float drop_scale, const void* x,
                                const void* pro_row, const void* gamma, const void* beta,
                                const void* dres, void* ln_out, void* dgamma, void* dbeta,
                                void* dbrow, void* col_part, void* dln, void* stream) {
  const bool ln = x != nullptr;
  const uintptr_t addr = reinterpret_cast<uintptr_t>(dy);
  const int shift = (int)((addr & 15) >> 1);
  if (M < 1 || N < 1 || K < 1 || rows_per_batch < 1 || M % rows_per_batch != 0 ||
      (ln && (col_part == nullptr || M / rows_per_batch > 65533 ||
              (K > MAX_LN_K && dln == nullptr))) ||
      (addr & 1))
    return (int)cudaErrorInvalidValue;
  if (heads ? head_dim < 1 || head_pad < head_dim || head_pad % DX_BC != 0 ||
                  N % (heads * head_dim) != 0 || NP != N / head_dim * head_pad || shift != 0
            : NP % DX_BC != 0 || NP < N)
    return (int)cudaErrorInvalidValue;
  const bool aligned = heads || (N % 8 == 0 && shift == 0);
  const DxPlan plan = dx_plan(K, NP, aligned, ln);
  if (plan.smem == 0) return (int)cudaErrorInvalidValue;
  const bf16* dyb = reinterpret_cast<const bf16*>(aligned ? addr : addr & ~(uintptr_t)15);
  const Layout L{N, rows_per_batch, M / rows_per_batch, heads, head_dim, head_pad};
  const Drop din{seed, site_in, threshold_in, drop_scale};
  const Drop dout{seed, site_out, threshold_out, drop_scale};
  const int sh = aligned ? 0 : shift;
  cudaStream_t s = (cudaStream_t)stream;
  auto* w = (const bf16*)wt;
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

// Dynamic shared memory of the ln_linear_dx launch for a K-wide output and
// NP stored reduction columns, dY rows 16-byte aligned (aligned != 0) or
// not, with the LayerNorm epilogue (ln != 0) or not; 0 when none fits.
extern "C" int v1t_ln_linear_dx_smem(int K, int NP, int aligned, int ln) {
  return dx_plan(K, NP, aligned != 0, ln != 0).smem;
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
