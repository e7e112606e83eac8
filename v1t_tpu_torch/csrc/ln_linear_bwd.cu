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
//      bf16 LayerNorm output for the weight gradient, and adds d(gamma),
//      d(beta) and the per-batch d(bias_row) sums with fp32 atomics (one
//      per column and block or batch; their order varies from run to run
//      by one fp32 rounding of partial sums, far below the bf16 results).
// 2. ln_linear_wgrad: dW = dY'^T A and db = colsum(dY') over the M =
//    B x N rows, A the layer's input (the saved activation, or the LayerNorm
//    output from 1). Split over the batch: a block computes a 64 x 64 tile of
//    one batch's partial, 32 rows at a time (both operands gathered into
//    registers a chunk ahead, then into shared memory; mma fragments through
//    ldmatrix.trans), and writes fp32
//    partials (B, N, K) that the caller sums over B, as the TPU kernels emit
//    per-batch partials for XLA to sum: a fixed order, the same every run.
//
// Bound on the H100 at the flagship shapes: every call moves more bytes
// than its FLOPs need time (100..150 FLOP/byte, under the ~295 ridge of bf16):
// bound by memory bytes, like the forward.
// Not yet: wgmma (mma.sync reaches about half its rate) and TMA multicast
// of each W^T chunk to the blocks of a cluster; ln_linear_wgrad still
// gathers dY' 2 bytes at a time (gather_dy4), once per 64-column tile; the
// two halves in one pass.
#include "common.cuh"

namespace {

// ln_linear_dx: a block's output tile is DX_KT columns wide (all of them
// up to K 160), its reduction walks chunks of DX_BC stored columns, each
// chunk's rows DX_LD apart (80 bytes: ldmatrix rows on distinct banks)
constexpr int DX_KT = 160, DX_BC = 32, DX_LD = DX_BC + 8, DX_GRAN = DX_LD / 8;
constexpr int DX_MAX_SMEM = 232448;  // a block's shared memory on an H100
// the LayerNorm backward takes K <= MAX_LN_K (its BM x K fp32 d(ln) rows in
// shared memory)
constexpr int MAX_LN_K = 640;
// ln_linear_wgrad: 64 x 64 tiles, 4 warps
constexpr int BN = 64, THREADS = 128;

// Where logical element (row, col) of an (M, N) operand lives: row-major, or
// head-major (N / (heads * head_dim), B, heads, rows_per_batch, head_pad).
struct Layout {
  int N, rows_per_batch, batches, heads, head_dim, head_pad;
};

// The raw bf16 bits of elements (row, col .. col + 3) of dY: the loads only,
// so that they can be in flight while the previous chunk multiplies (zero
// outside the M x N operand). One division per row and per column group.
__device__ __forceinline__ void gather_dy4(const bf16* __restrict__ dy, const Layout& L, int M,
                                           int row, int col, uint16_t raw[4]) {
  const uint16_t* bits = reinterpret_cast<const uint16_t*>(dy);
#pragma unroll
  for (int j = 0; j < 4; ++j) raw[j] = 0;
  if (row >= M) return;
  if (!L.heads) {
    const uint16_t* p = bits + (size_t)row * L.N + col;
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (col + j < L.N) raw[j] = p[j];
    return;
  }
  const int b = row / L.rows_per_batch, n = row - b * L.rows_per_batch;
  const int hd = L.heads * L.head_dim, s = col / hd, rem = col - s * hd;
  int h = rem / L.head_dim, d = rem - h * L.head_dim, sb = s * L.batches + b;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    if (col + j < L.N)
      raw[j] = bits[(((size_t)sb * L.heads + h) * L.rows_per_batch + n) * L.head_pad + d];
    if (++d == L.head_dim) {  // the next column starts the next head (or q/k/v part)
      d = 0;
      if (++h == L.heads) {
        h = 0;
        sb += L.batches;
      }
    }
  }
}

// dY' of those four elements: the keep mask (col is a multiple of 4, so the
// four share one Philox call) and the scale, as two packed bf16 pairs
__device__ __forceinline__ uint2 finish_dy4(const uint16_t raw[4], const Drop& drop, int row,
                                            int col) {
  float v[4];
  uint4 w = make_uint4(0u, 0u, 0u, 0u);
  if (drop.on()) w = keep_words(drop, 0u, (uint32_t)row, (uint32_t)col >> 2);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    v[j] = __uint_as_float((uint32_t)raw[j] << 16);  // bf16 -> float
    if (drop.on()) v[j] = word_of(w, j) < drop.threshold ? v[j] * drop.scale : 0.f;
  }
  return make_uint2(pack_bf16(v[0], v[1]), pack_bf16(v[2], v[3]));
}

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
};

// Shared memory, from 0: the W^T ring [stages][DX_KT][DX_LD]; the dY' tiles
// (resident: [bm][NS + 8], all chunks; else a ring of [bm][DX_LD], `stages`
// deep when copied straight in, 2 when unpacked from staging); staging
// [stages][bm][DX_LD] for rows that are not 16-byte aligned; the fp32
// products: plain, one output tile [bm][DX_KT + 4] after the ring;
// LayerNorm, the d(ln) rows [bm][K + 4] and 4 statistics a row, over the
// ring once it is free when K fits one output tile (else after it).
// Resident is chosen over the rest, 128 rows over 64; then the deepest
// ring of 4, 3, 2 that leaves room for two blocks a SM, else the deepest
// that fits; smem 0 when no launch fits.
DxPlan dx_plan(int K, int NS, bool aligned, bool ln) {
  DxPlan p{};
  p.k_tiles = (K + DX_KT - 1) / DX_KT;
  p.aligned = aligned;
  for (int resident = p.k_tiles > 1; resident >= 0; --resident)
    for (int bm = 128; bm >= 64; bm /= 2)
      for (int limit : {DX_MAX_SMEM / 2 - 1024, DX_MAX_SMEM})
        for (int st = 4; st >= 2; --st) {
          const int w = st * DX_KT * DX_LD * 2;
          const int a = resident ? bm * (NS + 8) * 2 : (aligned ? st : 2) * bm * DX_LD * 2;
          const int ring = w + a + (aligned ? 0 : st * bm * DX_LD * 2);
          const int e = ln ? bm * (p.k_tiles * DX_KT + 4) * 4 + bm * 16 : bm * (DX_KT + 4) * 4;
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
template <int WM, bool LN>
__global__ void __launch_bounds__(64 * WM, LN ? 2 : 1) ln_linear_dx_kernel(
    const bf16* __restrict__ dy, Layout L, int dy_shift, Drop drop_in,
    const bf16* __restrict__ wt, bf16* __restrict__ dx, int M, int K, int NS, DxPlan P,
    // plain epilogue: fc1's pre-GELU activation and keep mask
    const bf16* __restrict__ pre, Drop drop_out,
    // LayerNorm epilogue
    const bf16* __restrict__ x, const bf16* __restrict__ pro_row,
    const float* __restrict__ gamma, const float* __restrict__ beta,
    const bf16* __restrict__ dres, bf16* __restrict__ ln_out, float* __restrict__ dgamma,
    float* __restrict__ dbeta, float* __restrict__ dbrow) {
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
  // a tile's fp32 products into Es (LayerNorm: into the d(ln) rows)
  auto keep_tile = [&](int kt) {
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
      if (kt + 1 < P.k_tiles) keep_tile(kt);
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
  keep_tile(P.k_tiles - 1);
  __syncthreads();  // every d(ln) row is in shared memory

  // LayerNorm backward. 1) each row's statistics, one warp per row, 4 rows
  // at a time (independent shuffle chains); the per-lane sums run in the
  // order of ln_linear.cu's registers
  constexpr int LN_ROWS = 4;
  float* stats = Es + BM * ELD;  // [BM][4]: mean, rstd, mean(dxh), mean(dxh xhat)
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
        const float dxh = Es[r * ELD + k] * gamma[k];
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
  // over the block's rows; d(gamma), d(beta) and the per-batch d(bias_row)
  // go out by fp32 atomics, one per column and block (and batch): their
  // order varies from run to run by one fp32 rounding of partial sums, far
  // below the bf16 results
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
        const float dl = Es[r * ELD + k];
        dg += dl * xhat;
        db += dl;
        if (ln_out != nullptr) ln_out[at] = __float2bfloat16_rn(xhat * gk + bk);
        float dz = stats[r * 4 + 1] * (dl * gk - stats[r * 4 + 2] - xhat * stats[r * 4 + 3]);
        if (dres != nullptr) dz += to_f(dres[at]);
        dr += dz;
        dx[at] = __float2bfloat16_rn(dz);
      }
      if (dbrow != nullptr) atomicAdd(dbrow + (size_t)b * K + k, dr);
      r0 = r1;
    }
    atomicAdd(dgamma + k, dg);
    atomicAdd(dbeta + k, db);
  }
}

template <int WM, bool LN>
int launch_dx(const DxPlan& P, cudaStream_t stream, const bf16* dy, Layout L, int dy_shift,
              Drop din, const bf16* wt, bf16* dx, int M, int K, int NS, const bf16* pre,
              Drop dout, const bf16* x, const bf16* pro_row, const float* gamma,
              const float* beta, const bf16* dres, bf16* ln_out, float* dgamma, float* dbeta,
              float* dbrow) {
  const cudaError_t err = cudaFuncSetAttribute(
      ln_linear_dx_kernel<WM, LN>, cudaFuncAttributeMaxDynamicSharedMemorySize, P.smem);
  if (err != cudaSuccess) return (int)err;
  const unsigned blocks = (unsigned)((M + 32 * WM - 1) / (32 * WM));
  ln_linear_dx_kernel<WM, LN><<<blocks, 64 * WM, P.smem, stream>>>(
      dy, L, dy_shift, din, wt, dx, M, K, NS, P, pre, dout, x, pro_row, gamma, beta, dres,
      ln_out, dgamma, dbeta, dbrow);
  return (int)cudaGetLastError();
}

constexpr int WR = 32, TLD = BN + 8;  // wgrad: rows per chunk, tile stride

__global__ void __launch_bounds__(THREADS) ln_linear_wgrad_kernel(
    const bf16* __restrict__ dy, Layout L, Drop drop, const bf16* __restrict__ a,
    float* __restrict__ dw_part, float* __restrict__ db_part, int K) {
  __shared__ __align__(16) bf16 Ts[WR * TLD];  // dY' rows x output rows n
  __shared__ __align__(16) bf16 Us[WR * TLD];  // A rows x columns k
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int warp_m = warp >> 1, warp_n = warp & 1;
  const int n0 = blockIdx.x * BN, k0 = blockIdx.y * BN, split = blockIdx.z;
  const int N = L.N, rows = L.rows_per_batch, first = split * rows;
  const int M = L.batches * rows;
  const bool with_db = db_part != nullptr && blockIdx.y == 0;

  float acc[2][4][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[mi][ni][j] = 0.f;
  float dbias = 0.f;

  // both operands' chunks, 32 rows x 64 columns in units of 4: gathered
  // into registers a chunk ahead, stored (dY' masked) at their chunk
  constexpr int UNITS = WR * (BN / 4) / THREADS;
  const uint16_t* abits = reinterpret_cast<const uint16_t*>(a);
  uint16_t raw_t[UNITS][4], raw_u[UNITS][4];
  auto gather = [&](int r0) {
#pragma unroll
    for (int i = 0; i < UNITS; ++i) {
      const int u = tid + i * THREADS, r = u / (BN / 4), c = (u % (BN / 4)) * 4;
      const bool valid = r0 + r < rows;
      const int row = first + r0 + r;
      gather_dy4(dy, L, valid ? M : 0, row, n0 + c, raw_t[i]);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        raw_u[i][j] = valid && k0 + c + j < K ? abits[(size_t)row * K + k0 + c + j] : 0;
    }
  };
  gather(0);

  for (int r0 = 0; r0 < rows; r0 += WR) {
#pragma unroll
    for (int i = 0; i < UNITS; ++i) {
      const int u = tid + i * THREADS, r = u / (BN / 4), c = (u % (BN / 4)) * 4;
      *reinterpret_cast<uint2*>(Ts + r * TLD + c) = finish_dy4(raw_t[i], drop, first + r0 + r,
                                                               n0 + c);
      *reinterpret_cast<uint2*>(Us + r * TLD + c) = make_uint2(
          raw_u[i][0] | ((uint32_t)raw_u[i][1] << 16), raw_u[i][2] | ((uint32_t)raw_u[i][3] << 16));
    }
    if (r0 + WR < rows) gather(r0 + WR);  // in flight during this chunk's products
    __syncthreads();
    if (with_db && tid < BN)
      for (int r = 0; r < WR; ++r) dbias += to_f(Ts[r * TLD + tid]);
#pragma unroll
    for (int ks = 0; ks < WR / 16; ++ks) {
      uint32_t af[2][4];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
        ldmatrix_x4_trans(af[mi], Ts + (ks * 16 + (lane >> 4) * 8 + (lane & 7)) * TLD +
                                      warp_m * 32 + mi * 16 + ((lane >> 3) & 1) * 8);
#pragma unroll
      for (int ni = 0; ni < 4; ni += 2) {
        uint32_t r[4];
        ldmatrix_x4_trans(r, Us + (ks * 16 + (lane & 15)) * TLD + warp_n * 32 + ni * 8 +
                                 (lane >> 4) * 8);
        const uint32_t b0[2] = {r[0], r[1]}, b1[2] = {r[2], r[3]};
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) {
          mma_16816(acc[mi][ni], af[mi], b0);
          mma_16816(acc[mi][ni + 1], af[mi], b1);
        }
      }
    }
    __syncthreads();
  }
  float* out = dw_part + (size_t)split * N * K;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int n = n0 + warp_m * 32 + mi * 16 + g + (j >> 1) * 8;
        const int k = k0 + warp_n * 32 + ni * 8 + 2 * t + (j & 1);
        if (n < N && k < K) out[(size_t)n * K + k] = acc[mi][ni][j];
      }
  if (with_db && tid < BN && n0 + tid < N) db_part[(size_t)split * N + n0 + tid] = dbias;
}

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
// threshold_out) and GELU'(pre). LayerNorm epilogue (x != null, K <= 640):
// dx receives dz = the LayerNorm backward of dX at z = x (+ pro_row), plus
// dres when not null; ln_out, when not null, the bf16 LayerNorm output;
// dgamma, dbeta (K) and dbrow (B, K), which the caller zeroes, get fp32
// sums added.
extern "C" int v1t_ln_linear_dx(const void* dy, void* dx, const void* wt, int M, int N, int K,
                                int NP, int rows_per_batch, int heads, int head_dim,
                                int head_pad, unsigned seed, unsigned site_in,
                                unsigned threshold_in, const void* pre, unsigned site_out,
                                unsigned threshold_out, float drop_scale, const void* x,
                                const void* pro_row, const void* gamma, const void* beta,
                                const void* dres, void* ln_out, void* dgamma, void* dbeta,
                                void* dbrow, void* stream) {
  const bool ln = x != nullptr;
  const uintptr_t addr = reinterpret_cast<uintptr_t>(dy);
  const int shift = (int)((addr & 15) >> 1);
  if (M < 1 || N < 1 || K < 1 || rows_per_batch < 1 || M % rows_per_batch != 0 ||
      (ln && K > MAX_LN_K) || (addr & 1))
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
    auto run = plan.bm == 128 ? &launch_dx<4, true> : &launch_dx<2, true>;
    return run(plan, s, dyb, L, sh, din, w, (bf16*)dx, M, K, NP, nullptr, dout, (const bf16*)x,
               (const bf16*)pro_row, (const float*)gamma, (const float*)beta,
               (const bf16*)dres, (bf16*)ln_out, (float*)dgamma, (float*)dbeta, (float*)dbrow);
  }
  auto run = plan.bm == 128 ? &launch_dx<4, false> : &launch_dx<2, false>;
  return run(plan, s, dyb, L, sh, din, w, (bf16*)dx, M, K, NP, (const bf16*)pre, dout, nullptr,
             nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr);
}

// Dynamic shared memory of the ln_linear_dx launch for a K-wide output and
// NP stored reduction columns, dY rows 16-byte aligned (aligned != 0) or
// not, with the LayerNorm epilogue (ln != 0) or not; 0 when none fits.
extern "C" int v1t_ln_linear_dx_smem(int K, int NP, int aligned, int ln) {
  return dx_plan(K, NP, aligned != 0, ln != 0).smem;
}

// Returns a CUDA error code (0 on success). dw_part (M / rows_per_batch, N,
// K) float32 receives each batch's dY'^T a, db_part (M / rows_per_batch, N)
// each batch's column sums of dY' (null: no bias). dy as for
// v1t_ln_linear_dx (threshold > 0: keep mask (seed, site)); a (M, K) bf16.
extern "C" int v1t_ln_linear_wgrad(const void* dy, const void* a, void* dw_part, void* db_part,
                                   int M, int N, int K, int rows_per_batch, int heads,
                                   int head_dim, int head_pad, unsigned seed, unsigned site,
                                   unsigned threshold, float drop_scale, void* stream) {
  if (M % rows_per_batch != 0) return (int)cudaErrorInvalidValue;
  const int batches = M / rows_per_batch;
  if (batches > 65535) return (int)cudaErrorInvalidValue;
  const Layout L{N, rows_per_batch, batches, heads, head_dim, head_pad};
  const Drop drop{seed, site, threshold, drop_scale};
  dim3 grid((N + BN - 1) / BN, (K + BN - 1) / BN, batches);
  ln_linear_wgrad_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      (const bf16*)dy, L, drop, (const bf16*)a, (float*)dw_part, (float*)db_part, K);
  return (int)cudaGetLastError();
}
