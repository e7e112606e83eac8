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
//    The tiled product is ln_linear.cu's: a block owns 64 rows and walks 64-
//    column output tiles, W^T (K, NP) streaming through a double-buffered
//    cp.async ring, 4 warps of mma.sync m16n8k16; dY' chunks are gathered
//    into registers a step ahead (rows of 155 bf16 are not 16-byte aligned;
//    the loads are in flight while the current chunk multiplies), then
//    masked and stored into shared memory. Epilogues:
//    - plain: dX in bf16; optionally fc1's keep mask and GELU'(pre) on the
//      way (the fc2 backward emits fc1's dY' directly, from the saved
//      pre-GELU activation);
//    - LayerNorm (K <= 640, ln_linear.cu's limit): the block keeps its
//      64 x K fp32 d(ln) rows in shared memory; one warp per row first
//      recomputes z = x (+ row), its mean and rstd as ln_linear.cu did, and
//      the row sums mean(d(ln) gamma) and mean(d(ln) gamma xhat), into shared
//      memory; then, 256 columns at a time, it writes dz = rstd (d(ln) gamma
//      - mean(.) - xhat mean(. xhat)) (+ the residual's cotangent), the
//      recomputed bf16 LayerNorm output for the weight gradient, and adds
//      d(gamma), d(beta) and the per-batch d(bias_row) row sums with fp32
//      atomics (one per column per warp and chunk; their order varies from
//      run to run by one fp32 rounding of partial sums, far below the bf16
//      results).
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
// Not yet: wgmma, TMA, vectorised dY' gathers, the two halves in one pass.
#include "common.cuh"

namespace {

constexpr int BM = 64, BN = 64, BK = 32, WLD = BK + 8, ALD = BK + 8, YLD = BN + 8;
// the LayerNorm backward takes K <= MAX_LN_K (its 64 x K fp32 d(ln) rows in
// shared memory) and walks the columns LN_REGS * 32 at a time
constexpr int THREADS = 128, MAX_LN_K = 640, LN_REGS = 8;
static_assert(BM * YLD <= 2 * BN * WLD, "the output tile must fit in the w ring");

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

__host__ __device__ constexpr int dx_smem_bytes(int ln_cols) {
  // the w ring, the dY' chunk; LayerNorm: d(ln) rows and 4 statistics a row
  return (2 * BN * WLD + BM * ALD) * (int)sizeof(bf16) +
         (ln_cols ? (BM * (ln_cols + 4) + 4 * BM) * (int)sizeof(float) : 0);
}

template <bool LN>
__global__ void __launch_bounds__(THREADS) ln_linear_dx_kernel(
    const bf16* __restrict__ dy, Layout L, Drop drop_in, const bf16* __restrict__ wt,
    bf16* __restrict__ dx, int M, int K, int NP,
    // plain epilogue: fc1's pre-GELU activation and keep mask
    const bf16* __restrict__ pre, Drop drop_out,
    // LayerNorm epilogue
    const bf16* __restrict__ x, const bf16* __restrict__ pro_row,
    const float* __restrict__ gamma, const float* __restrict__ beta,
    const bf16* __restrict__ dres, bf16* __restrict__ ln_out, float* __restrict__ dgamma,
    float* __restrict__ dbeta, float* __restrict__ dbrow) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Ws = reinterpret_cast<bf16*>(smem_raw);  // [2][BN][WLD]
  bf16* As = Ws + 2 * BN * WLD;                  // [BM][ALD]
  bf16* Ys = Ws;                                 // [BM][YLD], over the w ring
  float* Ds = reinterpret_cast<float*>(As + BM * ALD);  // LN: [BM][DLD]
  const int n_tiles = (K + BN - 1) / BN, DLD = n_tiles * BN + 4;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int warp_m = warp >> 1, warp_n = warp & 1;
  const int m0 = blockIdx.x * BM;
  const int nk = NP / BK, steps = n_tiles * nk;

  auto load_w = [&](int step, int stage) {
    const int nt = step / nk, kc = step % nk;
    bf16* dst = Ws + stage * BN * WLD;
    for (int i = tid; i < BN * (BK / 8); i += THREADS) {
      const int r = i / (BK / 8), c = (i % (BK / 8)) * 8, n = nt * BN + r;
      const bool valid = n < K;
      cp_async16(dst + r * WLD + c, wt + (valid ? (size_t)n * NP + kc * BK + c : 0), valid);
    }
    cp_async_commit();
  };
  load_w(0, 0);

  // each step's dY' chunk, 64 rows x 32 reduction columns in units of 4:
  // gathered into registers a step ahead, masked and stored at its step
  constexpr int UNITS = BM * (BK / 4) / THREADS;
  uint16_t raw[UNITS][4];
  auto gather = [&](int step) {
    const int kc = step % nk;
#pragma unroll
    for (int i = 0; i < UNITS; ++i) {
      const int u = tid + i * THREADS, r = u / (BK / 4), c = (u % (BK / 4)) * 4;
      gather_dy4(dy, L, M, m0 + r, kc * BK + c, raw[i]);
    }
  };
  gather(0);

  float acc[2][4][4];
  int issued = 1;
  for (int step = 0; step < steps; ++step) {
    const int stage = step & 1, nt = step / nk, kc = step % nk;
    if (kc == 0) {
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[mi][ni][j] = 0.f;
    }
    if (issued == step) {
      load_w(step, stage);
      ++issued;
    }
    if (kc + 1 < nk) {
      load_w(step + 1, stage ^ 1);
      ++issued;
    }
#pragma unroll
    for (int i = 0; i < UNITS; ++i) {
      const int u = tid + i * THREADS, r = u / (BK / 4), c = (u % (BK / 4)) * 4;
      *reinterpret_cast<uint2*>(As + r * ALD + c) = finish_dy4(raw[i], drop_in, m0 + r, kc * BK + c);
    }
    if (step + 1 < steps) gather(step + 1);  // in flight during this step's products
    if (kc + 1 < nk) cp_async_wait<1>();
    else cp_async_wait<0>();
    __syncthreads();
    const bf16* wtile = Ws + stage * BN * WLD;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      uint32_t a[2][4], bfr[4][2];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        const bf16* p = As + (warp_m * 32 + mi * 16 + g) * ALD + kk + 2 * t;
        a[mi][0] = ld_pair(p);
        a[mi][1] = ld_pair(p + 8 * ALD);
        a[mi][2] = ld_pair(p + 8);
        a[mi][3] = ld_pair(p + 8 * ALD + 8);
      }
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const bf16* p = wtile + (warp_n * 32 + ni * 8 + g) * WLD + kk + 2 * t;
        bfr[ni][0] = ld_pair(p);
        bfr[ni][1] = ld_pair(p + 8);
      }
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) mma_16816(acc[mi][ni], a[mi], bfr[ni]);
    }
    __syncthreads();  // every warp is done with As and this w stage
    if (kc != nk - 1) continue;

    const int n0 = nt * BN;
    if (LN) {  // keep the fp32 d(ln) tile for the row pass
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int r = warp_m * 32 + mi * 16 + g + (j >> 1) * 8;
            const int c = n0 + warp_n * 32 + ni * 8 + 2 * t + (j & 1);
            Ds[r * DLD + c] = acc[mi][ni][j];
          }
      continue;
    }
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int ni = 0; ni < 4; ++ni)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int r = warp_m * 32 + mi * 16 + g + half * 8, row = m0 + r;
          const int c = warp_n * 32 + ni * 8 + 2 * t;
          float v[2] = {acc[mi][ni][half * 2], acc[mi][ni][half * 2 + 1]};
          if (pre != nullptr && row < M) {
            uint4 w = make_uint4(0u, 0u, 0u, 0u);
            if (drop_out.on()) w = keep_words(drop_out, 0u, (uint32_t)row, (uint32_t)(n0 + c) >> 2);
#pragma unroll
            for (int jc = 0; jc < 2; ++jc) {
              const int col = n0 + c + jc;
              if (col >= K) continue;
              if (drop_out.on())
                v[jc] = word_of(w, (col & 3)) < drop_out.threshold ? v[jc] * drop_out.scale : 0.f;
              v[jc] *= gelu_grad(to_f(pre[(size_t)row * K + col]));
            }
          }
          *reinterpret_cast<uint32_t*>(Ys + r * YLD + c) = pack_bf16(v[0], v[1]);
        }
    __syncthreads();
    for (int i = tid; i < BM * BN; i += THREADS) {
      const int r = i / BN, c = i % BN, row = m0 + r, col = n0 + c;
      if (row < M && col < K) dx[(size_t)row * K + col] = Ys[r * YLD + c];
    }
    __syncthreads();  // the ring is free again for the next tile's chunks
  }
  if (!LN) return;

  __syncthreads();
  // LayerNorm backward, one warp per row. 1) each row's statistics; the
  // per-lane sums run in the order of ln_linear.cu's registers
  float* stats = Ds + BM * DLD;  // [BM][4]: mean, rstd, mean(dxh), mean(dxh xhat)
  auto z_at = [&](const bf16* xr, const bf16* br, int k) {
    float z = to_f(xr[k]);
    if (br != nullptr) z = round_bf16(z + to_f(br[k]));
    return z;
  };
  for (int r = warp; r < BM; r += THREADS / 32) {
    const int row = m0 + r;
    if (row >= M) break;
    const bf16* xr = x + (size_t)row * K;
    const bf16* br = pro_row ? pro_row + (size_t)(row / L.rows_per_batch) * K : nullptr;
    float s = 0.f;
    for (int k = lane; k < K; k += 32) s += z_at(xr, br, k);
    const float mean = warp_sum(s) / K;
    float var = 0.f;
    for (int k = lane; k < K; k += 32) {
      const float d = z_at(xr, br, k) - mean;
      var += d * d;
    }
    const float rstd = rsqrtf(warp_sum(var) / K + 1e-5f);
    float s1 = 0.f, s2 = 0.f;
    for (int k = lane; k < K; k += 32) {
      const float dxh = Ds[r * DLD + k] * gamma[k];
      s1 += dxh;
      s2 += dxh * ((z_at(xr, br, k) - mean) * rstd);
    }
    s1 = warp_sum(s1) / K;
    s2 = warp_sum(s2) / K;
    if (lane == 0) {
      stats[r * 4 + 0] = mean;
      stats[r * 4 + 1] = rstd;
      stats[r * 4 + 2] = s1;
      stats[r * 4 + 3] = s2;
    }
  }
  __syncwarp();
  // 2) dz, the LayerNorm output and the column sums, LN_REGS * 32 columns at
  // a time; per-lane column sums for the atomics
  for (int c0 = 0; c0 < K; c0 += LN_REGS * 32) {
    float dg[LN_REGS], db[LN_REGS], dr[LN_REGS];
#pragma unroll
    for (int i = 0; i < LN_REGS; ++i) dg[i] = db[i] = dr[i] = 0.f;
    int cur_b = -1;
    auto flush_row_sums = [&]() {
      if (cur_b < 0 || dbrow == nullptr) return;
#pragma unroll
      for (int i = 0; i < LN_REGS; ++i) {
        const int k = c0 + lane + 32 * i;
        if (k < K) atomicAdd(dbrow + (size_t)cur_b * K + k, dr[i]);
        dr[i] = 0.f;
      }
    };
    for (int r = warp; r < BM; r += THREADS / 32) {
      const int row = m0 + r;
      if (row >= M) break;
      const int b = row / L.rows_per_batch;
      if (b != cur_b) {
        flush_row_sums();
        cur_b = b;
      }
      const bf16* xr = x + (size_t)row * K;
      const bf16* br = pro_row ? pro_row + (size_t)b * K : nullptr;
      const float mean = stats[r * 4 + 0], rstd = stats[r * 4 + 1];
      const float s1 = stats[r * 4 + 2], s2 = stats[r * 4 + 3];
#pragma unroll
      for (int i = 0; i < LN_REGS; ++i) {
        const int k = c0 + lane + 32 * i;
        if (k >= K) continue;
        const float xhat = (z_at(xr, br, k) - mean) * rstd;
        const float dl = Ds[r * DLD + k];
        dg[i] += dl * xhat;
        db[i] += dl;
        if (ln_out != nullptr)
          ln_out[(size_t)row * K + k] = __float2bfloat16_rn(xhat * gamma[k] + beta[k]);
        float dz = rstd * (dl * gamma[k] - s1 - xhat * s2);
        if (dres != nullptr) dz += to_f(dres[(size_t)row * K + k]);
        dr[i] += dz;
        dx[(size_t)row * K + k] = __float2bfloat16_rn(dz);
      }
    }
    flush_row_sums();
#pragma unroll
    for (int i = 0; i < LN_REGS; ++i) {
      const int k = c0 + lane + 32 * i;
      if (k < K) {
        atomicAdd(dgamma + k, dg[i]);
        atomicAdd(dbeta + k, db[i]);
      }
    }
  }
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

// Returns a CUDA error code (0 on success). dX = mask(dy) W for dy (M, N)
// (row-major when heads == 0, else head-major as ln_linear writes q/k/v)
// and wt = W^T (K, NP) bf16, zero-padded from N to NP, a multiple of 32.
// threshold_in > 0 applies the keep mask (seed, site_in) to dy. Plain
// epilogue (x == null): dx (M, K) bf16, with pre (M, K) set also fc1's keep
// mask (seed, site_out, threshold_out) and GELU'(pre). LayerNorm epilogue
// (x != null, K <= 640): dx receives dz = the LayerNorm backward of dX at
// z = x (+ pro_row), plus dres when not null; ln_out, when not null, the
// bf16 LayerNorm output; dgamma, dbeta (K) and dbrow (B, K), which the
// caller zeroes, get fp32 sums added.
extern "C" int v1t_ln_linear_dx(const void* dy, void* dx, const void* wt, int M, int N, int K,
                                int NP, int rows_per_batch, int heads, int head_dim,
                                int head_pad, unsigned seed, unsigned site_in,
                                unsigned threshold_in, const void* pre, unsigned site_out,
                                unsigned threshold_out, float drop_scale, const void* x,
                                const void* pro_row, const void* gamma, const void* beta,
                                const void* dres, void* ln_out, void* dgamma, void* dbeta,
                                void* dbrow, void* stream) {
  if (NP % BK != 0 || NP < N || M % rows_per_batch != 0) return (int)cudaErrorInvalidValue;
  const bool ln = x != nullptr;
  if (ln && K > MAX_LN_K) return (int)cudaErrorInvalidValue;
  const Layout L{N, rows_per_batch, M / rows_per_batch, heads, head_dim, head_pad};
  const Drop din{seed, site_in, threshold_in, drop_scale};
  const Drop dout{seed, site_out, threshold_out, drop_scale};
  const int n_tiles = (K + BN - 1) / BN;
  const int bytes = dx_smem_bytes(ln ? n_tiles * BN : 0);
  cudaStream_t s = (cudaStream_t)stream;
  const unsigned blocks = (unsigned)((M + BM - 1) / BM);
  cudaError_t err;
  if (ln) {
    err = cudaFuncSetAttribute(ln_linear_dx_kernel<true>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return (int)err;
    ln_linear_dx_kernel<true><<<blocks, THREADS, bytes, s>>>(
        (const bf16*)dy, L, din, (const bf16*)wt, (bf16*)dx, M, K, NP, nullptr, dout,
        (const bf16*)x, (const bf16*)pro_row, (const float*)gamma, (const float*)beta,
        (const bf16*)dres, (bf16*)ln_out, (float*)dgamma, (float*)dbeta, (float*)dbrow);
  } else {
    err = cudaFuncSetAttribute(ln_linear_dx_kernel<false>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return (int)err;
    ln_linear_dx_kernel<false><<<blocks, THREADS, bytes, s>>>(
        (const bf16*)dy, L, din, (const bf16*)wt, (bf16*)dx, M, K, NP, (const bf16*)pre, dout,
        nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr);
  }
  return (int)cudaGetLastError();
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
