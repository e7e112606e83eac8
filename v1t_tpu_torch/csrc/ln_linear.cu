// ln_linear: y = epilogue(prologue(x) @ w^T), the tiled product that carries
// every projection of the ViT block.
//
// Replaces the matrix products inside two TPU kernels:
//   v1t_tpu/ops/fused_mha.py _mha_fwd_kernel_dt2 (:567): +bias_row, LayerNorm
//     and the bias-free QKV projection; the output projection + bias +
//     residual (the attention core itself is attention.cu);
//   v1t_tpu/ops/fused_mlp.py _mlp_fwd_kernel (:111): LayerNorm -> fc1 + b1 ->
//     exact-erf GELU, and fc2 + b2 + residual.
// One launch per projection: QKV and fc1 take the LayerNorm prologue, the
// output projection and fc2 the residual epilogue.
//
// Bound on the H100: at the flagship shapes (M = 64 x 1654 rows) each
// projection moves 136..440 MB (x, w, residual read once, y written once) for
// 16..61 GFLOP, i.e. 100..150 FLOP/byte, under the card's bf16 ridge of ~295:
// every launch is bound by memory bytes. What the TPU kernel kept in VMEM
// (q/k/v, the 488-wide hidden layer) goes through device memory here; fusing
// it back is later work.
//
// Layout: x (M, K) row-major bf16; w (N, KP) row-major bf16, nn.Linear's
// layout (mma's "col" B operand) zero-padded by the wrapper from K to KP, a
// multiple of 32, so that its rows are 16-byte aligned. A block owns 64 rows
// of x for all N outputs: it reads its 64 x K panel once (scalar loads: rows
// of 155 bf16 are not aligned), adds the row bias, computes the LayerNorm of
// each row from registers (one warp per row, fp32, two passes over the
// registers) and keeps the normalised panel, rounded to bf16 where the TPU
// kernel rounded it, in shared memory. A K wider than one panel (KC = 640
// columns: the output projection of 8 heads, fc2 of a wide MLP; calls that
// carry no LayerNorm) is walked in panels of KC columns, each reloaded for
// every output tile (from L2). It then walks the output in 64-column
// tiles, streaming w through a double-buffered ring of 64 x 32 chunks with
// 16-byte cp.async copies; 4 warps (2 x 2, 32 x 32 each) run mma.sync
// m16n8k16 with fp32 accumulators. The epilogue adds the bias and applies the
// exact erf GELU in registers, rounds the tile to bf16 into shared memory
// (over the idle w ring), and a second pass, one row per warp instruction,
// adds the residual and writes y with neighbouring threads on neighbouring
// addresses. With heads > 0 the QKV output is written head-major and
// zero-padded for attention.cu.
// Training (TRAIN = true): the epilogue applies the dropout keep mask of
// the output (after bias and GELU, before the rounding and the residual: the
// out-projection's and fc2's output dropout, fc1's hidden dropout; element
// (0, row, col) of the site, common.cuh) and, for fc1, also writes the
// pre-GELU activation (bf16) that the backward's GELU' reads. The serving
// launches take TRAIN = false, the kernel as it was.
// Not yet: wgmma, TMA, a persistent schedule, vector stores, prefetching
// across output tiles.
#include "common.cuh"

namespace {

constexpr int BM = 64, BN = 64, BK = 32, WLD = BK + 8, YLD = BN + 8, THREADS = 128;
// KC: the widest panel of x a block holds (64 x KC bf16 in shared memory);
// the LayerNorm needs whole rows, so it takes K <= KC
constexpr int KC = 640, KREGS = KC / 32, MAX_LN_K = KC;
static_assert(BM * YLD <= 2 * BN * WLD, "the output tile must fit in the w ring");

__host__ __device__ constexpr int smem_bytes(int KP) {
  return (BM * (KP + 8) + 2 * BN * WLD) * (int)sizeof(bf16) +
         (BM + BN) * (int)sizeof(size_t) + (BM + BN) * (int)sizeof(int);
}

__device__ __forceinline__ float load_z(const bf16* xr, const bf16* br, int k) {
  float z = to_f(xr[k]);
  // (x + bias_row) is a bf16 add in the reference kernel: round once
  if (br != nullptr) z = round_bf16(z + to_f(br[k]));
  return z;
}

// MULTI: K spans several panels (KP > KC); a single panel compiles as
// without the panel walk
template <bool TRAIN, bool MULTI>
__global__ void __launch_bounds__(THREADS) ln_linear_kernel(
    const bf16* __restrict__ x, const bf16* __restrict__ w,
    const float* __restrict__ gamma, const float* __restrict__ beta,
    const bf16* __restrict__ pro_row, const float* __restrict__ bias,
    const bf16* __restrict__ residual, const bf16* __restrict__ res_row,
    bf16* __restrict__ y, bf16* __restrict__ pre, int M, int N, int K, int KP,
    int rows_per_batch, int gelu, int heads, int head_dim, int head_pad, Drop drop) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int PW = MULTI ? KC : KP, ALD = PW + 8, npc = PW / BK;  // panel width, chunks per panel
  bf16* As = reinterpret_cast<bf16*>(smem_raw);  // [BM][ALD]
  bf16* Ws = As + BM * ALD;                      // [2][BN][WLD]
  bf16* Ys = Ws;                                 // [BM][YLD], over the w ring
  size_t* row_off_s = reinterpret_cast<size_t*>(Ws + 2 * BN * WLD);  // [BM]
  size_t* col_off_s = row_off_s + BM;                                 // [BN]
  int* row_b_s = reinterpret_cast<int*>(col_off_s + BN);              // [BM]
  int* col_last_s = row_b_s + BM;                                     // [BN]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int warp_m = warp >> 1, warp_n = warp & 1;
  const int m0 = blockIdx.x * BM;
  const int nk = KP / BK, n_tiles = (N + BN - 1) / BN, steps = n_tiles * nk;

  auto load_w = [&](int step, int stage) {
    const int nt = step / nk, kc = step % nk;
    bf16* dst = Ws + stage * BN * WLD;
    for (int i = tid; i < BN * (BK / 8); i += THREADS) {
      const int r = i / (BK / 8), c = (i % (BK / 8)) * 8, n = nt * BN + r;
      const bool valid = n < N;
      cp_async16(dst + r * WLD + c, w + (valid ? (size_t)n * KP + kc * BK + c : 0), valid);
    }
    cp_async_commit();
  };
  load_w(0, 0);  // in flight while the panel is built

  // the block's 64 rows, columns k0 .. k0 + PW - 1: (+ row bias), LayerNorm
  // (a single panel), bf16, into shared memory
  auto build_panel = [&](int k0) {
    for (int r = warp; r < BM; r += THREADS / 32) {
      const int row = m0 + r;
      float v[KREGS];
      if (row < M) {
        const bf16* xr = x + (size_t)row * K;
        const bf16* br = pro_row ? pro_row + (size_t)(row / rows_per_batch) * K : nullptr;
        float s = 0.f;
#pragma unroll
        for (int i = 0; i < KREGS; ++i) {
          const int k = k0 + lane + 32 * i;
          v[i] = k < K ? load_z(xr, br, k) : 0.f;
          s += v[i];
        }
        if (gamma != nullptr) {
          const float mean = warp_sum(s) / K;
          float var = 0.f;
#pragma unroll
          for (int i = 0; i < KREGS; ++i) {
            const float d = lane + 32 * i < K ? v[i] - mean : 0.f;
            var += d * d;
          }
          const float rstd = rsqrtf(warp_sum(var) / K + 1e-5f);
#pragma unroll
          for (int i = 0; i < KREGS; ++i) {
            const int k = lane + 32 * i;
            if (k < K) v[i] = (v[i] - mean) * rstd * gamma[k] + beta[k];
          }
        }
      } else {
#pragma unroll
        for (int i = 0; i < KREGS; ++i) v[i] = 0.f;
      }
#pragma unroll
      for (int i = 0; i < KREGS; ++i) {
        const int kl = lane + 32 * i;
        if (kl < PW) As[r * ALD + kl] = __float2bfloat16_rn(v[i]);
      }
    }
  };
  build_panel(0);

  // per-row output offsets (row-major, or head-major (S, B, H, rows, DP):
  // a row part fixed for the block plus a column part per tile)
  const int batches = M / rows_per_batch;
  if (tid < BM) {
    const int row = min(m0 + tid, M - 1);
    const int b = row / rows_per_batch, n = row % rows_per_batch;
    row_off_s[tid] = heads ? ((size_t)b * heads * rows_per_batch + n) * head_pad : (size_t)row * N;
    row_b_s[tid] = b;
  }

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
    if (issued == step) {  // the first chunk of a tile: the epilogue used the ring
      load_w(step, stage);
      ++issued;
    }
    // a K of several panels: the next panel (every warp is past the last
    // step's products, which read the previous one)
    if (MULTI && kc % npc == 0 && step != 0) build_panel(kc / npc * KC);
    if (kc + 1 < nk) {  // prefetch within the tile
      load_w(step + 1, stage ^ 1);
      ++issued;
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // the chunk has landed (and, at step 0, the panel)
    const bf16* wt = Ws + stage * BN * WLD;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      uint32_t a[2][4], bfr[4][2];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        const int kcol = (MULTI ? kc % npc : kc) * BK;
        const bf16* p = As + (warp_m * 32 + mi * 16 + g) * ALD + kcol + kk + 2 * t;
        a[mi][0] = ld_pair(p);
        a[mi][1] = ld_pair(p + 8 * ALD);
        a[mi][2] = ld_pair(p + 8);
        a[mi][3] = ld_pair(p + 8 * ALD + 8);
      }
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const bf16* p = wt + (warp_n * 32 + ni * 8 + g) * WLD + kk + 2 * t;
        bfr[ni][0] = ld_pair(p);
        bfr[ni][1] = ld_pair(p + 8);
      }
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) mma_16816(acc[mi][ni], a[mi], bfr[ni]);
    }
    __syncthreads();  // every warp is done with this stage before it refills
    if (kc != nk - 1) continue;

    // epilogue of output tile nt. 1) bias and GELU in registers, the bf16
    // tile into shared memory (the idle w ring); 2) a coalesced pass adds the
    // residual and writes y row by row.
    const int n0 = nt * BN;
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int ni = 0; ni < 4; ++ni)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int r = warp_m * 32 + mi * 16 + g + half * 8;
          const int c = warp_n * 32 + ni * 8 + 2 * t;
          float v[2];
#pragma unroll
          for (int jc = 0; jc < 2; ++jc) {
            const int col = n0 + c + jc;
            v[jc] = acc[mi][ni][half * 2 + jc] + (bias != nullptr && col < N ? bias[col] : 0.f);
            if (TRAIN && pre != nullptr && m0 + r < M && col < N)
              pre[(size_t)(m0 + r) * N + col] = __float2bfloat16_rn(v[jc]);
            if (gelu) v[jc] = 0.5f * v[jc] * (1.f + erff(v[jc] * 0.70710678118654752f));
          }
          if (TRAIN && drop.on()) {
            // one Philox per pair: (c, c + 1) lie in one group of 4 columns
            const uint4 w = keep_words(drop, 0u, (uint32_t)(m0 + r), (uint32_t)(n0 + c) >> 2);
            const int j = (n0 + c) & 3;
#pragma unroll
            for (int jc = 0; jc < 2; ++jc)
              v[jc] = word_of(w, j + jc) < drop.threshold ? v[jc] * drop.scale : 0.f;
          }
          *reinterpret_cast<uint32_t*>(Ys + r * YLD + c) = pack_bf16(v[0], v[1]);
        }
    if (tid < BN) {
      const int col = min(n0 + tid, N - 1);
      size_t off = col;
      int last = 0;
      if (heads) {
        const int hd = heads * head_dim, sidx = col / hd, rem = col % hd;
        const int h = rem / head_dim, d = rem % head_dim;
        off = (((size_t)sidx * batches * heads + h) * rows_per_batch) * head_pad + d;
        last = d == head_dim - 1;
      }
      col_off_s[tid] = off;
      col_last_s[tid] = last;
    }
    __syncthreads();
    for (int i = tid; i < BM * BN; i += THREADS) {
      const int r = i / BN, c = i % BN, row = m0 + r, col = n0 + c;
      if (row >= M || col >= N) continue;
      float v = to_f(Ys[r * YLD + c]);
      if (residual != nullptr) {
        float z = to_f(residual[(size_t)row * N + col]);
        if (res_row != nullptr) z = round_bf16(z + to_f(res_row[(size_t)row_b_s[r] * N + col]));
        v += z;
      }
      bf16* dst = y + row_off_s[r] + col_off_s[c];
      *dst = __float2bfloat16_rn(v);
      // the thread that writes a head's last column zeroes its padding
      if (col_last_s[c])
        for (int z = 1; z < head_pad - head_dim + 1; ++z) dst[z] = __float2bfloat16_rn(0.f);
    }
    __syncthreads();  // the ring is free again for the next tile's chunks
  }
}

template <bool TRAIN, bool MULTI>
int launch(const void* x, const void* w, const void* gamma, const void* beta,
           const void* pro_row, const void* bias, const void* residual,
           const void* res_row, void* y, void* pre, int M, int N, int K, int KP,
           int rows_per_batch, int gelu, int heads, int head_dim, int head_pad,
           Drop drop, cudaStream_t stream) {
  const int bytes = smem_bytes(MULTI ? KC : KP);
  cudaError_t err = cudaFuncSetAttribute(
      ln_linear_kernel<TRAIN, MULTI>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  ln_linear_kernel<TRAIN, MULTI><<<(M + BM - 1) / BM, THREADS, bytes, stream>>>(
      (const bf16*)x, (const bf16*)w, (const float*)gamma, (const float*)beta,
      (const bf16*)pro_row, (const float*)bias, (const bf16*)residual,
      (const bf16*)res_row, (bf16*)y, (bf16*)pre, M, N, K, KP, rows_per_batch, gelu,
      heads, head_dim, head_pad, drop);
  return (int)cudaGetLastError();
}

typedef int (*LaunchFn)(const void*, const void*, const void*, const void*, const void*,
                        const void*, const void*, const void*, void*, void*, int, int, int,
                        int, int, int, int, int, int, Drop, cudaStream_t);

}  // namespace

// Returns a CUDA error code (0 on success). w is (N, KP), zero-padded from K
// to KP = a multiple of 32; K <= 640 with the LayerNorm. Null pointers
// switch off the LayerNorm (gamma/beta), the row bias before it (pro_row),
// the output bias, the
// residual and the row bias added to the residual (res_row). heads > 0
// writes y head-major for attention.cu: (N / (heads*head_dim), B, heads,
// rows_per_batch, head_pad), zero-padded past head_dim. Training: pre, when
// not null, receives the (M, N) activation before the GELU; threshold > 0
// applies the keep mask of (seed, site) to the output (ops/dropout.py),
// scaling kept elements by drop_scale.
extern "C" int v1t_ln_linear(const void* x, const void* w, const void* gamma,
                             const void* beta, const void* pro_row,
                             const void* bias, const void* residual,
                             const void* res_row, void* y, void* pre, int M, int N,
                             int K, int KP, int rows_per_batch, int gelu, int heads,
                             int head_dim, int head_pad, unsigned seed, unsigned site,
                             unsigned threshold, float drop_scale, void* stream) {
  if (KP % BK != 0 || KP < K || (gamma != nullptr && K > MAX_LN_K))
    return (int)cudaErrorInvalidValue;
  const Drop drop{seed, site, threshold, drop_scale};
  cudaStream_t s = (cudaStream_t)stream;
  const bool train = pre != nullptr || threshold != 0u, multi = KP > KC;
  const LaunchFn fn = train ? (multi ? launch<true, true> : launch<true, false>)
                            : (multi ? launch<false, true> : launch<false, false>);
  return fn(x, w, gamma, beta, pro_row, bias, residual, res_row, y, pre, M, N, K, KP,
            rows_per_batch, gelu, heads, head_dim, head_pad, drop, s);
}
