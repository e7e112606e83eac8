// attention: the attention core of the pre-LN sublayer,
//   o[b, q, h*D + d] = sum_k softmax_k(scale_h * q.k, masked) v[k, d],
// reading q, k, v in the head-major layout that ln_linear writes for it.
//
// Replaces the attention part of v1t_tpu/ops/fused_mha.py
// _mha_fwd_kernel_dt2 (:567) (and its dt/legacy orientations :278, :159,
// which compute the same function): per-head scale (learnable under LSA),
// key-pad mask, LSA diagonal mask, softmax in base 2 with log2(e) folded into
// the scale, head concat. The LayerNorm, QKV and output projections around it
// are ln_linear.cu. Dropout is training-only and is not in this forward.
//
// Bound on the H100: 4*B*H*N^2*D = 434 GFLOP per block at the flagship
// shapes (B 64, H 4, N 1654, D 155) against ~540 MB of q/k/v/o: ~800
// FLOP/byte, bound by tensor-core operations.
//
// Layout: qkv (3, B, H, N, DP) bf16, each head's rows zero-padded from D to
// DP (a multiple of 32: 155 -> 160), so that every row is 16-byte aligned;
// out (B, N, H*D) bf16, the row-major input of the output projection.
// One block of 8 warps per (q tile of 128 rows, head, batch); each warp owns
// 16 query rows and runs a flash-style online softmax over key tiles of 64.
// q stays in registers as mma.sync A fragments (rounded to bf16 after the
// scale, as the TPU kernel does). Key and value tiles stream through a
// double-buffered shared-memory ring with 16-byte cp.async copies, the next
// tile in flight while the current one is used; K is read as 32-bit pairs in
// the mma B layout, V through ldmatrix.trans. Scores, the running max and
// sum, and the 16 x DP output accumulator stay in registers (the C layout of
// mma is known, so rescaling needs no shared memory); the unnormalised
// probabilities are rounded to bf16 and reused in registers as the A operand
// of P.V. Rows are divided by their sum at the end.
// Not yet: wgmma, TMA, warp specialisation.
#include "common.cuh"

namespace {

constexpr int BQ = 128, BKV = 64, THREADS = 256;
constexpr float LOG2E = 1.4426950408889634f;
constexpr float MASKED = -1e30f;

template <int DP>
constexpr int smem_bytes() {
  return 2 /* K, V */ * 2 /* stages */ * BKV * (DP + 8) * (int)sizeof(bf16);
}

template <int DP>
__global__ void __launch_bounds__(THREADS, 1) attention_kernel(
    const bf16* __restrict__ qkv, const float* __restrict__ scale,
    bf16* __restrict__ out, int B, int N, int H, int D, int lsa) {
  constexpr int LD = DP + 8, CHUNKS = DP / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Ks = reinterpret_cast<bf16*>(smem_raw);  // [2][BKV][LD]
  bf16* Vs = Ks + 2 * BKV * LD;                  // [2][BKV][LD]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const size_t slab = (size_t)N * DP;
  const bf16* qg = qkv + ((size_t)b * H + h) * slab;
  const bf16* kg = qkv + ((size_t)(B + b) * H + h) * slab;
  const bf16* vg = qkv + ((size_t)(2 * B + b) * H + h) * slab;
  const float sc = scale[h] * LOG2E;

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
  load_tile(0, 0);

  // q fragments of this warp's 16 rows (columns past D masked to zero)
  const int r0 = qt * BQ + warp * 16 + g, r1 = r0 + 8;
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

  float o[DP / 8][4];
#pragma unroll
  for (int di = 0; di < DP / 8; ++di)
#pragma unroll
    for (int j = 0; j < 4; ++j) o[di][j] = 0.f;
  float m0 = MASKED, m1 = MASKED, l0 = 0.f, l1 = 0.f;

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

    // scores of 16 rows x 64 keys: 8 n-tiles of 8 keys
    float s[BKV / 8][4];
#pragma unroll
    for (int ni = 0; ni < BKV / 8; ++ni)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[ni][j] = 0.f;
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) {
#pragma unroll
      for (int ni = 0; ni < BKV / 8; ++ni) {
        const bf16* p = kt_s + (ni * 8 + g) * LD + kk * 16 + 2 * t;
        uint32_t bfrag[2] = {ld_pair(p), ld_pair(p + 8)};
        mma_16816(s[ni], qf[kk], bfrag);
      }
    }

    // masks, then the online softmax update of rows r0 (c0, c1), r1 (c2, c3)
    float mx0 = m0, mx1 = m1;
#pragma unroll
    for (int ni = 0; ni < BKV / 8; ++ni)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int key = kt * BKV + ni * 8 + 2 * t + (j & 1);
        const int row = (j >> 1) ? r1 : r0;
        if (key >= N || (lsa && key == row)) s[ni][j] = MASKED;
        if (j >> 1) mx1 = fmaxf(mx1, s[ni][j]);
        else mx0 = fmaxf(mx0, s[ni][j]);
      }
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
    const float a0 = exp2f(m0 - mx0), a1 = exp2f(m1 - mx1);
    m0 = mx0;
    m1 = mx1;
    l0 *= a0;
    l1 *= a1;
#pragma unroll
    for (int di = 0; di < DP / 8; ++di) {
      o[di][0] *= a0;
      o[di][1] *= a0;
      o[di][2] *= a1;
      o[di][3] *= a1;
    }
    uint32_t pf[BKV / 16][4];
#pragma unroll
    for (int ni = 0; ni < BKV / 8; ++ni) {
      const float p00 = exp2f(s[ni][0] - m0), p01 = exp2f(s[ni][1] - m0);
      const float p10 = exp2f(s[ni][2] - m1), p11 = exp2f(s[ni][3] - m1);
      l0 += p00 + p01;
      l1 += p10 + p11;
      // two adjacent 8-key C tiles form one 16-key A fragment
      pf[ni >> 1][(ni & 1) * 2 + 0] = pack_bf16(p00, p01);
      pf[ni >> 1][(ni & 1) * 2 + 1] = pack_bf16(p10, p11);
    }

    // o += P . V: per 16-key step, one ldmatrix.x4.trans feeds two d-tiles
#pragma unroll
    for (int ks = 0; ks < BKV / 16; ++ks) {
#pragma unroll
      for (int di = 0; di < DP / 8; di += 2) {
        uint32_t r[4];
        ldmatrix_x4_trans(r, vt_s + (ks * 16 + (lane & 15)) * LD + di * 8 + (lane >> 4) * 8);
        const uint32_t b0[2] = {r[0], r[1]}, b1[2] = {r[2], r[3]};
        mma_16816(o[di], pf[ks], b0);
        mma_16816(o[di + 1], pf[ks], b1);
      }
    }
    __syncthreads();  // every warp is done with this stage before it refills
  }

  // the four lanes of a quad hold partial sums of the same rows
  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  const float inv0 = l0 == 0.f ? 1.f : 1.f / l0;
  const float inv1 = l1 == 0.f ? 1.f : 1.f / l1;
  const int hd = H * D;
  bf16* ob = out + (size_t)b * N * hd + h * D;
#pragma unroll
  for (int di = 0; di < DP / 8; ++di)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int row = (j >> 1) ? r1 : r0;
      const int col = di * 8 + 2 * t + (j & 1);
      if (row < N && col < D)
        ob[(size_t)row * hd + col] =
            __float2bfloat16_rn(o[di][j] * ((j >> 1) ? inv1 : inv0));
    }
}

template <int DP>
int launch(const void* qkv, const void* scale, void* out, int B, int N, int H,
           int D, int lsa, cudaStream_t stream) {
  constexpr int bytes = smem_bytes<DP>();
  cudaError_t err = cudaFuncSetAttribute(
      attention_kernel<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((N + BQ - 1) / BQ, H, B);
  attention_kernel<DP><<<grid, THREADS, bytes, stream>>>(
      (const bf16*)qkv, (const float*)scale, (bf16*)out, B, N, H, D, lsa);
  return (int)cudaGetLastError();
}

}  // namespace

// Returns a CUDA error code (0 on success). DP is the padded head width:
// 32, 64, 96, 128 or 160, at least D.
extern "C" int v1t_attention(const void* qkv, const void* scale, void* out,
                             int B, int N, int H, int D, int DP, int lsa,
                             void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  switch (DP) {
    case 32: return launch<32>(qkv, scale, out, B, N, H, D, lsa, s);
    case 64: return launch<64>(qkv, scale, out, B, N, H, D, lsa, s);
    case 96: return launch<96>(qkv, scale, out, B, N, H, D, lsa, s);
    case 128: return launch<128>(qkv, scale, out, B, N, H, D, lsa, s);
    case 160: return launch<160>(qkv, scale, out, B, N, H, D, lsa, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
