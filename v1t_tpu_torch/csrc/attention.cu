// attention: the attention core of the pre-LN sublayer,
//   o[b, q, h*D + d] = sum_k softmax_k(scale_h * q.k, masked) v[k, d],
// reading q, k, v in the head-major layout that ln_linear writes for it.
//
// Replaces the attention part of v1t_tpu/ops/fused_mha.py
// _mha_fwd_kernel_dt2 (:567) (and its dt/legacy orientations :278, :159,
// which compute the same function): per-head scale (learnable under LSA),
// key-pad mask, LSA diagonal mask, softmax in base 2 with log2(e) folded into
// the scale, head concat. The LayerNorm, QKV and output projections around it
// are ln_linear.cu. The training variant (TRAIN = true) also drops
// probabilities as the TPU kernel does (:619-621): the row sum l is taken
// before the keep mask, the kept unnormalised probabilities feed P.V and the
// 1/keep scale folds into 1/l; and it writes each row's log2-domain
// log-sum-exp, m + log2(l) (:641-645), which attention_bwd.cu recomputes P
// from. Mask element (b * H + h, query, key) of the site (common.cuh).
//
// Bound on the H100: 4*B*H*N^2*D = 434 GFLOP per block at the flagship
// shapes (B 64, H 4, N 1654, D 155) against ~540 MB of q/k/v/o: ~800
// FLOP/byte, bound by tensor-core operations.
//
// Layout: qkv (3, B, H, N, DP) bf16, each head's rows zero-padded from D to
// DP (a multiple of 32: 155 -> 160), so that every row is 16-byte aligned;
// out (B, N, H*D) bf16, the row-major input of the output projection.
// One block of 8 warps per (q tile of 128 rows, head, batch) runs the
// online-softmax tile loop of attention_tile.cuh (shared with
// flash_attention.cu), with q in registers as mma.sync A fragments (rounded
// to bf16 after the scale, as the TPU kernel does). Rows are divided by
// their sum at the end.
// Not yet: wgmma, TMA, warp specialisation.
#include "attention_tile.cuh"

namespace {

using attn_tile::BQ;
using attn_tile::THREADS;
constexpr float LOG2E = 1.4426950408889634f;

template <int DP, bool TRAIN>
__global__ void __launch_bounds__(THREADS, 1) attention_kernel(
    const bf16* __restrict__ qkv, const float* __restrict__ scale,
    bf16* __restrict__ out, float* __restrict__ lse, int B, int N, int H, int D, int lsa,
    Drop drop) {
  constexpr int LD = DP + 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Ks = reinterpret_cast<bf16*>(smem_raw);  // [2][BKV][LD]
  bf16* Vs = Ks + 2 * attn_tile::BKV * LD;       // [2][BKV][LD]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const size_t slab = (size_t)N * DP;
  const bf16* qg = qkv + ((size_t)b * H + h) * slab;
  const bf16* kg = qkv + ((size_t)(B + b) * H + h) * slab;
  const bf16* vg = qkv + ((size_t)(2 * B + b) * H + h) * slab;
  const float sc = scale[h] * LOG2E;

  attn_tile::load_kv_tile<DP>(kg, vg, N, 0, 0, Ks, Vs);

  // q fragments of this warp's 16 rows (columns past D masked to zero)
  const int row0 = qt * BQ + warp * 16;
  const int r0 = row0 + g, r1 = r0 + 8;
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

  float o[DP / 8][4], m0, m1, l0, l1;
  attn_tile::softmax_pv<DP, TRAIN, false>(
      [&](int kk, uint32_t a[4]) {
#pragma unroll
        for (int j = 0; j < 4; ++j) a[j] = qf[kk][j];
      },
      kg, vg, N, N, row0, lsa, drop, (uint32_t)(b * H + h), Ks, Vs, o, m0, m1, l0, l1);

  float inv0 = l0 == 0.f ? 1.f : 1.f / l0;
  float inv1 = l1 == 0.f ? 1.f : 1.f / l1;
  if (TRAIN) {
    if (drop.on()) {
      inv0 *= drop.scale;
      inv1 *= drop.scale;
    }
    float* lrow = lse + ((size_t)b * H + h) * N;
    if (t == 0 && r0 < N) lrow[r0] = m0 + log2f(fmaxf(l0, 1e-37f));
    if (t == 0 && r1 < N) lrow[r1] = m1 + log2f(fmaxf(l1, 1e-37f));
  }
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

template <int DP, bool TRAIN>
int launch(const void* qkv, const void* scale, void* out, void* lse, int B, int N, int H,
           int D, int lsa, Drop drop, cudaStream_t stream) {
  constexpr int bytes = attn_tile::kv_smem_bytes<DP>();
  cudaError_t err = cudaFuncSetAttribute(
      attention_kernel<DP, TRAIN>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((N + BQ - 1) / BQ, H, B);
  attention_kernel<DP, TRAIN><<<grid, THREADS, bytes, stream>>>(
      (const bf16*)qkv, (const float*)scale, (bf16*)out, (float*)lse, B, N, H, D, lsa, drop);
  return (int)cudaGetLastError();
}

template <int DP>
int launch_dp(const void* qkv, const void* scale, void* out, void* lse, int B, int N, int H,
              int D, int lsa, Drop drop, cudaStream_t stream) {
  if (lse != nullptr)
    return launch<DP, true>(qkv, scale, out, lse, B, N, H, D, lsa, drop, stream);
  return launch<DP, false>(qkv, scale, out, lse, B, N, H, D, lsa, drop, stream);
}

}  // namespace

// Returns a CUDA error code (0 on success). DP is the padded head width:
// 32, 64, 96, 128 or 160, at least D. Training: lse, when not null,
// receives the (B, H, N) float32 log2-domain log-sum-exp of every row and
// selects the training kernel, which applies the keep mask of (seed, site)
// to the probabilities when threshold > 0 (scaling by drop_scale).
extern "C" int v1t_attention(const void* qkv, const void* scale, void* out, void* lse,
                             int B, int N, int H, int D, int DP, int lsa, unsigned seed,
                             unsigned site, unsigned threshold, float drop_scale,
                             void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (threshold != 0u && lse == nullptr) return (int)cudaErrorInvalidValue;
  const Drop drop{seed, site, threshold, drop_scale};
  switch (DP) {
    case 32: return launch_dp<32>(qkv, scale, out, lse, B, N, H, D, lsa, drop, s);
    case 64: return launch_dp<64>(qkv, scale, out, lse, B, N, H, D, lsa, drop, s);
    case 96: return launch_dp<96>(qkv, scale, out, lse, B, N, H, D, lsa, drop, s);
    case 128: return launch_dp<128>(qkv, scale, out, lse, B, N, H, D, lsa, drop, s);
    case 160: return launch_dp<160>(qkv, scale, out, lse, B, N, H, D, lsa, drop, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
