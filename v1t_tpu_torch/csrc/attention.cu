// attention: the attention core of the pre-LN sublayer,
//   o[b, q, h*D + d] = sum_k softmax_k(scale_h * q.k, masked) v[k, d],
// reading q, k, v in the head-major layout that ln_linear writes for it.
//
// Replaces the attention part of v1t_tpu/ops/fused_mha.py
// _mha_fwd_kernel_dt2 (:567) (and its dt/legacy orientations :278, :159,
// which compute the same function): per-head scale (learnable under LSA),
// LSA diagonal mask, softmax in base 2 with log2(e) folded into the scale,
// head concat. The LayerNorm, QKV and output projections around it are
// ln_linear.cu. The training variant also drops probabilities as the TPU
// kernel does (:619-621): the row sum l is taken before the keep mask, the
// kept unnormalised probabilities feed P.V and the 1/keep scale folds into
// 1/l; and it writes each row's log2-domain log-sum-exp, m + log2(l)
// (:641-645), which attention_bwd.cu recomputes P from. Mask element
// (b * H + h, query, key) of the site (common.cuh).
//
// Bound on the H100: 4*B*H*N^2*D = 434 GFLOP per block at the flagship
// shapes (B 64, H 4, N 1654, D 155) against ~540 MB of q/k/v/o: ~800
// FLOP/byte, bound by tensor-core operations.
//
// Layout: qkv (3, B, H, N, DP) bf16, each head's rows zero-padded from D to
// DP (a multiple of 32: 155 -> 160), so that its q, k and v planes are each
// a (B*H, N, DP) array that TMA copies; out (B, N, o_row) bf16 with o_row
// >= H*D a multiple of 8 (620 -> 624 at the flagship), so that the output
// projection streams its 16-byte aligned rows by TMA; the pad columns are
// written as zeros.
// The kernel is the bf16 flash forward of flash_attention.cu
// (wgmma_fwd.cuh; FlashAttention-3's warp-specialised design: one thread
// starting TMA copies of q and of K / V tiles into an mbarrier ring, two
// consumer warpgroups of 64 rows on wgmma), launched here in its log2 mode:
// it reads q unscaled and scales each warpgroup's rows of the q panel in
// shared memory once, q_s = bf16(q * scale_h * log2 e) as the TPU kernel
// rounds it, then p = 2^(s - m). Keys past N (a key tile's zero fill) weigh
// nothing; the LSA diagonal keeps the finite masked score, so that a row
// whose every key is masked (LSA at N 1) gives o = v, as the plain version.
#include "wgmma_fwd.cuh"

// Returns a CUDA error code (0 on success). DP is the padded head width:
// 32, 64, 96, 128 or 160, at least D; o_row the output's row stride, at
// least H * D. Training: lse, when not null, receives the (B, H, N) float32
// log2-domain log-sum-exp of every row and selects the training kernel,
// which applies the keep mask of (seed, site) to the probabilities when
// threshold > 0 (scaling by drop_scale).
extern "C" int v1t_attention(const void* qkv, const void* scale, void* out, void* lse,
                             int B, int N, int H, int D, int DP, int o_row, int lsa,
                             unsigned seed, unsigned site, unsigned threshold, float drop_scale,
                             void* stream) {
  if (DP % 32 || DP < 32 || DP > 160 || D > DP || B < 1 || H < 1 || N < 1 ||
      (long long)B * H > 65535 || o_row < H * D || (threshold != 0u && lse == nullptr))
    return (int)cudaErrorInvalidValue;
  const Drop drop{seed, site, threshold, drop_scale};
  const size_t plane = (size_t)B * H * N * DP;  // elements of one of q, k, v
  const bf16* q = (const bf16*)qkv;
  const RowLayout ol{H, N * o_row, D, o_row};
  return wgmma_fwd::launch(q, q + plane, q + 2 * plane, (bf16*)out, (float*)lse, B * H, N, N,
                           N, D, DP, ol, lsa, drop, (const float*)scale, o_row - H * D,
                           lse != nullptr, (cudaStream_t)stream);
}
