// attention_bwd: the backward of attention.cu's training forward,
//   dq, dk, dv of o = dropout(softmax(scale_h * q.k, masked)) v per head,
// from the q/k/v the forward read, its output o, the cotangent dO and the
// log2-domain log-sum-exp (LSE) the forward saved.
//
// Replaces the attention part of v1t_tpu/ops/fused_mha.py
// _mha_bwd_kernel_dt2 (:676) (and its dt/legacy orientations :384, :1008):
// P recomputed from the LSE (:768), delta = rowsum(dO . o) (:756), the
// probability keep mask regenerated (:760-762), dS = P (Z dP - delta),
// dq, dk, dv and the per-head dscale (:818). The projections around it
// (the out-projection's and QKV's backwards, the LayerNorm backward) are
// ln_linear_bwd.cu.
//
// Math in the log2 domain the forward uses: q_s = bf16(q * scale * log2 e),
// s2 = q_s . k, P = exp2(s2 - lse2), so that P = softmax(scale q.k). With Z =
// keep / (1 - rate) (zero where dropped), dP = Z (dO . v), dS = P (dP -
// delta) is the gradient of the natural-log scores; then dq = scale dS k,
// dk = ln2 dS^T q_s (= scale dS^T q up to q_s's rounding, as the TPU kernel
// computes it, :804), dv = (Z P)^T dO, dscale_h = sum q . (dS k).
//
// Bound on the H100 at the flagship shapes (B 64, H 4, N 1654, D 155):
// the five N^2 products of a head (S, dP, dq, dk, dv) are 5 * 2 * N^2 * D
// FLOP = 4.24 GFLOP per (b, h), 1.09 TFLOP per call: 1.10 ms of bf16
// tensor-core time against ~0.25 ms of bytes. Bound by operations.
//
// Three kernels, one launch each, around one memset:
// 1. prep: delta = rowsum(dO . o) per (b, h, row) (o's rows o_row apart,
//    the forward's aligned stride), dO copied from the out-projection's
//    (B, N, H*D) layout into the head-major (B, H, N, DP)
//    layout of q/k/v (zero-padded from D to DP), and q_s = bf16(q * scale *
//    log2 e) written head-major; the float32 (B*H, N, DP) dq accumulator is
//    zeroed.
// 2. the bf16 one pass of flash_attention_bwd.cu (one_pass_bwd.cuh: wgmma
//    on TMA-fed panels, one block per 128 keys looping over query tiles of
//    64, five N^2 products, one Philox draw per element), on q_s, the k and v
//    planes of qkv as they are ((B*H, N, DP) contiguous) and the prep's dO
//    and delta, with P = exp2(s2 - lse2) (its log2 convention) and dk = ln2
//    dS^T q_s written into dqkv; dq's partial sums dS k go into the
//    accumulator with float4 atomics.
// 3. convert: dq = bf16(scale_h acc) into dqkv, and each (b, h)'s dscale
//    partial sum q . acc added with one atomic per block. The key blocks add
//    into the accumulator in no fixed order, so dq's and dscale's float32
//    sums may differ in their last bits from run to run.
#include "one_pass_bwd.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int CONVERT_ITEMS = 4;  // float4s of the accumulator a convert thread takes
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

__global__ void __launch_bounds__(THREADS) attention_bwd_prep_kernel(
    const bf16* __restrict__ qkv, const float* __restrict__ scale, const bf16* __restrict__ o,
    const bf16* __restrict__ dout, bf16* __restrict__ qs, bf16* __restrict__ dohm,
    float* __restrict__ delta, int B, int N, int H, int D, int DP, int o_row) {
  // one warp per (b, h, row)
  const long long item = (long long)blockIdx.x * (THREADS / 32) + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (item >= (long long)B * H * N) return;
  const int row = (int)(item % N), bh = (int)(item / N), h = bh % H, b = bh / H;
  const size_t src = ((size_t)b * N + row) * H * D + (size_t)h * D;
  const size_t osrc = ((size_t)b * N + row) * o_row + (size_t)h * D;
  const size_t hm = ((size_t)bh * N + row) * DP;  // head-major row of q, dO, q_s
  const float sc = scale[h] * LOG2E;
  float acc = 0.f;
  for (int d = lane; d < DP; d += 32) {
    const float g = d < D ? to_f(dout[src + d]) : 0.f;
    if (d < D) acc += g * to_f(o[osrc + d]);
    dohm[hm + d] = __float2bfloat16_rn(g);
    // q rounded after the scale, as the forward rounds it
    qs[hm + d] = __float2bfloat16_rn(d < D ? to_f(qkv[hm + d]) * sc : 0.f);
  }
  acc = warp_sum(acc);
  if (lane == 0) delta[(size_t)bh * N + row] = acc;
}

// dq = bf16(scale_h acc) (zero past D) and dscale[bh] += sum q . acc, for
// plane bh = blockIdx.y; each thread takes CONVERT_ITEMS float4s of the
// plane, the block's sum goes out in one atomic
__global__ void __launch_bounds__(THREADS) attention_bwd_convert_kernel(
    const float4* __restrict__ acc, const bf16* __restrict__ q, const float* __restrict__ scale,
    bf16* __restrict__ dq, float* __restrict__ dscale, int H, int N, int D, int DP) {
  __shared__ float warp_part[THREADS / 32];
  const int bh = blockIdx.y, q4 = DP / 4;
  const long long n4 = (long long)N * q4;  // float4s of one plane
  const size_t plane = (size_t)bh * n4;
  const float sc = scale[bh % H];
  float part = 0.f;
  for (int r = 0; r < CONVERT_ITEMS; ++r) {
    const long long i = ((long long)blockIdx.x * CONVERT_ITEMS + r) * THREADS + threadIdx.x;
    if (i >= n4) break;
    const float4 a = acc[plane + i];
    const uint2 raw = reinterpret_cast<const uint2*>(q)[plane + i];  // q's 4 bf16
    const __nv_bfloat162 q01 = *reinterpret_cast<const __nv_bfloat162*>(&raw.x);
    const __nv_bfloat162 q23 = *reinterpret_cast<const __nv_bfloat162*>(&raw.y);
    const int col = (int)(i % q4) * 4;
    const float x[4] = {a.x, a.y, a.z, a.w};
    const float qv[4] = {__low2float(q01), __high2float(q01), __low2float(q23),
                         __high2float(q23)};
    float y[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const bool in = col + c < D;
      if (in) part = fmaf(qv[c], x[c], part);
      y[c] = in ? x[c] * sc : 0.f;
    }
    reinterpret_cast<uint2*>(dq)[plane + i] = make_uint2(pack_bf16(y[0], y[1]),
                                                         pack_bf16(y[2], y[3]));
  }
  part = warp_sum(part);
  if ((threadIdx.x & 31) == 0) warp_part[threadIdx.x >> 5] = part;
  __syncthreads();
  if (threadIdx.x == 0) {
    float sum = 0.f;
#pragma unroll
    for (int w = 0; w < THREADS / 32; ++w) sum += warp_part[w];
    atomicAdd(dscale + bh, sum);
  }
}

}  // namespace

// Returns a CUDA error code (0 on success). qkv (3, B, H, N, DP) bf16 as
// ln_linear wrote it for the forward; o (B, N, o_row) bf16 as the forward
// wrote it (o_row >= H*D); dout (B, N, H*D) bf16; lse
// (B, H, N) float32 from attention's training forward; scale (H,) float32.
// Writes dqkv (3, B, H, N, DP) bf16 (zero past D) and adds each (b, h)'s
// dscale partial into dscale (B, H) float32, which the caller zeroes.
// qs and dohm (B, H, N, DP) bf16, delta (B, H, N) float32 and dq_acc (B, H,
// N, DP) float32 are scratch. DP is 32, 64, 96, 128 or 160 and B * H at most
// 65535; threshold > 0 regenerates the probabilities' keep mask of (seed,
// site) (the forward's), scaling kept ones by drop_scale.
extern "C" int v1t_attention_bwd(const void* qkv, const void* o, const void* dout,
                                 const void* lse, const void* scale, void* dqkv, void* dscale,
                                 void* qs, void* dohm, void* delta, void* dq_acc, int B, int N,
                                 int H, int D, int DP, int o_row, int lsa, unsigned seed,
                                 unsigned site, unsigned threshold, float drop_scale,
                                 void* stream) {
  if (DP % 32 || DP < 32 || DP > 160 || D > DP || B < 1 || H < 1 || N < 1 ||
      (long long)B * H > 65535 || o_row < H * D)
    return (int)cudaErrorInvalidValue;
  const Drop drop{seed, site, threshold, drop_scale};
  cudaStream_t s = (cudaStream_t)stream;
  const int BH = B * H;
  const size_t plane = (size_t)BH * N * DP;  // elements of one of q, k, v
  const long long rows = (long long)BH * N;
  attention_bwd_prep_kernel<<<(unsigned)((rows + THREADS / 32 - 1) / (THREADS / 32)), THREADS,
                              0, s>>>((const bf16*)qkv, (const float*)scale, (const bf16*)o,
                                      (const bf16*)dout, (bf16*)qs, (bf16*)dohm, (float*)delta,
                                      B, N, H, D, DP, o_row);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  err = cudaMemsetAsync(dq_acc, 0, plane * sizeof(float), s);
  if (err != cudaSuccess) return (int)err;
  const bf16* k = (const bf16*)qkv + plane;
  bf16* dk = (bf16*)dqkv + plane;
  const int rc = one_pass::launch(qs, k, k + plane, dohm, (const float*)lse,
                                  (const float*)delta, (float*)dq_acc, dk, dk + plane, BH, N, N,
                                  N, D, DP, lsa, drop, 1.f, LN2, s);
  if (rc != 0) return rc;
  const long long n4 = (long long)N * DP / 4;
  const unsigned blocks = (unsigned)((n4 + THREADS * CONVERT_ITEMS - 1) / (THREADS * CONVERT_ITEMS));
  attention_bwd_convert_kernel<<<dim3(blocks, BH), THREADS, 0, s>>>(
      (const float4*)dq_acc, (const bf16*)qkv, (const float*)scale, (bf16*)dqkv,
      (float*)dscale, H, N, D, DP);
  return (int)cudaGetLastError();
}
