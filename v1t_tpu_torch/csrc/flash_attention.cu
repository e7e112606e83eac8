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
// bf16: the tile loop of attention_tile.cuh (mma.sync m16n8k16, fp32
// accumulation), shared with attention.cu; q comes from shared memory, so
// that padded head widths up to 256 fit the registers (the 16 x DP fp32
// output accumulator alone is DP / 2 registers a thread).
// float32: FFMA on the CUDA cores, not TF32 (the fp32 model exists for
// exact arithmetic). A block of 256 threads owns 64 query rows; key tiles of
// 64. Thread (ty, tx) computes the scores of rows 4 ty .. 4 ty + 3 against
// keys 4 tx .. 4 tx + 3 from q^T and k^T tiles in shared memory (one float4
// of each per head column for 16 FMA), the row max and sum by shuffles over
// the 16 lanes of a row group, writes P^T to shared memory and accumulates
// o for its 4 rows at columns tx + 16 j.
//
// Bound on the H100: 4 * BH * Nq * Nk * D FLOP (two products) over ~3 x
// BH * N * D * dtype bytes: at the full-resolution shape (BH 8, N 34,114,
// D 155, bf16) 5.77 TFLOP, ~5.8 ms of bf16 tensor-core time against 0.03 ms
// of bytes; at the fp32 flagship (BH 256, N 1654) 0.434 TFLOP, 6.5 ms at
// the 67 TFLOP/s fp32 rate. Bound by operations.
// Not yet: wgmma, TMA, warp specialisation; the fp32 kernel's loads are not
// double-buffered.
#include "attention_tile.cuh"

namespace {

constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;
constexpr float MASKED = -1e30f;

// ---------------------------------------------------------------------------
// bf16

template <int DP>
constexpr int bf16_smem_bytes() {
  return attn_tile::BQ * (DP + 8) * (int)sizeof(bf16) + attn_tile::kv_smem_bytes<DP>();
}

template <int DP, bool TRAIN>
__global__ void __launch_bounds__(attn_tile::THREADS, 1) flash_fwd_bf16_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    bf16* __restrict__ out, float* __restrict__ lse, int Nq, int Nk, int n_real, int D,
    RowLayout ol, int lsa, Drop drop) {
  using attn_tile::BQ;
  using attn_tile::THREADS;
  constexpr int LD = DP + 8, CHUNKS = DP / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);  // [BQ][LD]
  bf16* Ks = Qs + BQ * LD;                       // [2][BKV][LD]
  bf16* Vs = Ks + 2 * attn_tile::BKV * LD;       // [2][BKV][LD]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int qt = blockIdx.x, bh = blockIdx.y;
  const bf16* qg = q + (size_t)bh * Nq * DP;
  const bf16* kg = k + (size_t)bh * Nk * DP;
  const bf16* vg = v + (size_t)bh * Nk * DP;

  // the block's q rows (committed with the first key/value tile)
  for (int i = tid; i < BQ * CHUNKS; i += THREADS) {
    const int r = i / CHUNKS, c = (i % CHUNKS) * 8, row = qt * BQ + r;
    const bool valid = row < Nq;
    cp_async16(Qs + r * LD + c, qg + (valid ? (size_t)row * DP + c : 0), valid);
  }
  attn_tile::load_kv_tile<DP>(kg, vg, Nk, 0, 0, Ks, Vs);

  const int row0 = qt * BQ + warp * 16;
  const bf16* qw = Qs + (warp * 16 + g) * LD + 2 * t;
  float o[DP / 8][4], m0, m1, l0, l1;
  attn_tile::softmax_pv<DP, TRAIN, true>(
      [&](int kk, uint32_t a[4]) {
        const bf16* p = qw + kk * 16;
        a[0] = ld_pair(p);
        a[1] = ld_pair(p + 8 * LD);
        a[2] = ld_pair(p + 8);
        a[3] = ld_pair(p + 8 * LD + 8);
      },
      kg, vg, Nk, n_real, row0, lsa, drop, (uint32_t)bh, Ks, Vs, o, m0, m1, l0, l1);

  const int r0 = row0 + g, r1 = r0 + 8;
  float inv0 = l0 == 0.f ? 1.f : 1.f / l0;
  float inv1 = l1 == 0.f ? 1.f : 1.f / l1;
  if (TRAIN && drop.on()) {
    inv0 *= drop.scale;
    inv1 *= drop.scale;
  }
  if (lse != nullptr && t == 0) {
    float* lrow = lse + (size_t)bh * Nq;
    if (r0 < Nq) lrow[r0] = (m0 + log2f(fmaxf(l0, 1e-37f))) * LN2;
    if (r1 < Nq) lrow[r1] = (m1 + log2f(fmaxf(l1, 1e-37f))) * LN2;
  }
#pragma unroll
  for (int di = 0; di < DP / 8; ++di)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int row = (j >> 1) ? r1 : r0;
      const int col = di * 8 + 2 * t + (j & 1);
      if (row < Nq && col < D)
        out[ol.at(bh, row) + col] = __float2bfloat16_rn(o[di][j] * ((j >> 1) ? inv1 : inv0));
    }
}

// ---------------------------------------------------------------------------
// float32

constexpr int FQ = 64, FK = 64, FTHREADS = 256, QLD = FQ + 4, KLD = FK + 4;

template <int DP>
constexpr int f32_smem_bytes() {
  // q^T [DP][QLD], k^T [DP][KLD], v [FK][DP], P^T [FK][QLD]
  return (DP * QLD + DP * KLD + FK * DP + FK * QLD) * (int)sizeof(float);
}

template <int DP, bool TRAIN>
__global__ void __launch_bounds__(FTHREADS, 1) flash_fwd_f32_kernel(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    float* __restrict__ out, float* __restrict__ lse, int Nq, int Nk, int n_real, int D,
    RowLayout ol, int lsa, Drop drop) {
  constexpr int NJ = DP / 16, C4 = DP / 4;
  extern __shared__ __align__(16) float fsm[];
  float* Qt = fsm;             // [DP][QLD]
  float* Kt = Qt + DP * QLD;   // [DP][KLD]
  float* Vs = Kt + DP * KLD;   // [FK][DP]
  float* Pt = Vs + FK * DP;    // [FK][QLD]

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int qt = blockIdx.x, bh = blockIdx.y;
  const float* qg = q + (size_t)bh * Nq * DP;
  const float* kg = k + (size_t)bh * Nk * DP;
  const float* vg = v + (size_t)bh * Nk * DP;

  for (int i = tid; i < FQ * C4; i += FTHREADS) {
    const int r = i / C4, c = (i % C4) * 4, row = qt * FQ + r;
    const float4 x = row < Nq ? *reinterpret_cast<const float4*>(qg + (size_t)row * DP + c)
                              : make_float4(0.f, 0.f, 0.f, 0.f);
    Qt[(c + 0) * QLD + r] = x.x;
    Qt[(c + 1) * QLD + r] = x.y;
    Qt[(c + 2) * QLD + r] = x.z;
    Qt[(c + 3) * QLD + r] = x.w;
  }

  float o[4][NJ], m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = MASKED;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < NJ; ++j) o[i][j] = 0.f;
  }

  const int ntiles = (Nk + FK - 1) / FK;
  for (int kt = 0; kt < ntiles; ++kt) {
    __syncthreads();  // every thread is done with the previous tile
    for (int i = tid; i < FK * C4; i += FTHREADS) {
      const int j = i / C4, c = (i % C4) * 4, key = kt * FK + j;
      float4 x = make_float4(0.f, 0.f, 0.f, 0.f), y = x;
      if (key < Nk) {
        x = *reinterpret_cast<const float4*>(kg + (size_t)key * DP + c);
        y = *reinterpret_cast<const float4*>(vg + (size_t)key * DP + c);
      }
      Kt[(c + 0) * KLD + j] = x.x;
      Kt[(c + 1) * KLD + j] = x.y;
      Kt[(c + 2) * KLD + j] = x.z;
      Kt[(c + 3) * KLD + j] = x.w;
      *reinterpret_cast<float4*>(Vs + j * DP + c) = y;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < DP; ++d) {
      const float4 a = *reinterpret_cast<const float4*>(Qt + d * QLD + ty * 4);
      const float4 b = *reinterpret_cast<const float4*>(Kt + d * KLD + tx * 4);
      const float av[4] = {a.x, a.y, a.z, a.w}, bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(av[i], bv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = qt * FQ + ty * 4 + i;
      float mx = m[i];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int key = kt * FK + tx * 4 + j;
        s[i][j] *= LOG2E;
        if (key >= n_real || (lsa && key == row)) s[i][j] = MASKED;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 1; off < 16; off <<= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float alpha = exp2f(m[i] - mx);
      m[i] = mx;
      l[i] *= alpha;
#pragma unroll
      for (int j = 0; j < NJ; ++j) o[i][j] *= alpha;
      uint4 w = make_uint4(0u, 0u, 0u, 0u);
      if (TRAIN && drop.on())
        w = keep_words(drop, (uint32_t)bh, (uint32_t)row, (uint32_t)(kt * FK + tx * 4) >> 2);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float p = exp2f(s[i][j] - mx);
        l[i] += p;
        if (TRAIN && drop.on() && word_of(w, j) >= drop.threshold) p = 0.f;
        Pt[(tx * 4 + j) * QLD + ty * 4 + i] = p;
      }
    }
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < FK; ++kk) {
      const float4 p = *reinterpret_cast<const float4*>(Pt + kk * QLD + ty * 4);
      const float pv[4] = {p.x, p.y, p.z, p.w};
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const float vv = Vs[kk * DP + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i) o[i][j] = fmaf(pv[i], vv, o[i][j]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float li = l[i];
#pragma unroll
    for (int off = 1; off < 16; off <<= 1) li += __shfl_xor_sync(0xffffffffu, li, off);
    const int row = qt * FQ + ty * 4 + i;
    if (row >= Nq) continue;
    float inv = li == 0.f ? 1.f : 1.f / li;
    if (TRAIN && drop.on()) inv *= drop.scale;
    if (lse != nullptr && tx == 0)
      lse[(size_t)bh * Nq + row] = (m[i] + log2f(fmaxf(li, 1e-37f))) * LN2;
    float* orow = out + ol.at(bh, row);
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int col = tx + 16 * j;
      if (col < D) orow[col] = o[i][j] * inv;
    }
  }
}

// ---------------------------------------------------------------------------

template <int DP, bool TRAIN>
int launch_dp(bool f32, const void* q, const void* k, const void* v, void* out, void* lse,
              int BH, int Nq, int Nk, int n_real, int D, RowLayout ol, int lsa, Drop drop,
              cudaStream_t stream) {
  cudaError_t err;
  if (f32) {
    constexpr int bytes = f32_smem_bytes<DP>();
    err = cudaFuncSetAttribute(flash_fwd_f32_kernel<DP, TRAIN>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return (int)err;
    flash_fwd_f32_kernel<DP, TRAIN><<<dim3((Nq + FQ - 1) / FQ, BH), FTHREADS, bytes, stream>>>(
        (const float*)q, (const float*)k, (const float*)v, (float*)out, (float*)lse, Nq, Nk,
        n_real, D, ol, lsa, drop);
  } else {
    constexpr int bytes = bf16_smem_bytes<DP>();
    err = cudaFuncSetAttribute(flash_fwd_bf16_kernel<DP, TRAIN>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return (int)err;
    flash_fwd_bf16_kernel<DP, TRAIN>
        <<<dim3((Nq + attn_tile::BQ - 1) / attn_tile::BQ, BH), attn_tile::THREADS, bytes,
           stream>>>((const bf16*)q, (const bf16*)k, (const bf16*)v, (bf16*)out, (float*)lse,
                     Nq, Nk, n_real, D, ol, lsa, drop);
  }
  return (int)cudaGetLastError();
}

template <int DP>
int launch(bool f32, bool train, const void* q, const void* k, const void* v, void* out,
           void* lse, int BH, int Nq, int Nk, int n_real, int D, RowLayout ol, int lsa,
           Drop drop, cudaStream_t stream) {
  if (train)
    return launch_dp<DP, true>(f32, q, k, v, out, lse, BH, Nq, Nk, n_real, D, ol, lsa, drop,
                               stream);
  return launch_dp<DP, false>(f32, q, k, v, out, lse, BH, Nq, Nk, n_real, D, ol, lsa, drop,
                              stream);
}

}  // namespace

// Returns a CUDA error code (0 on success). q (BH, Nq, DP), k and v (BH, Nk,
// DP), bf16 (f32 == 0) or float32 (f32 == 1), rows zero-padded from D to
// DP = 32, 64, ..., 256; out in the same dtype at element (bh, row, d) ->
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
  const bool f = f32 != 0;
  switch (DP) {
    case 32: return launch<32>(f, train, q, k, v, out, lse, BH, Nq, Nk, n_real_k, D, ol, lsa, drop, s);
    case 64: return launch<64>(f, train, q, k, v, out, lse, BH, Nq, Nk, n_real_k, D, ol, lsa, drop, s);
    case 96: return launch<96>(f, train, q, k, v, out, lse, BH, Nq, Nk, n_real_k, D, ol, lsa, drop, s);
    case 128: return launch<128>(f, train, q, k, v, out, lse, BH, Nq, Nk, n_real_k, D, ol, lsa, drop, s);
    case 160: return launch<160>(f, train, q, k, v, out, lse, BH, Nq, Nk, n_real_k, D, ol, lsa, drop, s);
    case 192: return launch<192>(f, train, q, k, v, out, lse, BH, Nq, Nk, n_real_k, D, ol, lsa, drop, s);
    case 224: return launch<224>(f, train, q, k, v, out, lse, BH, Nq, Nk, n_real_k, D, ol, lsa, drop, s);
    case 256: return launch<256>(f, train, q, k, v, out, lse, BH, Nq, Nk, n_real_k, D, ol, lsa, drop, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
