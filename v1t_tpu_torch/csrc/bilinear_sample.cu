// bilinear_sample_cm: bilinear sampling of a channel-major feature table,
//   out[b, c, p] = sum over the 4 corners of (x, y)[b, p] of w * table[b, c, iy*W + ix],
// with align_corners=True and zero padding (torch grid_sample semantics).
//
// Replaces v1t_tpu/ops/interp_matmul.py _fwd_kernel (:99), reached from
// interp_matmul_sample_cm: the Gaussian2d readout's sampling of the core map
// at each neuron's grid point. The TPU has no gather, so that kernel built
// hat-weight matrices and contracted them on the matrix unit, with the whole
// table resident in VMEM (MAX_TABLE_ROWS). Hopper gathers: neither carries
// over.
//
// Bound on the H100: 64 x 155 x 7000 bf16 outputs (139 MB) plus the 33 MB
// table; 8 FLOP per output. Bound by memory bytes.
//
// Layout: table (B, C, H*W) bf16, grid (B, P, 2) fp32 (x, y) in [-1, 1],
// out (B, C, P) bf16. One thread per (b, p): it computes the 4 corner
// indices and weights once, then walks the C channels, so that neighbouring
// threads write neighbouring p (coalesced stores); the table of one image
// (512 KB) is read through L1/L2.
#include "common.cuh"

namespace {

constexpr int THREADS = 256;

__global__ void __launch_bounds__(THREADS) bilinear_sample_cm_kernel(
    const bf16* __restrict__ table, const float* __restrict__ grid,
    bf16* __restrict__ out, int C, int height, int width, int P) {
  const int p = blockIdx.x * THREADS + threadIdx.x, b = blockIdx.y;
  if (p >= P) return;
  const float gx = grid[((size_t)b * P + p) * 2];
  const float gy = grid[((size_t)b * P + p) * 2 + 1];
  // pixel coordinates; clamping to [-2, size + 1] changes no weight (every
  // corner there is outside the map) and keeps the int conversion defined
  const float x = fminf(fmaxf((gx + 1.f) * 0.5f * (width - 1), -2.f), width + 1.f);
  const float y = fminf(fmaxf((gy + 1.f) * 0.5f * (height - 1), -2.f), height + 1.f);
  const float x0f = floorf(x), y0f = floorf(y);
  const int ix0 = (int)x0f, iy0 = (int)y0f;
  const float wx1 = x - x0f, wy1 = y - y0f, wx0 = 1.f - wx1, wy0 = 1.f - wy1;

  int idx[4];
  float wt[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int ix = ix0 + (i & 1), iy = iy0 + (i >> 1);
    const bool valid = ix >= 0 && ix < width && iy >= 0 && iy < height;
    idx[i] = valid ? iy * width + ix : 0;
    wt[i] = valid ? ((i & 1) ? wx1 : wx0) * ((i >> 1) ? wy1 : wy0) : 0.f;
  }
  const int T = height * width;
  const bf16* tb = table + (size_t)b * C * T;
  bf16* ob = out + (size_t)b * C * P + p;
  for (int c = 0; c < C; ++c) {
    const bf16* row = tb + (size_t)c * T;
    const float v = wt[0] * to_f(row[idx[0]]) + wt[1] * to_f(row[idx[1]]) +
                    wt[2] * to_f(row[idx[2]]) + wt[3] * to_f(row[idx[3]]);
    ob[(size_t)c * P] = __float2bfloat16_rn(v);
  }
}

}  // namespace

// Returns cudaGetLastError() after the launch.
extern "C" int v1t_bilinear_sample_cm(const void* table, const void* grid,
                                      void* out, int B, int C, int height,
                                      int width, int P, void* stream) {
  dim3 blocks((P + THREADS - 1) / THREADS, B);
  bilinear_sample_cm_kernel<<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
      (const bf16*)table, (const float*)grid, (bf16*)out, C, height, width, P);
  return (int)cudaGetLastError();
}
