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
// Layout: table (B, C, H*W) bf16 or float32 (the fp32 model's map; a
// template on the element type), grid (B, P, 2) fp32 (x, y) in [-1, 1],
// out (B, C, P) in the table's type. No cap on the table: the TPU kernel's
// MAX_TABLE_ROWS (VMEM) sent larger maps to XLA gathers, a full-resolution
// 137 x 249 map goes through this kernel as it is. One thread per (b, p): it computes the 4 corner
// indices and weights once, then walks the C channels, so that neighbouring
// threads write neighbouring p (coalesced stores); the table of one image
// (512 KB) is read through L1/L2.
//
// bilinear_sample_cm_bwd replaces v1t_tpu/ops/interp_matmul.py _bwd_kernel
// (:116), reached from _interp_bwd (:210): d(table) and d(grid) in one pass.
// The TPU kernel contracted the cotangent with the transposed hat matrix
// (a matmul in place of XLA's corner scatters); Hopper scatters: one thread
// per (b, p) adds w_i * dout to the 4 corners of every channel with fp32
// atomics (d(table) float32, cast to the table's dtype by the caller; the
// order of the adds varies from run to run) and accumulates torch's
// piecewise-linear grid gradient, d/dx = sum_c dout (v(x0 + 1) - v(x0))
// weighted over y inside the floor cell, in registers.
// Bound: the same bytes as the forward plus d(table) (the atomics' 4 adds per
// (b, c, p) stay in L2), ~16 FLOP per (b, c, p); bound by memory bytes.
#include "common.cuh"

namespace {

constexpr int THREADS = 256;

template <typename T>
__global__ void __launch_bounds__(THREADS) bilinear_sample_cm_kernel(
    const T* __restrict__ table, const float* __restrict__ grid,
    T* __restrict__ out, int C, int height, int width, int P) {
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
  const int HW = height * width;
  const T* tb = table + (size_t)b * C * HW;
  T* ob = out + (size_t)b * C * P + p;
  for (int c = 0; c < C; ++c) {
    const T* row = tb + (size_t)c * HW;
    const float v = wt[0] * to_f(row[idx[0]]) + wt[1] * to_f(row[idx[1]]) +
                    wt[2] * to_f(row[idx[2]]) + wt[3] * to_f(row[idx[3]]);
    store_f(ob + (size_t)c * P, v);
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS) bilinear_sample_cm_bwd_kernel(
    const T* __restrict__ table, const float* __restrict__ grid,
    const T* __restrict__ dout, float* __restrict__ dtable, float* __restrict__ dgrid,
    int C, int height, int width, int P) {
  const int p = blockIdx.x * THREADS + threadIdx.x, b = blockIdx.y;
  if (p >= P) return;
  const float gx = grid[((size_t)b * P + p) * 2];
  const float gy = grid[((size_t)b * P + p) * 2 + 1];
  const float x = fminf(fmaxf((gx + 1.f) * 0.5f * (width - 1), -2.f), width + 1.f);
  const float y = fminf(fmaxf((gy + 1.f) * 0.5f * (height - 1), -2.f), height + 1.f);
  const float x0f = floorf(x), y0f = floorf(y);
  const int ix0 = (int)x0f, iy0 = (int)y0f;
  const float wx1 = x - x0f, wy1 = y - y0f, wx0 = 1.f - wx1, wy0 = 1.f - wy1;
  int idx[4];
  bool valid[4];
  float wt[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int ix = ix0 + (i & 1), iy = iy0 + (i >> 1);
    valid[i] = ix >= 0 && ix < width && iy >= 0 && iy < height;
    idx[i] = valid[i] ? iy * width + ix : 0;
    wt[i] = ((i & 1) ? wx1 : wx0) * ((i >> 1) ? wy1 : wy0);
  }
  const int HW = height * width;
  const T* tb = table + (size_t)b * C * HW;
  float* db = dtable + (size_t)b * C * HW;
  const T* go = dout + (size_t)b * C * P + p;
  float dx = 0.f, dy = 0.f;
  for (int c = 0; c < C; ++c) {
    const float g = to_f(go[(size_t)c * P]);
    const T* row = tb + (size_t)c * HW;
    float v[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      v[i] = valid[i] ? to_f(row[idx[i]]) : 0.f;
      if (valid[i]) atomicAdd(db + (size_t)c * HW + idx[i], wt[i] * g);
    }
    dx += g * ((v[1] - v[0]) * wy0 + (v[3] - v[2]) * wy1);
    dy += g * ((v[2] - v[0]) * wx0 + (v[3] - v[1]) * wx1);
  }
  // pixel units -> the grid's [-1, 1] units (align_corners=True)
  dgrid[((size_t)b * P + p) * 2] = dx * 0.5f * (width - 1);
  dgrid[((size_t)b * P + p) * 2 + 1] = dy * 0.5f * (height - 1);
}

}  // namespace

// Returns cudaGetLastError() after the launch. table and dout bf16 (f32 ==
// 0) or float32 (f32 == 1); dtable (B, C, H*W) float32, which the caller
// zeroes, receives d(table); dgrid (B, P, 2) float32 d(grid) in the grid's
// units.
extern "C" int v1t_bilinear_sample_cm_bwd(const void* table, const void* grid,
                                          const void* dout, void* dtable, void* dgrid,
                                          int B, int C, int height, int width, int P, int f32,
                                          void* stream) {
  dim3 blocks((P + THREADS - 1) / THREADS, B);
  if (f32)
    bilinear_sample_cm_bwd_kernel<float><<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
        (const float*)table, (const float*)grid, (const float*)dout, (float*)dtable,
        (float*)dgrid, C, height, width, P);
  else
    bilinear_sample_cm_bwd_kernel<bf16><<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
        (const bf16*)table, (const float*)grid, (const bf16*)dout, (float*)dtable,
        (float*)dgrid, C, height, width, P);
  return (int)cudaGetLastError();
}

// Returns cudaGetLastError() after the launch. table and out bf16 (f32 == 0)
// or float32 (f32 == 1).
extern "C" int v1t_bilinear_sample_cm(const void* table, const void* grid,
                                      void* out, int B, int C, int height,
                                      int width, int P, int f32, void* stream) {
  dim3 blocks((P + THREADS - 1) / THREADS, B);
  if (f32)
    bilinear_sample_cm_kernel<float><<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
        (const float*)table, (const float*)grid, (float*)out, C, height, width, P);
  else
    bilinear_sample_cm_kernel<bf16><<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
        (const bf16*)table, (const float*)grid, (bf16*)out, C, height, width, P);
  return (int)cudaGetLastError();
}
