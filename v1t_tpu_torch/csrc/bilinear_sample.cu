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
// The TPU kernel contracted the cotangent with the transposed hat matrix (a
// matmul in place of XLA's corner scatters); Hopper scatters, into shared
// memory. A block owns one image b, a chunk of its channels and a band of
// the map's rows, and holds those channels' d(table) over the band in
// shared memory as float32 and, where the whole map fits beside it, their
// table (staged). Its threads walk the image's P points once (corners and
// weights from the grid, dout read coalesced along p) and add w_i * dout to
// the corners inside the band with shared-memory atomics; at the end the
// block writes each channel's d(table) over the band once, in the table's
// dtype. No global atomic touches d(table). d(grid), torch's
// piecewise-linear grid gradient d/dx = sum_c dout (v(x0 + 1) - v(x0))
// weighted over y inside the floor cell (table values gathered from the
// staged table, or from global memory through L1/L2 as the forward does),
// is summed over the chunk's channels by the band that holds the point's
// row (clamped to the map) and added to d(grid) with one float2 atomic per
// (b, p, chunk); the launcher zeroes d(grid) first, and the chunks add in
// no fixed order, so d(grid)'s last bits may differ from run to run
// (d(table)'s too: the shared-memory adds). The launch plan
// (sample_bwd_plan, mirrored by the host's ops/interp_matmul.py
// sample_bwd_plan) depends on the shape alone: a channel's d(table) and
// table (8 bytes a cell) that fit half a SM's shared memory take as many
// channels a block as fit there (two blocks a SM; the chunks of the C
// channels split evenly), or a block's; past that the table stays in global
// memory and a channel's d(table) takes a block, in row bands where it does
// not fit one.
// Bound: the same bytes as the forward plus d(table) and d(grid), ~16 FLOP
// per (b, c, p); bound by memory bytes. What holds it far above that bound
// on an H100 is the shared-memory float atomics: Hopper has no float add
// among them (atomicAdd on a float compiles to a compare-and-swap loop,
// ATOMS.CAST.SPIN), and they run at about one a clock a SM. Staging the
// table takes the d(grid) gathers off L1, which made it faster; one 64-bit
// compare-and-swap carrying two channels' adds ran slower, a 128-bit one
// carrying four slower still.
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

// the launch of the backward: channels a block, its band of map rows, the
// grid of blocks, the dynamic shared memory a block and whether the table is
// staged in it
struct SampleBwdPlan {
  int channels, band_rows, chunks, bands, smem, staged;
};

constexpr int BWD_THREADS = 512;
constexpr int BWD_MAX_SMEM = 232448;   // a block's shared memory on an H100
constexpr int BWD_PAIR_SMEM = 115712;  // a block's when two share a SM

SampleBwdPlan sample_bwd_plan(int C, int height, int width) {
  // one channel's d(table) (float32) and table (a 4-byte slot a cell), bytes
  const long long staged = (long long)height * width * 8;
  SampleBwdPlan p{};
  if (staged <= BWD_MAX_SMEM) {
    const int per = (int)((staged <= BWD_PAIR_SMEM ? BWD_PAIR_SMEM : BWD_MAX_SMEM) / staged);
    const int most = per < C ? per : C;
    p.chunks = (C + most - 1) / most;
    p.channels = (C + p.chunks - 1) / p.chunks;
    p.band_rows = height;
    p.bands = 1;
    p.staged = 1;
    p.smem = p.channels * height * width * 8;
    return p;
  }
  const int rows = BWD_MAX_SMEM / (width * 4);
  if (rows < 1) return p;  // a row does not fit: no launch
  p.bands = (height + rows - 1) / rows;
  p.band_rows = (height + p.bands - 1) / p.bands;
  p.channels = 1;
  p.chunks = C;
  p.smem = p.band_rows * width * 4;
  return p;
}

template <typename T>
__global__ void __launch_bounds__(BWD_THREADS) bilinear_sample_cm_bwd_kernel(
    const T* __restrict__ table, const float* __restrict__ grid, const T* __restrict__ dout,
    T* __restrict__ dtable, float2* __restrict__ dgrid, int C, int height, int width, int P,
    int channels, int band_rows, int staged) {
  // [channels][the band's rows * width] d(table); staged, then the table
  // [channels][height * width] in its dtype
  extern __shared__ float acc[];
  const int c0 = blockIdx.x * channels, b = blockIdx.z;
  const int nc = C - c0 < channels ? C - c0 : channels;
  const int y0 = blockIdx.y * band_rows;
  const int y1 = y0 + band_rows < height ? y0 + band_rows : height;
  const int cells = (y1 - y0) * width, HW = height * width;
  for (int i = threadIdx.x; i < nc * cells; i += BWD_THREADS) acc[i] = 0.f;
  const T* tb = table + ((size_t)b * C + c0) * HW;
  if (staged) {  // the chunk's channels are contiguous: one coalesced copy
    T* tab = reinterpret_cast<T*>(acc + channels * cells);
    for (int i = threadIdx.x; i < nc * HW; i += BWD_THREADS) tab[i] = tb[i];
    tb = tab;
  }
  __syncthreads();

  const T* gb = dout + ((size_t)b * C + c0) * P;
  for (int p = threadIdx.x; p < P; p += BWD_THREADS) {
    const float gx = grid[((size_t)b * P + p) * 2];
    const float gy = grid[((size_t)b * P + p) * 2 + 1];
    const float x = fminf(fmaxf((gx + 1.f) * 0.5f * (width - 1), -2.f), width + 1.f);
    const float y = fminf(fmaxf((gy + 1.f) * 0.5f * (height - 1), -2.f), height + 1.f);
    const float x0f = floorf(x), y0f = floorf(y);
    const int ix0 = (int)x0f, iy0 = (int)y0f;
    const float wx1 = x - x0f, wy1 = y - y0f, wx0 = 1.f - wx1, wy0 = 1.f - wy1;
    // the band that holds the point's row sums its d(grid)
    const int own_row = iy0 < 0 ? 0 : iy0 >= height ? height - 1 : iy0;
    const bool owner = own_row >= y0 && own_row < y1;
    int idx[4], local[4];
    bool valid[4], in_band[4];
    float wt[4];
    bool any_valid = false, any_in_band = false;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int ix = ix0 + (i & 1), iy = iy0 + (i >> 1);
      valid[i] = ix >= 0 && ix < width && iy >= 0 && iy < height;
      in_band[i] = valid[i] && iy >= y0 && iy < y1;
      idx[i] = valid[i] ? iy * width + ix : 0;
      local[i] = in_band[i] ? (iy - y0) * width + ix : 0;
      wt[i] = ((i & 1) ? wx1 : wx0) * ((i >> 1) ? wy1 : wy0);
      any_valid |= valid[i];
      any_in_band |= in_band[i];
    }
    if (!any_valid || !(any_in_band || owner)) continue;  // nothing to add here
    float dx = 0.f, dy = 0.f;
    for (int c = 0; c < nc; ++c) {
      const float g = to_f(gb[(size_t)c * P + p]);
      float* a = acc + c * cells;
#pragma unroll
      for (int i = 0; i < 4; ++i)
        if (in_band[i]) atomicAdd(a + local[i], wt[i] * g);
      if (owner) {
        const T* row = tb + (size_t)c * HW;
        float v[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) v[i] = valid[i] ? to_f(row[idx[i]]) : 0.f;
        dx += g * ((v[1] - v[0]) * wy0 + (v[3] - v[2]) * wy1);
        dy += g * ((v[2] - v[0]) * wx0 + (v[3] - v[1]) * wx1);
      }
    }
    // pixel units -> the grid's [-1, 1] units (align_corners=True)
    if (owner)
      atomicAdd(dgrid + (size_t)b * P + p,
                make_float2(dx * 0.5f * (width - 1), dy * 0.5f * (height - 1)));
  }
  __syncthreads();
  T* db = dtable + ((size_t)b * C + c0) * HW + (size_t)y0 * width;
  for (int i = threadIdx.x; i < nc * cells; i += BWD_THREADS) {
    const int c = i / cells;
    store_f(db + (size_t)c * HW + (i - c * cells), acc[i]);
  }
}

template <typename T>
int launch_bwd(const void* table, const void* grid, const void* dout, void* dtable,
               void* dgrid, int B, int C, int height, int width, int P, cudaStream_t stream) {
  const SampleBwdPlan plan = sample_bwd_plan(C, height, width);
  if (plan.smem == 0) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(bilinear_sample_cm_bwd_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, plan.smem);
  if (err != cudaSuccess) return (int)err;
  err = cudaMemsetAsync(dgrid, 0, (size_t)B * P * 2 * sizeof(float), stream);
  if (err != cudaSuccess) return (int)err;
  bilinear_sample_cm_bwd_kernel<T><<<dim3(plan.chunks, plan.bands, B), BWD_THREADS, plan.smem,
                                     stream>>>(
      (const T*)table, (const float*)grid, (const T*)dout, (T*)dtable, (float2*)dgrid, C,
      height, width, P, plan.channels, plan.band_rows, plan.staged);
  return (int)cudaGetLastError();
}

}  // namespace

// Returns a CUDA error code (0 on success). table and dout bf16 (f32 == 0)
// or float32 (f32 == 1); dtable (B, C, H*W) in the same dtype receives
// d(table), every element written; dgrid (B, P, 2) float32 d(grid) in the
// grid's units, zeroed here and added to. B at most 65535.
extern "C" int v1t_bilinear_sample_cm_bwd(const void* table, const void* grid,
                                          const void* dout, void* dtable, void* dgrid,
                                          int B, int C, int height, int width, int P, int f32,
                                          void* stream) {
  if (B < 1 || B > 65535 || C < 1 || height < 1 || width < 1 || P < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (f32) return launch_bwd<float>(table, grid, dout, dtable, dgrid, B, C, height, width, P, s);
  return launch_bwd<bf16>(table, grid, dout, dtable, dgrid, B, C, height, width, P, s);
}

// Field `field` of the backward's launch plan for C channels of a height x
// width map: 0 channels a block, 1 rows a band, 2 chunks of channels, 3
// bands, 4 dynamic shared memory a block (0: no launch fits), 5 the table
// staged in shared memory (1) or read from global memory (0).
extern "C" int v1t_bilinear_sample_cm_bwd_plan(int C, int height, int width, int field) {
  const SampleBwdPlan p = sample_bwd_plan(C, height, width);
  const int fields[6] = {p.channels, p.band_rows, p.chunks, p.bands, p.smem, p.staged};
  return field >= 0 && field < 6 ? fields[field] : -1;
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
