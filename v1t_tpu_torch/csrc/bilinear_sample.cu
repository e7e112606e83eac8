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
// 137 x 249 map goes through this kernel as it is.
//
// A block owns one image b and G of its channels (one cell's word in
// shared memory: 16 bytes for 8 bf16 or 4 float32 channels) and walks all P
// points of the image. It first stages its G channels' table in shared
// memory interleaved by channel, [cell][G], the pad channels of a last
// chunk zero. The staging reads each of the G channels' cell run coalesced
// along cells (a chunk's planes start at ((b C + c0) H W), not 16-byte
// aligned at an odd cell count, so no bulk copy applies), STAGE_LOADS loads
// in flight a thread, and writes one word a cell: neighbouring threads,
// neighbouring words, no bank conflict. Then each thread takes two adjacent
// points, computes their corners and weights and makes 4 shared-memory
// loads a point, each returning G channels (the 32 lanes of a warp hit
// random cells, ~10 shared-memory wavefronts a 16-byte load), sums in
// float32 and stores a pair of adjacent outputs a channel (bf16x2 or
// float2: 128 or 256 bytes a warp store; scalar stores where P is odd).
// Float32 weights and sums, rounded once; no atomics, so reruns are
// bit-identical. The launch plan (sample_fwd_plan, mirrored by
// ops/interp_matmul.py sample_fwd_plan) depends on the shape alone: as many
// blocks a SM as a channel's table allows, at most FWD_BLOCKS_PER_SM (the
// registers' limit at 64 a thread), and the widest word that fits that
// share of the SM (the full-resolution 137 x 249 map: one channel a block,
// three a SM). A map whose single channel does not fit a block keeps the
// unstaged gather: a block a channel, its 4 corners read from global memory
// through L1/L2 (G = 1, no shared memory).
// On an H100 it reads the flagship's map at about half its byte bound.
// Variants that each take one cost away (v1t_tpu_torch/tools/
// ab_sample_forward.py --variants) show where the rest goes: the output
// stores and the staging's reads, which overlap the gathers only in part;
// bank conflicts, the grid's loads and the arithmetic cost little each.
// Two groups of channels a block, 4 or 8 points a thread, point ranges
// split over blocks and 32 staging loads in flight (which spilled) all
// read slower.
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

constexpr int THREADS = 256;          // a forward block's threads, two points each
constexpr int SM_SMEM = 233472;       // an SM's shared memory on an H100 (228 KB)
constexpr int BLOCK_RESERVE = 1024;   // what the runtime keeps of it for each block
constexpr int FWD_BLOCKS_PER_SM = 4;  // forward blocks a SM: 64 registers a thread
constexpr int STAGE_LOADS = 16;       // global loads in flight a thread while staging

// the launch of the forward: channels a block, one cell's shared-memory word
// (G), chunks of the channels (blocks an image), the dynamic shared memory
// a block and whether the table is staged in it
struct SampleFwdPlan {
  int group, chunks, smem, staged;
};

SampleFwdPlan sample_fwd_plan(int C, int height, int width, int f32) {
  const long long plane = (long long)height * width * (f32 ? 4 : 2);  // a channel's table
  SampleFwdPlan p{1, C, 0, 0};
  if (plane > SM_SMEM - BLOCK_RESERVE) return p;  // unstaged: a block a channel
  int per_sm = (int)(SM_SMEM / (plane + BLOCK_RESERVE));
  if (per_sm > FWD_BLOCKS_PER_SM) per_sm = FWD_BLOCKS_PER_SM;
  const long long share = SM_SMEM / per_sm - BLOCK_RESERVE;
  int g = f32 ? 4 : 8;  // 16 bytes a cell
  while (g > 1 && plane * g > share) g >>= 1;
  p.group = g;
  p.chunks = (C + g - 1) / g;
  p.smem = (int)(g * plane);
  p.staged = 1;
  return p;
}

// an element's bits: bf16 as 16, float as 32
template <typename T> struct Elem;
template <> struct Elem<bf16> { using bits = uint16_t; };
template <> struct Elem<float> { using bits = uint32_t; };

// a word of BYTES (16, 8, 4 or 2) bytes of shared memory as 32-bit registers
template <int BYTES>
__device__ __forceinline__ void lds(uint32_t addr, uint32_t* r) {
  if constexpr (BYTES == 16)
    asm volatile("ld.shared.v4.u32 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr) : "memory");
  else if constexpr (BYTES == 8)
    asm volatile("ld.shared.v2.u32 {%0, %1}, [%2];\n"
                 : "=r"(r[0]), "=r"(r[1]) : "r"(addr) : "memory");
  else if constexpr (BYTES == 4)
    asm volatile("ld.shared.u32 %0, [%1];\n" : "=r"(r[0]) : "r"(addr) : "memory");
  else {
    unsigned short h;
    asm volatile("ld.shared.u16 %0, [%1];\n" : "=h"(h) : "r"(addr) : "memory");
    r[0] = h;
  }
}

template <int BYTES>
__device__ __forceinline__ void sts(uint32_t addr, const uint32_t* r) {
  if constexpr (BYTES == 16)
    asm volatile("st.shared.v4.u32 [%0], {%1, %2, %3, %4};\n"
                 :: "r"(addr), "r"(r[0]), "r"(r[1]), "r"(r[2]), "r"(r[3]) : "memory");
  else if constexpr (BYTES == 8)
    asm volatile("st.shared.v2.u32 [%0], {%1, %2};\n"
                 :: "r"(addr), "r"(r[0]), "r"(r[1]) : "memory");
  else if constexpr (BYTES == 4)
    asm volatile("st.shared.u32 [%0], %1;\n" :: "r"(addr), "r"(r[0]) : "memory");
  else
    asm volatile("st.shared.u16 [%0], %1;\n" :: "r"(addr), "h"((unsigned short)r[0])
                 : "memory");
}

// channel j of a word held in 32-bit registers, as a float
template <typename T>
__device__ __forceinline__ float channel(const uint32_t* r, int j) {
  if constexpr (sizeof(T) == 2)
    return __uint_as_float(j & 1 ? r[j >> 1] & 0xffff0000u : r[j >> 1] << 16);
  else
    return __uint_as_float(r[j]);
}

// two adjacent outputs as one 4- (bf16) or 8-byte (float32) store
__device__ __forceinline__ void store_pair(bf16* o, float a, float b) {
  *reinterpret_cast<uint32_t*>(o) = pack_bf16(a, b);
}
__device__ __forceinline__ void store_pair(float* o, float a, float b) {
  *reinterpret_cast<float2*>(o) = make_float2(a, b);
}

// Copy the chunk's nc <= G channels (planes of `cells` elements from tb)
// into shared memory at `words` as [cells][G]: each thread loads G channels
// of STAGE_LOADS / G cells (coalesced along cells), then writes one word a
// cell; channels past nc are zero.
template <typename T, int G>
__device__ __forceinline__ void stage(const T* __restrict__ tb, uint32_t words, int cells,
                                      int nc) {
  using Bits = typename Elem<T>::bits;
  constexpr int BYTES = G * (int)sizeof(T), R = BYTES < 4 ? 1 : BYTES / 4;
  constexpr int U = STAGE_LOADS / G;
  const Bits* src = reinterpret_cast<const Bits*>(tb);
  for (int base = threadIdx.x; base < cells; base += THREADS * U) {
    uint32_t raw[U][G];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int cell = base + u * THREADS;
#pragma unroll
      for (int j = 0; j < G; ++j)
        raw[u][j] = cell < cells && j < nc ? (uint32_t)__ldg(src + (size_t)j * cells + cell) : 0u;
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int cell = base + u * THREADS;
      if (cell >= cells) break;
      uint32_t r[R];
#pragma unroll
      for (int k = 0; k < R; ++k) {
        if constexpr (sizeof(T) == 2 && G > 1)
          r[k] = raw[u][2 * k] | raw[u][2 * k + 1] << 16;
        else
          r[k] = raw[u][k];
      }
      sts<BYTES>(words + (uint32_t)(cell * BYTES), r);
    }
  }
}

// Corner cells and weights of the point (gx, gy); a point past P (!in)
// weighs nothing. Clamping to [-2, size + 1] changes no weight (every
// corner there is outside the map) and keeps the int conversion defined.
__device__ __forceinline__ void corners(float gx, float gy, bool in, int height, int width,
                                        int cell[4], float wt[4]) {
  const float x = fminf(fmaxf((gx + 1.f) * 0.5f * (width - 1), -2.f), width + 1.f);
  const float y = fminf(fmaxf((gy + 1.f) * 0.5f * (height - 1), -2.f), height + 1.f);
  const float x0f = floorf(x), y0f = floorf(y);
  const int ix0 = (int)x0f, iy0 = (int)y0f;
  const float wx1 = x - x0f, wy1 = y - y0f, wx0 = 1.f - wx1, wy0 = 1.f - wy1;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int ix = ix0 + (i & 1), iy = iy0 + (i >> 1);
    const bool valid = in && ix >= 0 && ix < width && iy >= 0 && iy < height;
    cell[i] = valid ? iy * width + ix : 0;
    wt[i] = valid ? ((i & 1) ? wx1 : wx0) * ((i >> 1) ? wy1 : wy0) : 0.f;
  }
}

// Walk the image's points two at a time: corners and weights, 4 loads a
// point (from the staged words, STAGED, or from the chunk's one channel in
// global memory), float32 sums, a pair of outputs for each of the nc
// channels to ob (the chunk's first channel row of out).
template <typename T, int G, bool STAGED>
__device__ __forceinline__ void walk(const T* __restrict__ tb, uint32_t words,
                                     const float* __restrict__ gb, T* __restrict__ ob, int nc,
                                     int height, int width, int P) {
  constexpr int BYTES = G * (int)sizeof(T), R = BYTES < 4 ? 1 : BYTES / 4;
  using Bits = typename Elem<T>::bits;
  const Bits* src = reinterpret_cast<const Bits*>(tb);
  const bool pairs_aligned = (P & 1) == 0;
  for (int q = threadIdx.x; 2 * q < P; q += THREADS) {
    const int p = 2 * q;
    const float* g = gb + 4 * (size_t)q;
    const bool second = p + 1 < P;
    int cell[2][4];
    float wt[2][4];
    corners(__ldg(g), __ldg(g + 1), true, height, width, cell[0], wt[0]);
    corners(second ? __ldg(g + 2) : 0.f, second ? __ldg(g + 3) : 0.f, second, height, width,
            cell[1], wt[1]);
    float acc[2][G];
#pragma unroll
    for (int k = 0; k < 2; ++k) {
#pragma unroll
      for (int j = 0; j < G; ++j) acc[k][j] = 0.f;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        uint32_t r[R];
        if constexpr (STAGED)
          lds<BYTES>(words + (uint32_t)(cell[k][i] * BYTES), r);
        else
          r[0] = __ldg(src + cell[k][i]);
#pragma unroll
        for (int j = 0; j < G; ++j) acc[k][j] = fmaf(wt[k][i], channel<T>(r, j), acc[k][j]);
      }
    }
#pragma unroll
    for (int j = 0; j < G; ++j) {
      if (j >= nc) break;  // a pad channel
      T* o = ob + (size_t)j * P + p;
      if (pairs_aligned) {
        store_pair(o, acc[0][j], acc[1][j]);
      } else {
        store_f(o, acc[0][j]);
        if (p + 1 < P) store_f(o + 1, acc[1][j]);
      }
    }
  }
}

template <typename T, int G>
__global__ void __launch_bounds__(THREADS, FWD_BLOCKS_PER_SM) bilinear_sample_cm_kernel(
    const T* __restrict__ table, const float* __restrict__ grid, T* __restrict__ out, int C,
    int height, int width, int P, int staged) {
  extern __shared__ uint4 table_words[];  // [cells][G channels]
  const int c0 = blockIdx.x * G, b = blockIdx.y;
  const int nc = C - c0 < G ? C - c0 : G;
  const int cells = height * width;
  const T* tb = table + ((size_t)b * C + c0) * cells;
  const float* gb = grid + (size_t)b * P * 2;
  T* ob = out + ((size_t)b * C + c0) * P;
  const uint32_t words = smem_u32(table_words);
  if (staged) {
    stage<T, G>(tb, words, cells, nc);
    __syncthreads();
    walk<T, G, true>(tb, words, gb, ob, nc, height, width, P);
  } else if constexpr (G == 1) {  // a channel past a block's shared memory
    walk<T, 1, false>(tb, words, gb, ob, nc, height, width, P);
  }
}

template <typename T, int G>
int launch_fwd_group(const SampleFwdPlan& plan, const void* table, const void* grid, void* out,
                     int B, int C, int height, int width, int P, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(bilinear_sample_cm_kernel<T, G>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, plan.smem);
  if (err != cudaSuccess) return (int)err;
  bilinear_sample_cm_kernel<T, G><<<dim3(plan.chunks, B), THREADS, plan.smem, stream>>>(
      (const T*)table, (const float*)grid, (T*)out, C, height, width, P, plan.staged);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_fwd(const void* table, const void* grid, void* out, int B, int C, int height,
               int width, int P, cudaStream_t s) {
  const SampleFwdPlan plan = sample_fwd_plan(C, height, width, sizeof(T) == 4);
  switch (plan.group) {
    case 1: return launch_fwd_group<T, 1>(plan, table, grid, out, B, C, height, width, P, s);
    case 2: return launch_fwd_group<T, 2>(plan, table, grid, out, B, C, height, width, P, s);
    case 4: return launch_fwd_group<T, 4>(plan, table, grid, out, B, C, height, width, P, s);
    case 8:
      if constexpr (sizeof(T) == 2)
        return launch_fwd_group<T, 8>(plan, table, grid, out, B, C, height, width, P, s);
  }
  return (int)cudaErrorInvalidValue;
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

// Returns a CUDA error code (0 on success). table and out bf16 (f32 == 0)
// or float32 (f32 == 1). B at most 65535.
extern "C" int v1t_bilinear_sample_cm(const void* table, const void* grid, void* out, int B,
                                      int C, int height, int width, int P, int f32,
                                      void* stream) {
  if (B < 1 || B > 65535 || C < 1 || height < 1 || width < 1 || P < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (f32) return launch_fwd<float>(table, grid, out, B, C, height, width, P, s);
  return launch_fwd<bf16>(table, grid, out, B, C, height, width, P, s);
}

// Field `field` of the forward's launch plan for C channels of a height x
// width map, bf16 (f32 == 0) or float32 (f32 == 1): 0 channels a block (a
// cell's shared-memory word), 1 chunks of channels (blocks an image), 2
// dynamic shared memory a block, 3 the table staged in shared memory (1) or
// gathered from global memory (0).
extern "C" int v1t_bilinear_sample_cm_plan(int C, int height, int width, int f32, int field) {
  const SampleFwdPlan p = sample_fwd_plan(C, height, width, f32);
  const int fields[4] = {p.group, p.chunks, p.smem, p.staged};
  return field >= 0 && field < 4 ? fields[field] : -1;
}
