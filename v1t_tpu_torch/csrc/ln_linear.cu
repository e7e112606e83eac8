// ln_linear: y = epilogue(prologue(x) @ w^T), the projection that carries
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
// projection moves 136..440 MB (x, w, residual read once, y written once;
// qkv's head-major y is 406 MB) for 16..61 GFLOP, 100..150 FLOP/byte, under
// the card's bf16 ridge of ~295: every launch is bound by memory bytes. So
// x is read and y written once, 16 bytes at a time, and the products
// (wgmma) hide under the copies.
//
// Design (hopper.cuh): a block owns 128 rows (64 when a panel wider than
// 320 columns would not fit) for every output tile: two consumer
// warpgroups of 64 rows and a producer warpgroup that gives up its
// registers (setmaxnreg). Output tiles are NT <= 160 columns: one head's
// plane of head_pad (the QKV output, head-major (S, B, H, rows, head_pad)
// for attention.cu; wider planes in two), or an even split of N. w (N, KP)
// row-major, K zero-padded to KP (a multiple of 32; QKV: each head's rows
// zero-padded to head_pad, so that the plane's pad columns come out zero)
// streams through a ring of [NT][64] chunks by TMA, one producer thread,
// mbarriers; the consumers issue wgmma m64nNTk16 from shared memory. The A
// operand comes two ways:
//   - panel (a LayerNorm, or rows not 16-byte aligned, K <= 640): the
//     block's rows of a row-major x are one contiguous span (128 x 155
//     bf16 = 39,680 bytes at the flagship), brought whole by bulk copies;
//     each warp turns two rows of it at a time into (x + bias_row, rounded
//     once) and the fp32 LayerNorm, and writes them rounded, once, into a
//     swizzled [rows][KP] panel that every output tile reads;
//   - streamed (no LayerNorm, 16-byte aligned rows: fc2's hidden layer):
//     x chunks [128][64] ride the ring beside w's.
// The epilogue of a tile: the accumulators into an fp32 tile of their own
// (not the ring, so that the producer runs ahead into the next tile); then
// a loop over units of 8 columns, compiled once (an epilogue unrolled over
// the tile's columns, with its Philox and erf inlined for each, ran out of
// the instruction cache on an H100): bias,
// fc1's pre-GELU activation, exact-erf GELU, the keep mask (element (0,
// row, col), one Philox per 4 columns, common.cuh), the rounding, and a
// 16-byte store into a plane row (through a table of the rows' offsets) or
// an aligned row; y without bias, GELU or mask (QKV) is staged in bf16 and
// copied out. A residual (out-projection, fc2: rows of 155 bf16 are 310
// bytes) goes through a bf16 tile and a writer of the rows' contiguous
// span, 16 bytes at a time, that adds it (+ res_row, rounded once).
#include <string.h>

#include "hopper.cuh"

namespace {

constexpr int MAX_NT = 160;         // output columns a tile at most
constexpr int MAX_PANEL_K = 640;    // a panel's columns at most (the LayerNorm's limit)
constexpr int MAX_PANEL_K128 = 320;  // a panel's columns in blocks of 128 rows
constexpr int CK = 64;              // columns of K a ring chunk
constexpr int HEAD = 2048;          // barriers; the rows' output offsets
constexpr int MAX_SMEM = 232448;
// setmaxnreg of the producer and the two consumer warpgroups (one consumer
// keeps the compiler's 255)
constexpr int PRODUCER_REGS = 40, CONSUMER_REGS = 232;

__host__ __device__ constexpr int cdiv(int a, int b) { return (a + b - 1) / b; }
__host__ __device__ constexpr int up(int a, int b) { return cdiv(a, b) * b; }

// The launch of one call (ops/ln_linear.py linear_plan mirrors it).
struct Plan {
  int stream, bm, nt, parts, n_tiles;  // parts: tiles a head-major plane
  int stages, stage_bytes, panel_bytes, smem;
};

// row stride (elements) of the staged output tile, fp32 and bf16: 32 bytes
// of padding, so that the accumulators' 8-byte stores fill two wavefronts
__host__ __device__ constexpr int sld(int nt) { return nt + 8; }

// Units of 8 columns go straight to y from the fp32 tile when y's rows are
// 16-byte aligned and there is no residual (head-major planes; fc1);
// otherwise through a bf16 tile and a writer of the rows' flat span.
__host__ __device__ constexpr bool direct_out(int heads, int N, bool residual) {
  return heads || (N % 8 == 0 && !residual);
}

__host__ __device__ inline Plan linear_plan(int M, int N, int K, int KP, int heads, int head_dim,
                                           int head_pad, bool ln, bool x_aligned, bool residual) {
  Plan p{};
  if (heads) {
    p.parts = cdiv(head_pad, MAX_NT);
    p.nt = up(cdiv(head_pad, p.parts), 32);
    p.n_tiles = N / head_dim * p.parts;
  } else {
    p.parts = 1;
    p.n_tiles = cdiv(N, MAX_NT);
    p.nt = up(cdiv(N, p.n_tiles), 32);
  }
  p.stream = !ln && x_aligned;
  if (!p.stream && KP > MAX_PANEL_K) return p;
  for (int bm = 128; bm >= 64; bm /= 2) {
    if (p.stream && bm != 128) break;
    if (!p.stream && bm == 128 && KP > MAX_PANEL_K128) continue;
    const int out = bm * sld(p.nt) * (4 + (direct_out(heads, N, residual) ? 0 : 2));
    const int raw = p.stream ? 0 : up(bm * K * 2 + 32, 128);
    const int region = up(out > raw ? out : raw, 1024);
    const int panel = p.stream ? 0 : bm * up(KP, CK) * 2;
    const int stage = (p.stream ? bm * CK * 2 : 0) + p.nt * CK * 2;
    for (int st = 4; st >= 2; --st) {
      const int smem = 1024 + HEAD + panel + st * stage + region;
      if (smem > MAX_SMEM) continue;
      p.bm = bm;
      p.stages = st;
      p.stage_bytes = stage;
      p.panel_bytes = panel;
      p.smem = smem;
      return p;
    }
  }
  return p;
}

struct Args {
  int M, N, K, KP, rows_per_batch, batches;
  int gelu, heads, head_dim, head_pad;
};

// Elements [e0, e1) of a row-major (., N) output whose rows m0 + r have
// their tile columns c = col - n0 in `stage` [r][sld]: 16-byte stores where
// a granule lies whole in the range, 2-byte ones at its ends; with `res`,
// the residual (+ res_row, rounded once) is added first.
__device__ __forceinline__ void put_rows(bf16* __restrict__ y, const bf16* stage, int ld,
                                         long long e0, long long e1, int N, int m0, int n0,
                                         const bf16* __restrict__ res,
                                         const bf16* __restrict__ res_row, int rows_per_batch,
                                         int lane128) {
  if (e0 >= e1) return;
  const uintptr_t ybase = reinterpret_cast<uintptr_t>(y);
  const int yshift = (int)((ybase & 15) >> 1);  // y's element 0 lies this far into its granule
  const long long g0 = (e0 + yshift) >> 3, g1 = (e1 + yshift + 7) >> 3;
  const bool res_vec = res != nullptr && ((reinterpret_cast<uintptr_t>(res) & 15) >> 1) == yshift;
#pragma unroll 1
  for (long long gi = g0 + lane128; gi < g1; gi += 128) {
    const long long ga = gi * 8 - yshift;  // the granule's first element index
    long long row = ga >= 0 ? ga / N : -1;
    int col = (int)(ga - row * N);
    float v[8];
    bool in[8];
    uint4 rraw = make_uint4(0u, 0u, 0u, 0u);
    const bool whole = ga >= e0 && ga + 8 <= e1;
    if (res != nullptr && whole && res_vec) rraw = *reinterpret_cast<const uint4*>(res + ga);
    const uint32_t rq[4] = {rraw.x, rraw.y, rraw.z, rraw.w};
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const long long at = ga + e;
      in[e] = at >= e0 && at < e1;
      v[e] = 0.f;
      if (in[e]) {
        v[e] = to_f(stage[(int)(row - m0) * ld + col - n0]);
        if (res != nullptr) {
          float z = whole && res_vec ? __uint_as_float(e & 1 ? rq[e >> 1] & 0xffff0000u : rq[e >> 1] << 16)
                                     : to_f(res[at]);
          if (res_row != nullptr)
            z = round_bf16(z + to_f(res_row[(row / rows_per_batch) * N + col]));
          v[e] += z;
        }
      }
      if (++col == N) {
        col = 0;
        ++row;
      }
    }
    if (whole) {
      *reinterpret_cast<uint4*>(y + ga) = make_uint4(pack_bf16(v[0], v[1]), pack_bf16(v[2], v[3]),
                                                     pack_bf16(v[4], v[5]), pack_bf16(v[6], v[7]));
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e)
        if (in[e]) y[ga + e] = __float2bfloat16_rn(v[e]);
    }
  }
}

template <int NT, int WGS, bool STREAM>
__global__ void __launch_bounds__(128 * (WGS + 1), 1) ln_linear_kernel(
    const __grid_constant__ CUtensorMap wmap, const __grid_constant__ CUtensorMap xmap,
    const bf16* __restrict__ x, const float* __restrict__ gamma, const float* __restrict__ beta,
    const bf16* __restrict__ pro_row, const float* __restrict__ bias,
    const bf16* __restrict__ residual, const bf16* __restrict__ res_row, bf16* __restrict__ y,
    bf16* __restrict__ pre, Args g, Plan P, Drop drop) {
  using namespace hopper;
  constexpr int BM = 64 * WGS, CONSUMERS = 128 * WGS, LD = sld(NT);
  extern __shared__ unsigned char smem_raw[];
  // aligned by pointer arithmetic on the shared array, so that the compiler
  // keeps every access below in shared memory (LDS/STS, not generic ones)
  unsigned char* base = smem_raw + ((1024u - (smem_u32(smem_raw) & 1023u)) & 1023u);
  uint64_t* full = reinterpret_cast<uint64_t*>(base);  // [4] a chunk landed
  uint64_t* empty = full + 4;                          // [4] its products are done
  uint64_t* xbar = empty + 4;                          // the x span landed (panel)
  // head-major y: each row's offset within a plane, (b H rows + tok) head_pad
  long long* rowoff = reinterpret_cast<long long*>(base + 1024);  // [BM]
  unsigned char* panel = base + HEAD;
  unsigned char* ring = panel + P.panel_bytes;
  unsigned char* region = ring + P.stages * P.stage_bytes;  // x span, then the staged tile
  float* fs = reinterpret_cast<float*>(region);              // [BM][LD] the accumulators
  bf16* ys = reinterpret_cast<bf16*>(fs + BM * LD);          // [BM][LD] y before the residual
  const int ST = P.stages;
  const bool direct = direct_out(g.heads, g.N, residual != nullptr);

  const int tid = threadIdx.x, lane = tid & 31, wgi = tid / 128;
  const int m0 = blockIdx.x * BM, rows = min(BM, g.M - m0);
  const int nk = cdiv(g.KP, CK);  // chunks a tile (columns past KP read as zeros)
  const int steps = P.n_tiles * nk;
  // x's span: its first granule, bytes, and the element offset of (m0, 0)
  const uintptr_t x_at = reinterpret_cast<uintptr_t>(x + (size_t)m0 * g.K);
  const uintptr_t x_start = x_at & ~(uintptr_t)15;
  const uint32_t x_bytes =
      (uint32_t)(((x_at + (uintptr_t)rows * g.K * 2 + 15) & ~(uintptr_t)15) - x_start);

  if (tid == 0) {
    for (int s = 0; s < ST; ++s) {
      bar_init(&full[s], 1);
      bar_init(&empty[s], CONSUMERS);
    }
    bar_init(xbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // the tile's first row of w and, head-major, its plane and first column
  auto tile_of = [&](int t, int& plane, int& col0) {
    plane = g.heads ? t / P.parts : 0;
    col0 = g.heads ? (t - plane * P.parts) * NT : t * NT;
    return g.heads ? plane * g.head_pad + col0 : col0;
  };

  if (wgi == WGS) {  // producer warpgroup: one thread starts every copy
    if (WGS == 2) regs_dec<PRODUCER_REGS>();
    if (tid == 128 * WGS) {
      if (!STREAM) {
        bar_expect(xbar, x_bytes);
        bulk_copy_pieces(region, reinterpret_cast<const void*>(x_start), x_bytes, xbar);
      }
      for (int it = 0; it < steps; ++it) {
        const int s = it % ST, t = it / nk, ch = it - t * nk;
        if (it >= ST) bar_wait(&empty[s], (uint32_t)((it / ST - 1) & 1));
        int plane, col0;
        const int wrow = tile_of(t, plane, col0);
        unsigned char* st = ring + s * P.stage_bytes;
        bar_expect(&full[s], (uint32_t)(CK / 32 * (NT + (STREAM ? BM : 0)) * 64));
        unsigned char* wst = st + (STREAM ? BM * CK * 2 : 0);
        for (int i = 0; i < CK / 32; ++i) {
          tma_box(wst + i * NT * 64, &wmap, ch * CK + 32 * i, wrow, 0, &full[s]);
          if (STREAM) tma_box(st + i * BM * 64, &xmap, ch * CK + 32 * i, m0, 0, &full[s]);
        }
      }
    }
    return;
  }

  // consumers: warpgroup wgi owns rows 64 wgi .. 64 wgi + 63 of the block
  if (WGS == 2) regs_inc<CONSUMER_REGS>();
  constexpr int KREGS = (WGS == 2 ? MAX_PANEL_K128 : MAX_PANEL_K) / 32;  // a lane's columns
  if (g.heads && tid < BM) {
    const int m = min(m0 + tid, g.M - 1), b = m / g.rows_per_batch;
    rowoff[tid] = ((long long)b * g.heads * g.rows_per_batch + (m - b * g.rows_per_batch)) *
                  g.head_pad;
  }
  // y's own rounding only (qkv): the tile goes out as bf16, copied 16 bytes
  // at a time
  const bool plain = bias == nullptr && !g.gelu && !drop.on() && pre == nullptr;
  if (STREAM) named_sync(1, CONSUMERS);  // the offsets (the panel's barrier otherwise)
  const int warp = (tid / 32) & 3, gq = lane >> 2, t4 = lane & 3;
  if (!STREAM) {
    // the panel: each warp takes rows of the span, (x + row) rounded once,
    // the LayerNorm's statistics in fp32 over the row in registers, the
    // result rounded into the swizzled [BM][KP] panel
    // gamma and beta in registers (lane l: columns l + 32 i); two rows a
    // warp at a time, so that their loads and shuffle chains overlap
    float gk[KREGS], bk[KREGS];
#pragma unroll
    for (int i = 0; i < KREGS; ++i) {
      const int k = lane + 32 * i;
      gk[i] = gamma != nullptr && k < g.K ? gamma[k] : 0.f;
      bk[i] = gamma != nullptr && k < g.K ? beta[k] : 0.f;
    }
    bar_wait(xbar, 0u);
    const bf16* xs = reinterpret_cast<const bf16*>(region) + ((x_at - x_start) >> 1);
    constexpr int NW = CONSUMERS / 32;
    for (int r = tid / 32; r < BM; r += 2 * NW) {
      float v[2][KREGS], s[2], mean[2], rstd[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int rr = r + h * NW;
        const bf16* xr = xs + (size_t)rr * g.K;
        const bf16* br = pro_row != nullptr && rr < rows
                             ? pro_row + (size_t)((m0 + rr) / g.rows_per_batch) * g.K
                             : nullptr;
        s[h] = 0.f;
#pragma unroll
        for (int i = 0; i < KREGS; ++i) {
          const int k = lane + 32 * i;
          float z = 0.f;
          if (rr < rows && k < g.K) {
            z = to_f(xr[k]);
            if (br != nullptr) z = round_bf16(z + to_f(br[k]));  // a bf16 add in the reference
          }
          v[h][i] = z;
          s[h] += z;
        }
      }
      if (gamma != nullptr) {
#pragma unroll
        for (int h = 0; h < 2; ++h) mean[h] = warp_sum(s[h]) / g.K;
        float var[2] = {0.f, 0.f};
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int i = 0; i < KREGS; ++i) {
            const float d = lane + 32 * i < g.K ? v[h][i] - mean[h] : 0.f;
            var[h] += d * d;
          }
#pragma unroll
        for (int h = 0; h < 2; ++h) rstd[h] = rsqrtf(warp_sum(var[h]) / g.K + 1e-5f);
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int i = 0; i < KREGS; ++i)
            if (lane + 32 * i < g.K) v[h][i] = (v[h][i] - mean[h]) * rstd[h] * gk[i] + bk[i];
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int rr = r + h * NW;
        if (rr >= BM) break;
#pragma unroll
        for (int i = 0; i < KREGS; ++i) {
          const int k = lane + 32 * i;
          const float val = rr < rows ? v[h][i] : 0.f;
          if (k < up(g.KP, CK)) *reinterpret_cast<bf16*>(panel + elem_at(BM, rr, k)) = __float2bfloat16_rn(val);
        }
      }
    }
    fence_async_smem();
    named_sync(1, CONSUMERS);  // the panel is complete; the span is free
  }

  float acc[NT / 2];
#pragma unroll
  for (int i = 0; i < NT / 2; ++i) acc[i] = 0.f;
  const uint32_t panel_s = smem_u32(panel);
  int it = 0;
  for (int t = 0; t < P.n_tiles; ++t) {
    for (int ch = 0; ch < nk; ++ch, ++it) {
      const int s = it % ST;
      unsigned char* st = ring + s * P.stage_bytes;
      bar_wait(&full[s], (uint32_t)((it / ST) & 1));
      const uint32_t w_s = smem_u32(st + (STREAM ? BM * CK * 2 : 0)), x_s = smem_u32(st);
      mma_fence();
#pragma unroll
      for (int kk = 0; kk < CK / 16; ++kk) {
        const uint64_t da = STREAM ? desc_k(x_s, BM, 64 * wgi, kk)
                                   : desc_k(panel_s, BM, 64 * wgi, ch * (CK / 16) + kk);
        wgmma::Mma<NT>::template ss<0, 0>(acc, da, desc_k(w_s, NT, 0, kk), ch > 0 || kk > 0);
      }
      mma_commit();
      if (ch > 0) {  // the previous chunk's products are done: its stage is free
        mma_wait<1>();
        bar_arrive(&empty[(it - 1) % ST]);
      }
    }
    mma_wait<0>();
    fence_regs(acc);
    bar_arrive(&empty[(it - 1) % ST]);

    // epilogue of tile t. 1) the accumulators into the fp32 tile
    int plane, col0;
    tile_of(t, plane, col0);
    const int r0 = 64 * wgi + 16 * warp;  // the warp's 16 rows within the block
    bf16* ts = direct ? reinterpret_cast<bf16*>(fs) : ys;  // the bf16 tile of the plain path
    if (plain) {
#pragma unroll
      for (int j = 0; j < NT / 8; ++j) {
        *reinterpret_cast<uint32_t*>(ts + (r0 + gq) * LD + 8 * j + 2 * t4) =
            pack_bf16(acc[4 * j], acc[4 * j + 1]);
        *reinterpret_cast<uint32_t*>(ts + (r0 + gq + 8) * LD + 8 * j + 2 * t4) =
            pack_bf16(acc[4 * j + 2], acc[4 * j + 3]);
      }
    } else {
#pragma unroll
      for (int j = 0; j < NT / 8; ++j) {
        *reinterpret_cast<float2*>(fs + (r0 + gq) * LD + 8 * j + 2 * t4) =
            make_float2(acc[4 * j], acc[4 * j + 1]);
        *reinterpret_cast<float2*>(fs + (r0 + gq + 8) * LD + 8 * j + 2 * t4) =
            make_float2(acc[4 * j + 2], acc[4 * j + 3]);
      }
    }
    named_sync(2 + wgi, 128);  // the warpgroup's rows are staged

    // 2) a unit of 8 columns a thread at a time (a loop unrolled only by 2:
    // its bias, pre-GELU activation, GELU and keep mask are compiled twice,
    // not NT / 8 times, so that the code stays in the instruction cache): y rounded,
    // 16 bytes at a time, into a plane row, an aligned row, or the bf16
    // tile; the keep mask one Philox per 4 columns
    const int wr0 = 64 * wgi, wr1 = min(64 * wgi + 64, rows), l128 = tid & 127;
    const int hs = g.heads ? plane / g.heads : 0, hh = g.heads ? plane - hs * g.heads : 0;
    const int wcols = min(NT, (g.heads ? g.head_pad : g.N) - col0);  // the tile's stored columns
    // y's element of a head-major plane row's offset rowoff[r]: the tile's
    // plane and first column
    const long long tileoff =
        ((long long)hs * g.batches * g.heads + hh) * g.rows_per_batch * g.head_pad + col0;
    if (plain && direct) {
#pragma unroll 4
      for (int i = l128; i < 64 * (NT / 8); i += 128) {
        const int r = wr0 + i / (NT / 8), c = (i % (NT / 8)) * 8;
        if (r >= wr1 || c >= wcols) continue;
        const uint4 v = *reinterpret_cast<const uint4*>(ts + r * LD + c);
        bf16* dst = g.heads ? y + tileoff + rowoff[r] + c : y + (size_t)(m0 + r) * g.N + col0 + c;
        *reinterpret_cast<uint4*>(dst) = v;
      }
    }
#pragma unroll 2
    for (int i = l128; i < 64 * (NT / 8) && !plain; i += 128) {
      const int r = wr0 + i / (NT / 8), c = (i % (NT / 8)) * 8, m = m0 + r;
      if (r >= wr1 || c >= wcols) continue;
      const float4 f0 = *reinterpret_cast<const float4*>(fs + r * LD + c);
      const float4 f1 = *reinterpret_cast<const float4*>(fs + r * LD + c + 4);
      float v[8] = {f0.x, f0.y, f0.z, f0.w, f1.x, f1.y, f1.z, f1.w};
      if (bias != nullptr) {
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          int n = col0 + c + e;  // the logical output column, or -1 (a plane's pad)
          if (g.heads) n = n < g.head_dim ? plane * g.head_dim + n : -1;
          else if (n >= g.N) n = -1;
          if (n >= 0) v[e] += bias[n];
        }
      }
      if (pre != nullptr) {  // row-major: columns col0 + c ..
        const size_t at = (size_t)m * g.N + col0 + c;
        if (direct && c + 8 <= wcols) {
          *reinterpret_cast<uint4*>(pre + at) = make_uint4(
              pack_bf16(v[0], v[1]), pack_bf16(v[2], v[3]), pack_bf16(v[4], v[5]), pack_bf16(v[6], v[7]));
        } else {
#pragma unroll
          for (int e = 0; e < 8; ++e)
            if (c + e < wcols) pre[at + e] = __float2bfloat16_rn(v[e]);
        }
      }
      if (g.gelu) {
#pragma unroll
        for (int e = 0; e < 8; ++e) v[e] = 0.5f * v[e] * (1.f + erff(v[e] * 0.70710678118654752f));
      }
      if (drop.on()) {
        const uint32_t grp = (uint32_t)(col0 + c) >> 2;
        const uint4 w0 = keep_words(drop, 0u, (uint32_t)m, grp);
        const uint4 w1 = keep_words(drop, 0u, (uint32_t)m, grp + 1u);
#pragma unroll
        for (int e = 0; e < 8; ++e)
          v[e] = word_of(e < 4 ? w0 : w1, e & 3) < drop.threshold ? v[e] * drop.scale : 0.f;
      }
      const uint4 out = make_uint4(pack_bf16(v[0], v[1]), pack_bf16(v[2], v[3]),
                                   pack_bf16(v[4], v[5]), pack_bf16(v[6], v[7]));
      if (g.heads) {
        *reinterpret_cast<uint4*>(y + tileoff + rowoff[r] + c) = out;
      } else if (direct) {
        *reinterpret_cast<uint4*>(y + (size_t)m * g.N + col0 + c) = out;
      } else {
        *reinterpret_cast<uint4*>(ys + r * LD + c) = out;
      }
    }
    if (!direct && wr1 > wr0) {
      // 3) the rows' flat span of y (+ the residual), 16 bytes at a time
      named_sync(2 + wgi, 128);
      const int w = min(NT, g.N - col0);
      if (col0 == 0 && w == g.N) {
        put_rows(y, ys + wr0 * LD, LD, (long long)(m0 + wr0) * g.N, (long long)(m0 + wr1) * g.N,
                 g.N, m0 + wr0, 0, residual, res_row, g.rows_per_batch, l128);
      } else {
        for (int r = wr0; r < wr1; ++r) {
          const long long e0 = (long long)(m0 + r) * g.N + col0;
          put_rows(y, ys + r * LD, LD, e0, e0 + w, g.N, m0 + r, col0, residual, res_row,
                   g.rows_per_batch, l128);
        }
      }
    }
    named_sync(2 + wgi, 128);  // the staging buffer is free for the next tile
  }
}

template <int NT, int WGS, bool STREAM>
int launch_kernel(const Plan& P, const CUtensorMap& wmap, const CUtensorMap& xmap, const bf16* x,
                  const float* gamma, const float* beta, const bf16* pro_row, const float* bias,
                  const bf16* residual, const bf16* res_row, bf16* y, bf16* pre, const Args& g,
                  Drop drop, cudaStream_t stream) {
  const cudaError_t err = cudaFuncSetAttribute(
      ln_linear_kernel<NT, WGS, STREAM>, cudaFuncAttributeMaxDynamicSharedMemorySize, P.smem);
  if (err != cudaSuccess) return (int)err;
  ln_linear_kernel<NT, WGS, STREAM><<<cdiv(g.M, 64 * WGS), 128 * (WGS + 1), P.smem, stream>>>(
      wmap, xmap, x, gamma, beta, pro_row, bias, residual, res_row, y, pre, g, P, drop);
  return (int)cudaGetLastError();
}

template <int NT>
int launch_nt(const Plan& P, const CUtensorMap& wmap, const CUtensorMap& xmap, const bf16* x,
              const float* gamma, const float* beta, const bf16* pro_row, const float* bias,
              const bf16* residual, const bf16* res_row, bf16* y, bf16* pre, const Args& g,
              Drop drop, cudaStream_t stream) {
  if (P.stream)
    return launch_kernel<NT, 2, true>(P, wmap, xmap, x, gamma, beta, pro_row, bias, residual,
                                      res_row, y, pre, g, drop, stream);
  if (P.bm == 128)
    return launch_kernel<NT, 2, false>(P, wmap, xmap, x, gamma, beta, pro_row, bias, residual,
                                       res_row, y, pre, g, drop, stream);
  return launch_kernel<NT, 1, false>(P, wmap, xmap, x, gamma, beta, pro_row, bias, residual,
                                     res_row, y, pre, g, drop, stream);
}

}  // namespace

// Returns a CUDA error code (0 on success). w is (N, KP) bf16, zero-padded
// from K to KP = a multiple of 32; with heads > 0 its rows are each head's
// head_dim rows zero-padded to head_pad, N / head_dim * head_pad rows in
// all. A LayerNorm (gamma/beta not null) takes K <= 640, and so does an x
// without it whose rows are not 16-byte aligned (or that starts off a
// 16-byte boundary; the caller pads a wider one). Null pointers switch off
// the LayerNorm (gamma/beta), the row bias before it (pro_row), the output
// bias, the residual and the row bias added to the residual (res_row).
// heads > 0 writes y head-major for attention.cu: (N / (heads*head_dim), B,
// heads, rows_per_batch, head_pad), zero past head_dim. Training: pre,
// when not null, receives the (M, N) activation before the GELU; threshold
// > 0 applies the keep mask of (seed, site) to the output (ops/dropout.py),
// scaling kept elements by drop_scale.
extern "C" int v1t_ln_linear(const void* x, const void* w, const void* gamma,
                             const void* beta, const void* pro_row,
                             const void* bias, const void* residual,
                             const void* res_row, void* y, void* pre, int M, int N,
                             int K, int KP, int rows_per_batch, int gelu, int heads,
                             int head_dim, int head_pad, unsigned seed, unsigned site,
                             unsigned threshold, float drop_scale, void* stream) {
  const uintptr_t x_at = reinterpret_cast<uintptr_t>(x);
  if (M < 1 || N < 1 || K < 1 || KP % 32 != 0 || KP < K || rows_per_batch < 1 ||
      M % rows_per_batch != 0 || (x_at & 1) || (reinterpret_cast<uintptr_t>(y) & 15) ||
      (gamma != nullptr && K > MAX_PANEL_K))
    return (int)cudaErrorInvalidValue;
  if (heads && (head_dim < 1 || head_pad < head_dim || head_pad % 32 != 0 ||
                N % (heads * head_dim) != 0 || residual != nullptr || pre != nullptr ||
                threshold != 0u))
    return (int)cudaErrorInvalidValue;
  const bool x_aligned = K % 8 == 0 && (x_at & 15) == 0;
  const Plan P = linear_plan(M, N, K, KP, heads, head_dim, head_pad, gamma != nullptr, x_aligned,
                             residual != nullptr);
  if (P.smem == 0) return (int)cudaErrorInvalidValue;
  const Args g{M, N, K, KP, rows_per_batch, M / rows_per_batch, gelu, heads, head_dim, head_pad};
  CUtensorMap wmap, xmap;
  memset(&wmap, 0, sizeof(wmap));
  memset(&xmap, 0, sizeof(xmap));
  const int w_rows = heads ? N / head_dim * head_pad : N;
  int rc = hopper::make_map(&wmap, w, 1, w_rows, KP, KP, P.nt);
  if (rc != 0) return rc;
  if (P.stream && (rc = hopper::make_map(&xmap, x, 1, M, K, K, P.bm)) != 0) return rc;
  const Drop drop{seed, site, threshold, drop_scale};
  cudaStream_t s = (cudaStream_t)stream;
  auto* xb = (const bf16*)x;
  auto* ga = (const float*)gamma;
  auto* be = (const float*)beta;
  auto* pr = (const bf16*)pro_row;
  auto* bi = (const float*)bias;
  auto* re = (const bf16*)residual;
  auto* rr = (const bf16*)res_row;
  auto* yb = (bf16*)y;
  auto* pb = (bf16*)pre;
  switch (P.nt) {
    case 32: return launch_nt<32>(P, wmap, xmap, xb, ga, be, pr, bi, re, rr, yb, pb, g, drop, s);
    case 64: return launch_nt<64>(P, wmap, xmap, xb, ga, be, pr, bi, re, rr, yb, pb, g, drop, s);
    case 96: return launch_nt<96>(P, wmap, xmap, xb, ga, be, pr, bi, re, rr, yb, pb, g, drop, s);
    case 128: return launch_nt<128>(P, wmap, xmap, xb, ga, be, pr, bi, re, rr, yb, pb, g, drop, s);
    case 160: return launch_nt<160>(P, wmap, xmap, xb, ga, be, pr, bi, re, rr, yb, pb, g, drop, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// One number of the ln_linear launch for these operands (field: 0 streamed
// x, 1 rows a block, 2 tile columns, 3 tiles, 4 ring stages, 5 shared
// memory a block, 0 when no launch fits), x's rows 16-byte aligned or not.
extern "C" int v1t_ln_linear_plan(int M, int N, int K, int KP, int heads, int head_dim,
                                  int head_pad, int ln, int x_aligned, int residual, int field) {
  const Plan P = linear_plan(M, N, K, KP, heads, head_dim, head_pad, ln != 0, x_aligned != 0,
                             residual != 0);
  const int values[6] = {P.stream, P.bm, P.nt, P.n_tiles, P.stages, P.smem};
  return field >= 0 && field < 6 ? values[field] : -1;
}
