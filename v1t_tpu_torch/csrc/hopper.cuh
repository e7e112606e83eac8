// Hopper building blocks of the flash kernels (flash_attention.cu,
// flash_attention_bwd.cu) and the projections' (ln_linear.cu,
// ln_linear_bwd.cu): shared-memory panels in the layout wgmma reads, their
// descriptors, TMA and bulk copies into them (and bulk reduce-adds out of
// float32 boxes), mbarriers, warpgroup fences and register hand-over.
//
// A panel holds R rows of DP bf16 (DP a multiple of 32) as DP / 32
// sub-tiles of [R][32], each 64-byte row swizzled as the 64-byte swizzle
// mode lays it out (the 16-byte chunk c of row r at chunk c ^ ((r >> 1) & 3);
// the pattern repeats every 512 bytes, so every sub-tile starts 512-aligned).
// The same panel is read by wgmma two ways (PTX ISA, "Matrix Descriptor
// Format"; CUTLASS's canonical GMMA layouts):
//   K-major, the row's columns the product's K: 8-row groups 512 bytes
//     apart (SBO), the next 16 columns 32 bytes on within the 64-byte row,
//     the next 32 in the next sub-tile;
//   MN-major (transposed), the row index the product's K: the next 8 rows
//     512 bytes on (SBO), the next 32 columns of M or N in the next sub-tile
//     (LBO = its size), the next 16 rows 1024 bytes on.
// The 64-byte swizzle, not the 128-byte one, so that padded head widths
// split into whole sub-tiles (DP 160 = 5 x 32) and a product can start at
// any 32-column boundary. TMA writes a box of [rows][32] in this layout
// (CU_TENSOR_MAP_SWIZZLE_64B).
#pragma once

#include <cuda.h>  // CUtensorMap and its enums; libcuda is reached at run time, not linked

#include "common.cuh"
#include "wgmma.cuh"

namespace hopper {

constexpr int ROW_BYTES = 64;    // bytes of a sub-tile row
constexpr int GROUP_BYTES = 512; // 8 rows

// byte offset of element (r, c) in a panel of `rows` rows
__device__ __forceinline__ uint32_t elem_at(int rows, int r, int c) {
  return (uint32_t)((c >> 5) * rows * ROW_BYTES + r * ROW_BYTES +
                    ((((c >> 3) & 3) ^ ((r >> 1) & 3)) << 4) + (c & 7) * 2);
}

// wgmma shared-memory descriptor, 64-byte swizzle
__device__ __forceinline__ uint64_t desc(uint32_t saddr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((saddr & 0x3FFFFu) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (2ull << 62);
}

// operand of a product whose K runs along the panel's columns: rows row0 ..
// row0 + 63 (or its N rows), columns 16 kk .. 16 kk + 15
__device__ __forceinline__ uint64_t desc_k(uint32_t panel, int rows, int row0, int kk) {
  return desc(panel + (uint32_t)((kk >> 1) * rows * ROW_BYTES + row0 * ROW_BYTES + (kk & 1) * 32),
              16, GROUP_BYTES);
}

// operand of a product whose K runs along the panel's rows: rows 16 kk ..
// 16 kk + 15, columns from sub-tile sub0 on
__device__ __forceinline__ uint64_t desc_mn(uint32_t panel, int rows, int sub0, int kk) {
  return desc(panel + (uint32_t)(sub0 * rows * ROW_BYTES + kk * 16 * ROW_BYTES),
              (uint32_t)(rows * ROW_BYTES), GROUP_BYTES);
}

// 4-byte cp.async (zero-filled when !valid), for rows of float scalars
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(valid ? 4 : 0));
}

// 2^x on the SFU, denormal results flushed to zero
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// --- mbarriers --------------------------------------------------------------

__device__ __forceinline__ void bar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void bar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

__device__ __forceinline__ void bar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

// --- TMA -----------------------------------------------------------------

// Tensor map of a (planes, rows, cols) array of `type`, elem_bytes an
// element, rows ld elements apart (ld * elem_bytes and the base 16-byte
// aligned), planes rows * ld apart, whose boxes are [box_rows][32] columns
// in `swizzle`; rows and columns past the end read as zeros, and are not
// written. cuTensorMapEncodeTiled lives in libcuda: its address comes from
// the runtime (cudaGetDriverEntryPointByVersion), so that the library
// links against the CUDA runtime alone. Returns a CUDA error code.
inline int encode_map(CUtensorMap* map, CUtensorMapDataType type, int elem_bytes,
                      CUtensorMapSwizzle swizzle, const void* base, int planes, int rows,
                      int cols, int ld, int box_rows) {
  typedef CUresult (*Encode)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                             const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                             const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                             CUtensorMapL2promotion, CUtensorMapFloatOOBfill);
  static Encode encode = nullptr;
  if (encode == nullptr) {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found;
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &fn, 12000, cudaEnableDefault, &found);
    if (err != cudaSuccess) return (int)err;
    if (found != cudaDriverEntryPointSuccess || fn == nullptr)
      return (int)cudaErrorSymbolNotFound;
    encode = reinterpret_cast<Encode>(fn);
  }
  const cuuint64_t dims[3] = {(cuuint64_t)cols, (cuuint64_t)rows, (cuuint64_t)planes};
  const cuuint64_t strides[2] = {(cuuint64_t)ld * elem_bytes, (cuuint64_t)rows * ld * elem_bytes};
  const cuuint32_t box[3] = {32u, (cuuint32_t)box_rows, 1u};
  const cuuint32_t elem[3] = {1u, 1u, 1u};
  const CUresult r = encode(map, type, 3, const_cast<void*>(base), dims, strides, box, elem,
                            CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                            CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

// a bf16 array in sub-tiles: boxes of [box_rows][32] land as the panels
// above lay them out (the 64-byte swizzle)
inline int make_map(CUtensorMap* map, const void* base, int planes, int rows, int cols, int ld,
                    int box_rows) {
  return encode_map(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, CU_TENSOR_MAP_SWIZZLE_64B, base,
                    planes, rows, cols, ld, box_rows);
}

// a float32 (planes, rows, cols) array whose boxes are [box_rows][32] with
// the 128-byte swizzle: in shared memory, 128-byte rows whose 16-byte chunk
// c lies at chunk c ^ (row & 7) (the box 1024-byte aligned), for bulk
// reductions into it (f32_box_at)
inline int make_f32_map(CUtensorMap* map, const void* base, int planes, int rows, int cols,
                        int box_rows) {
  return encode_map(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, CU_TENSOR_MAP_SWIZZLE_128B, base,
                    planes, rows, cols, cols, box_rows);
}

// byte offset of element (r, c) of such a float32 box
__device__ __forceinline__ uint32_t f32_box_at(int r, int c) {
  return (uint32_t)(r * 128 + ((((c >> 2) ^ r) & 7) << 4) + (c & 3) * 4);
}

// a (planes, rows, DP) array of rows zero-padded to DP
inline int make_panel_map(CUtensorMap* map, const void* base, int planes, int rows, int dp,
                          int box_rows) {
  return make_map(map, base, planes, rows, dp, dp, box_rows);
}

// the arrival of the thread that starts a tile's copies, with the bytes
// they will bring
__device__ __forceinline__ void bar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// Copy rows row0 .. row0 + box_rows - 1 of plane `plane` into a panel of
// box_rows rows, one box per sub-tile, completing on `bar`.
template <int DP>
__device__ __forceinline__ void tma_panel(unsigned char* panel, const CUtensorMap* map,
                                          int plane, int row0, int box_rows, uint64_t* bar) {
#pragma unroll
  for (int sub = 0; sub < DP / 32; ++sub)
    asm volatile(
        "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
        "[%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(smem_u32(panel + sub * box_rows * ROW_BYTES)),
        "l"(reinterpret_cast<uint64_t>(map)), "r"(sub * 32), "r"(row0), "r"(plane),
        "r"(smem_u32(bar))
        : "memory");
}

// One box [box_rows][32] at (col, row, plane) into a sub-tile, completing
// on `bar`.
__device__ __forceinline__ void tma_box(unsigned char* dst, const CUtensorMap* map, int col,
                                        int row, int plane, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(col), "r"(row), "r"(plane), "r"(smem_u32(bar))
      : "memory");
}

// Add a float32 box of shared memory into the array of a make_f32_map
// map at (col, row, plane), elements past the array's end dropped; one
// bulk-async group per commit. The shared box may be written again once
// bulk_wait_read says the group has read it.
__device__ __forceinline__ void tma_reduce_add(const void* box, const CUtensorMap* map, int col,
                                               int row, int plane) {
  asm volatile(
      "cp.reduce.async.bulk.tensor.3d.global.shared::cta.add.bulk_group [%0, {%2, %3, %4}], "
      "[%1];\n" ::"l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(box)), "r"(col), "r"(row),
      "r"(plane)
      : "memory");
}

__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// this thread's bulk-async groups but the last PENDING have read their
// shared memory (bulk_wait: and completed)
template <int PENDING>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(PENDING) : "memory");
}

template <int PENDING>
__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group %0;\n" ::"n"(PENDING) : "memory");
}

// A contiguous copy of `bytes` (a multiple of 16; both addresses 16-byte
// aligned) into shared memory, completing on `bar`.
__device__ __forceinline__ void bulk_copy(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// The same in pieces of at most 8 KB, so that the copy engine keeps several
// in flight.
__device__ __forceinline__ void bulk_copy_pieces(void* dst, const void* src, uint32_t bytes,
                                                 uint64_t* bar) {
  for (uint32_t o = 0; o < bytes; o += 8192)
    bulk_copy(static_cast<unsigned char*>(dst) + o, static_cast<const unsigned char*>(src) + o,
              bytes - o < 8192u ? bytes - o : 8192u, bar);
}

// Eight consecutive bf16 from element j (< 8) of two consecutive 16-byte
// granules, as four packed words: two word selects and a funnel shift, so
// that rows copied whole at any 2-byte offset unpack 16 bytes at a time
// (the granules of element e of a buffer are its (e / 8)-th and the next).
__device__ __forceinline__ uint4 shift8(const uint4& lo, const uint4& hi, int j) {
  const uint32_t w[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
  uint32_t a[6], b[5], r[4];
#pragma unroll
  for (int i = 0; i < 6; ++i) a[i] = (j & 4) ? w[i + 2] : w[i];
#pragma unroll
  for (int i = 0; i < 5; ++i) b[i] = (j & 2) ? a[i + 1] : a[i];
#pragma unroll
  for (int i = 0; i < 4; ++i) r[i] = (j & 1) ? __funnelshift_r(b[i], b[i + 1], 16) : b[i];
  return make_uint4(r[0], r[1], r[2], r[3]);
}

// the words of 8 packed bf16 with elements from `valid` on set to zero
__device__ __forceinline__ uint4 keep_first(uint4 v, int valid) {
  uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if (2 * i >= valid) w[i] = 0u;
    else if (2 * i + 1 >= valid) w[i] &= 0xffffu;
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// the threads of `count` (a multiple of 32) meet at named barrier `id`
__device__ __forceinline__ void named_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

// --- warpgroups -------------------------------------------------------------

// shared-memory writes of the generic proxy (st.shared, cp.async) made
// visible to wgmma's reads
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void mma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void mma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int PENDING>
__device__ __forceinline__ void mma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(PENDING) : "memory");
}

// keep the compiler from moving accumulator reads or writes across a wgmma
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// the same for A fragments an in-flight wgmma still reads: keeps their
// registers from being reused before the wait
template <int R>
__device__ __forceinline__ void fence_frags(uint32_t (&a)[R][4]) {
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(a[i][j])::"memory");
}

template <int REGS>
__device__ __forceinline__ void regs_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(REGS));
}

template <int REGS>
__device__ __forceinline__ void regs_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(REGS));
}

}  // namespace hopper
