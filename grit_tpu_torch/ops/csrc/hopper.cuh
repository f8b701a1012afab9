// Hopper pieces of the three flash-attention kernels (sm_90a): TMA tile
// loads into 128-byte-swizzled shared memory, mbarriers, wgmma
// products read from that memory through matrix descriptors, and the
// register hand-over between producer and consumer warpgroups.
//
// Tile layout. Every bf16 tile of R rows x 128 (head dim) is loaded by
// two TMA boxes of R x 64 (128 bytes a row, the 128B-swizzle span): the
// columns 0-63 land at the tile's start, the columns 64-127 R * 128
// bytes after it. Inside a half, row r sits at r * 128 bytes with its
// eight 16-byte chunks permuted by chunk ^ (r % 8). Eight rows (1024
// bytes) form one swizzle atom, so tiles start on 1024-byte boundaries.
//
// The same memory serves wgmma two ways:
//  - K-major (rows are the M or N dimension, the head dim is the
//    reduction): Q and K in Q.K^T, dO and V in dO.V^T, K and Q in K.Q^T,
//    V and dO in V.dO^T. One k16 step is 32 bytes further into the row;
//    steps 4-7 read the second half.
//  - MN-major (rows are the reduction, the head dim is N): V in P.V, K in
//    dS.K, dO and Q in P^T.dO and dS^T.Q. One k16 step is 16 rows (2048
//    bytes) further; the two halves are the two 64-wide atoms along N,
//    R * 128 bytes apart (the descriptor's leading byte offset), and 8-row
//    groups are 1024 bytes apart (its stride byte offset).
#pragma once

#include <cuda.h>
#include "flash_common.cuh"

namespace grit {

constexpr int HALF_COLS = 64;     // head-dim columns in one TMA box
constexpr int ROW_BYTES = 128;    // bytes of one swizzled box row
constexpr int ATOM_BYTES = 1024;  // 8 rows x 128 bytes

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// -- mbarriers ----------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// Arrive once and expect `bytes` more from asynchronous copies.
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// Block until the barrier's phase of this parity has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  } while (!done);
}

// -- TMA ------------------------------------------------------------------------

// One box of a 3-D tensor map (head dim, head, row) into shared memory;
// completion is counted in bytes on `bar`.
__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// A whole R x 128 tile: both 64-column boxes.
__device__ __forceinline__ void tma_load_tile(uint32_t dst, const CUtensorMap* map,
                                              uint32_t bar, int head, int row,
                                              int rows) {
  tma_load_3d(dst, map, bar, 0, head, row);
  tma_load_3d(dst + rows * ROW_BYTES, map, bar, HALF_COLS, head, row);
}

// Contiguous bytes (a multiple of 16, 16-byte aligned) into shared memory.
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar) : "memory");
}

// -- warpgroup registers --------------------------------------------------------

template <int N>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}

template <int N>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}

// -- named barriers --------------------------------------------------------------

// Barrier `id` (1-15; 0 is __syncthreads) over `count` threads: sync
// waits for all of them, arrive counts this thread without waiting.
__device__ __forceinline__ void named_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

__device__ __forceinline__ void named_arrive(int id, int count) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

// -- wgmma ----------------------------------------------------------------------

// Shared-memory matrix descriptor, 128-byte swizzle. `lbo` is ignored by
// K-major operands.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

// Descriptor of k16 step `kk` (0..7 over the head dim) of a K-major tile
// of `rows` rows, starting at row `row0`.
__device__ __forceinline__ uint64_t kmajor_desc(uint32_t tile, int rows,
                                                int row0, int kk) {
  return sw128_desc(tile + (kk / 4) * rows * ROW_BYTES + row0 * ROW_BYTES +
                        (kk % 4) * 32,
                    16, ATOM_BYTES);
}

// Descriptor of k16 step `kk` (rows 16kk..16kk+15) of an MN-major tile of
// `rows` rows, N = the full head dim.
__device__ __forceinline__ uint64_t mnmajor_desc(uint32_t tile, int rows,
                                                 int kk) {
  return sw128_desc(tile + kk * 16 * ROW_BYTES, rows * ROW_BYTES, ATOM_BYTES);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keep the compiler from moving reads or writes of accumulator registers
// across the asynchronous products (wgmma writes them behind its back).
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// 2^x on the special-function unit, subnormal results flushed to zero
// (exp2f adds a range fix-up of three instructions around the same op).
// Softmax terms below 2^-126 of the row maximum vanish either way.
__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Accumulator layout of m64nNk16 (fp32), thread `tid` of the warpgroup,
// warp w = tid / 32, g = lane / 4, t = lane % 4: d[4j + e] sits at row
// 16w + g + 8 * (e >> 1), column 8j + 2t + (e & 1) — the mma.sync m16n8
// layout, one 16-row slab per warp. The A-from-registers fragment of a
// k16 step is the same layout over two adjacent 8-column blocks, so a
// score accumulator becomes the next product's A operand in place.
template <int N>
__device__ __forceinline__ void acc_to_a_flat(uint32_t (&a)[4], const float (&s)[N],
                                              int kk) {
  a[0] = pack_bf16(s[8 * kk + 0], s[8 * kk + 1]);
  a[1] = pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
  a[2] = pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
  a[3] = pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
}

// D[64 x 128] (+)= A.B^T: A (64 x 16) and B (128 x 16) both K-major in
// shared memory, described by 128B-swizzle descriptors. `accumulate` 0
// overwrites D.
__device__ __forceinline__ void wgmma_ss_m64n128(float (&d)[64], uint64_t da,
                                                uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(accumulate));
}

// D[64 x 64] (+)= A.B^T: A (64 x 16) and B (64 x 16) both K-major in
// shared memory, described by 128B-swizzle descriptors. `accumulate` 0
// overwrites D.
__device__ __forceinline__ void wgmma_ss_m64n64(float (&d)[32], uint64_t da,
                                                uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

// D[64 x 128] (+)= A.B: A (64 x 16 bf16) in registers in the accumulator
// fragment layout (see acc_to_a_flat), B (16 x 128) MN-major in shared memory
// (transpose flag set), described by a 128B-swizzle descriptor.
__device__ __forceinline__ void wgmma_rs_m64n128_mn(float (&d)[64],
                                                   const uint32_t (&a)[4],
                                                   uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate));
}

// Write a warpgroup's 64 x 128 fp32 accumulator, rows `row0` and
// `row0 + 8` times `mul0` and `mul1`, as bf16 into a (.., ld)-strided
// matrix.
__device__ __forceinline__ void store_acc_rows(bf16* dst, long ld, int row0,
                                               const float (&d)[64], float mul0,
                                               float mul1, int t) {
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const int col = j * 8 + 2 * t;
    *reinterpret_cast<uint32_t*>(dst + row0 * ld + col) =
        pack_bf16(d[4 * j] * mul0, d[4 * j + 1] * mul0);
    *reinterpret_cast<uint32_t*>(dst + (row0 + 8) * ld + col) =
        pack_bf16(d[4 * j + 2] * mul1, d[4 * j + 3] * mul1);
  }
}

// -- persistent blocks -------------------------------------------------------------

// Item of round r for block `cta` of G resident blocks, over a list of
// work items sorted longest first: r * G + cta in even rounds and
// r * G + G - 1 - cta in odd ones. The snake evens out the work each
// block walks without an atomic counter, and a block's item for a round
// depends only on (r, cta, G), so every item is summed the same way
// whichever block takes it.
__device__ __forceinline__ int snake_item(int r, int cta, int G) {
  return r * G + ((r & 1) ? G - 1 - cta : cta);
}

// Work item w of the forward and dQ kernels: (q tile, head, batch), q
// tiles longest first, so the heaviest items start first.
struct QWork {
  int qt, h, b;
};

__device__ __forceinline__ QWork q_work_item(int w, int nqt, int H, int B) {
  const int rem = w % (H * B);
  return {nqt - 1 - w / (H * B), rem % H, rem / H};
}

// Blocks of a persistent kernel that fits once per SM: one per SM, or
// one per work item if there are fewer. Returns a cudaError_t.
static int persistent_grid(long n_work, unsigned* grid) {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  *grid = (unsigned)(n_work < sms ? n_work : sms);
  return 0;
}

// -- host: tensor maps ----------------------------------------------------------

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                  void*, const cuuint64_t*, const cuuint64_t*,
                                  const cuuint32_t*, const cuuint32_t*,
                                  CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

// The driver's cuTensorMapEncodeTiled, found through the runtime so the
// library needs no link against libcuda.
static EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = []() -> EncodeTiledFn {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                              cudaEnableDefault, &found);
#endif
    if (err != cudaSuccess || found != cudaDriverEntryPointSuccess)
      return nullptr;
    return reinterpret_cast<EncodeTiledFn>(p);
  }();
  return fn;
}

// Map over a contiguous (rows, heads, 128) bf16 tensor — (B * S, H, 128)
// for q/o/dO, (B * S, KVH, 128) for k/v — read in boxes of `box_rows`
// rows x 64 columns of one head, 128B-swizzled. Returns a cudaError_t.
static int make_head_map(CUtensorMap* map, const void* base, int heads,
                         long rows, int box_rows) {
  EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return (int)cudaErrorSymbolNotFound;
  const cuuint64_t dims[3] = {(cuuint64_t)HD, (cuuint64_t)heads,
                              (cuuint64_t)rows};
  const cuuint64_t strides[2] = {(cuuint64_t)HD * sizeof(bf16),
                                 (cuuint64_t)heads * HD * sizeof(bf16)};
  const cuuint32_t box[3] = {(cuuint32_t)HALF_COLS, 1, (cuuint32_t)box_rows};
  const cuuint32_t elem[3] = {1, 1, 1};
  CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
                  const_cast<void*>(base), dims, strides, box, elem,
                  CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                  CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                  CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

}  // namespace grit
