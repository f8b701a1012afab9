// Shared pieces of the three flash-attention kernels (sm_90a).
//
// Layouts: q/o/dO are (B, S, H, 128) bf16, k/v (B, S, KVH, 128) bf16, all
// contiguous, read through their row strides (H*128, KVH*128) so the
// wrapper never materialises the (B, H, S, hd) transposes the Pallas
// wrapper makes. lse/delta are (B, H, S) fp32.
//
// Products run on the tensor cores through mma.sync.m16n8k16 (bf16 in,
// fp32 accumulate). Tiles live in shared memory with rows padded by 8
// bf16 (272-byte rows), which spreads every fragment load below over all
// 32 banks.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace grit {

typedef __nv_bfloat16 bf16;

constexpr int HD = 128;          // head dim the kernels are built for
constexpr int LDS = HD + 8;      // shared-memory row stride, elements
constexpr int NTHREADS = 128;    // four warps per block
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

// Copy a (rows x 128) bf16 tile from global (row stride `ld` elements)
// into shared memory (row stride LDS), 16 bytes per thread per step.
template <int ROWS>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src,
                                          long ld, int tid) {
#pragma unroll
  for (int idx = tid; idx < ROWS * (HD / 8); idx += NTHREADS) {
    const int r = idx / (HD / 8);
    const int c = (idx % (HD / 8)) * 8;
    *reinterpret_cast<uint4*>(dst + r * LDS + c) =
        *reinterpret_cast<const uint4*>(src + r * ld + c);
  }
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t ld_u32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack_u16(const bf16* lo, const bf16* hi) {
  const uint32_t a = *reinterpret_cast<const uint16_t*>(lo);
  const uint32_t b = *reinterpret_cast<const uint16_t*>(hi);
  return a | (b << 16);
}

// Fragment loaders for mma.m16n8k16 (lane = 4*g + t).
//
// A (16x16, row-major source M[m][k]) at (m0, k0).
__device__ __forceinline__ void load_a(uint32_t (&a)[4], const bf16* M,
                                       int m0, int k0, int g, int t) {
  const bf16* p = M + (m0 + g) * LDS + k0 + 2 * t;
  a[0] = ld_u32(p);
  a[1] = ld_u32(p + 8 * LDS);
  a[2] = ld_u32(p + 8);
  a[3] = ld_u32(p + 8 * LDS + 8);
}

// B (16x8) whose source is stored n-major, N[n][k] (k contiguous): the
// K tile of Q.K^T, the V tile of dO.V^T.
__device__ __forceinline__ void load_b_nmajor(uint32_t (&b)[2], const bf16* N,
                                              int n0, int k0, int g, int t) {
  const bf16* p = N + (n0 + g) * LDS + k0 + 2 * t;
  b[0] = ld_u32(p);
  b[1] = ld_u32(p + 8);
}

// B (16x8) whose source is stored k-major, K[k][n] (n contiguous): the V
// tile of P.V, the K tile of dS.K, the dO/Q tiles of P^T.dO and dS^T.Q.
__device__ __forceinline__ void load_b_kmajor(uint32_t (&b)[2], const bf16* K,
                                              int k0, int n0, int g, int t) {
  const bf16* p = K + (k0 + 2 * t) * LDS + n0 + g;
  b[0] = pack_u16(p, p + LDS);
  b[1] = pack_u16(p + 8 * LDS, p + 9 * LDS);
}

// D += A.B, 16x8x16, bf16 inputs, fp32 accumulate. Accumulator layout:
// d[0], d[1] at row g, cols 2t, 2t+1; d[2], d[3] at row g+8.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Re-read two adjacent 16x8 accumulator tiles (columns 16*kk .. 16*kk+15
// of a 16-row score block) as the A operand of the next product, rounded
// to bf16. The accumulator layout of tiles 2kk, 2kk+1 is exactly the A
// fragment layout, so no data moves between lanes.
template <int N>
__device__ __forceinline__ void acc_to_a(uint32_t (&a)[4], const float (&s)[N][4],
                                         int kk) {
  a[0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
  a[1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
  a[2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
  a[3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// Write a warp's 16 x 128 fp32 accumulator, times `mul`, as bf16 rows
// `row0` and `row0 + 8` of a (.., ld)-strided bf16 matrix.
__device__ __forceinline__ void store_rows(bf16* dst, long ld, int row0,
                                           const float (&acc)[HD / 8][4],
                                           float mul0, float mul1, int t) {
#pragma unroll
  for (int n = 0; n < HD / 8; ++n) {
    const int col = n * 8 + 2 * t;
    *reinterpret_cast<uint32_t*>(dst + row0 * ld + col) =
        pack_bf16(acc[n][0] * mul0, acc[n][1] * mul0);
    *reinterpret_cast<uint32_t*>(dst + (row0 + 8) * ld + col) =
        pack_bf16(acc[n][2] * mul1, acc[n][3] * mul1);
  }
}

}  // namespace grit
