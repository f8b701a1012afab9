// Shared pieces of the three flash-attention kernels (sm_90a).
//
// Layouts: q/o/dO are (B, S, H, 128) bf16, k/v (B, S, KVH, 128) bf16, all
// contiguous, read through their row strides (H*128, KVH*128) so the
// wrapper never materialises the (B, H, S, hd) transposes the Pallas
// wrapper makes. lse/delta are (B, H, S) fp32.
//
// Constants and small helpers of all three kernels; their TMA, mbarrier
// and wgmma pieces are in hopper.cuh.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace grit {

typedef __nv_bfloat16 bf16;

constexpr int HD = 128;          // head dim the kernels are built for
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

}  // namespace grit
