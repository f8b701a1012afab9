// Causal GQA flash-attention backward, dQ, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
// grit_tpu/ops/flash_attention.py:_bwd_dq_kernel (with _dq_update),
// launched by flash_attention_bwd.
//
// What it computes, FlashAttention-2 style: with S = scale.Q.K^T, the
// forward's row logsumexp L and D = rowsum(dO * O) (a plain tensor op
// outside the kernel, as in JAX):
//   P = exp(S - L) (causal),  dS = P * (dO.V^T - D),  dQ = scale.dS.K.
//
// Design. One block of four warps per (b, h, 64-row q tile), looping over
// the kv tiles j <= i; each warp owns 16 query rows and accumulates its
// dQ rows in fp32 registers across the whole loop, so the sum over kv
// tiles runs in one fixed order with no atomics — the backward is
// bit-for-bit deterministic, which bit-identical continuation after a
// migration depends on. Q and dO (64 x 128) are staged once; each K/V
// tile is staged in shared memory and its three products (Q.K^T, dO.V^T,
// dS.K) run on the tensor cores (mma.sync m16n8k16, fp32 accumulate).
// Tiles above the diagonal are skipped, the diagonal tile zeroes P where
// cols > rows, and the longest rows are launched first.
//
// Numerics: dS is rounded to bf16 before the dS.K product (the Pallas
// kernel keeps it fp32); P, dP and the dQ accumulator stay fp32.
//
// What bounds it on the H100: operations (three S x S x hd / 2 products
// per (b, h) against O(S.hd) bytes). No load/compute overlap yet.

#include "flash_common.cuh"

namespace grit {

constexpr int BQ = 64;
constexpr int BK = 64;
constexpr int DQ_SMEM = (2 * BQ + 2 * BK) * LDS * (int)sizeof(bf16);

__global__ void __launch_bounds__(NTHREADS)
flash_bwd_dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, const bf16* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, bf16* __restrict__ dq,
                    int S, int H, int KVH, float scale, float scale_log2) {
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* sQ = reinterpret_cast<bf16*>(smem);
  bf16* sdO = sQ + BQ * LDS;
  bf16* sK = sdO + BQ * LDS;
  bf16* sV = sK + BK * LDS;

  const int qt = gridDim.x - 1 - blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (H / KVH);
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32, g = lane / 4, t = lane % 4;

  const long q_ld = (long)H * HD;
  const long kv_ld = (long)KVH * HD;
  const long q_off = ((long)b * S + (long)qt * BQ) * q_ld + (long)h * HD;
  const bf16* kb = k + (long)b * S * kv_ld + (long)kvh * HD;
  const bf16* vb = v + (long)b * S * kv_ld + (long)kvh * HD;

  load_tile<BQ>(sQ, q + q_off, q_ld, tid);
  load_tile<BQ>(sdO, dout + q_off, q_ld, tid);

  const int row_in_tile = warp * 16 + g;
  const long row_base = ((long)b * H + h) * S + (long)qt * BQ + row_in_tile;
  const float lse2[2] = {lse[row_base] * LOG2E, lse[row_base + 8] * LOG2E};
  const float dlt[2] = {delta[row_base], delta[row_base + 8]};

  float acc[HD / 8][4];
#pragma unroll
  for (int n = 0; n < HD / 8; ++n)
    acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

  for (int j = 0; j <= qt; ++j) {
    __syncthreads();
    load_tile<BK>(sK, kb + (long)j * BK * kv_ld, kv_ld, tid);
    load_tile<BK>(sV, vb + (long)j * BK * kv_ld, kv_ld, tid);
    __syncthreads();

    float s[BK / 8][4];
    float dp[BK / 8][4];
#pragma unroll
    for (int n = 0; n < BK / 8; ++n) {
      s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
      dp[n][0] = dp[n][1] = dp[n][2] = dp[n][3] = 0.f;
    }
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      uint32_t aq[4], ado[4];
      load_a(aq, sQ, warp * 16, kk * 16, g, t);
      load_a(ado, sdO, warp * 16, kk * 16, g, t);
#pragma unroll
      for (int n = 0; n < BK / 8; ++n) {
        uint32_t bk[2], bv[2];
        load_b_nmajor(bk, sK, n * 8, kk * 16, g, t);
        load_b_nmajor(bv, sV, n * 8, kk * 16, g, t);
        mma_bf16(s[n], aq, bk);
        mma_bf16(dp[n], ado, bv);
      }
    }

    const bool diag = (j == qt);
#pragma unroll
    for (int n = 0; n < BK / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        const int row = row_in_tile + r * 8;
        const int col = n * 8 + 2 * t + (e & 1);
        float p = exp2f(s[n][e] * scale_log2 - lse2[r]);
        if (diag && col > row) p = 0.f;
        s[n][e] = p * (dp[n][e] - dlt[r]);  // dS
      }
    }

#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      uint32_t a[4];
      acc_to_a(a, s, kk);
#pragma unroll
      for (int n = 0; n < HD / 8; ++n) {
        uint32_t bb[2];
        load_b_kmajor(bb, sK, kk * 16, n * 8, g, t);
        mma_bf16(acc[n], a, bb);
      }
    }
  }

  store_rows(dq + q_off, q_ld, row_in_tile, acc, scale, scale, t);
}

}  // namespace grit

extern "C" int grit_flash_bwd_dq(const void* q, const void* k, const void* v,
                                 const void* dout, const void* lse,
                                 const void* delta, void* dq, int B, int S,
                                 int H, int KVH, float scale, void* stream) {
  using namespace grit;
  if (B <= 0 || S <= 0 || S % BQ != 0 || KVH <= 0 || H % KVH != 0)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      DQ_SMEM);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(S / BQ, H, B);
  flash_bwd_dq_kernel<<<grid, NTHREADS, DQ_SMEM, (cudaStream_t)stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (const bf16*)dout,
      (const float*)lse, (const float*)delta, (bf16*)dq, S, H, KVH, scale,
      scale * LOG2E);
  return (int)cudaGetLastError();
}
