// Causal GQA flash-attention backward, dK and dV, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
// grit_tpu/ops/flash_attention.py:_bwd_dkv_kernel (with _dkv_update),
// launched by flash_attention_bwd.
//
// What it computes: for each kv head, summed over the q heads of its
// group and the query rows i >= the key row,
//   dV = P^T.dO,   dK = scale.dS^T.Q,
// with P = exp(scale.Q.K^T - L) (causal) and dS = P * (dO.V^T - D).
//
// Design. One block of four warps per (b, kv head, 64-row kv tile); each
// warp owns 16 key rows and works on the transposed problem, so its
// scores S^T = K.Q^T have key rows and query columns. The block loops
// over the q heads of its kv head's group and, for each, over the 32-row
// q tiles at or below the diagonal, staging Q, dO, L and D per tile.
// dK and dV accumulate in fp32 registers through the whole loop, group
// heads included: the GQA group sum that the TPU kernel leaves to a
// separate pass over per-head partials happens here, in one fixed order,
// with no atomics and no partial buffers — deterministic, and dK/dV are
// written once in bf16. The four products (K.Q^T, V.dO^T, P^T.dO,
// dS^T.Q) run on the tensor cores (mma.sync m16n8k16, fp32 accumulate).
// Kv tiles near the start of the sequence have the most q tiles to walk
// and come first in the grid.
//
// Numerics: P^T and dS^T are rounded to bf16 before their products with
// dO and Q (the Pallas kernel keeps them fp32); all sums stay fp32.
//
// What bounds it on the H100: operations (four S x S x hd / 2 products
// per (b, h)). No load/compute overlap yet.

#include "flash_common.cuh"

namespace grit {

constexpr int BKV = 64;  // key rows per block
constexpr int BQT = 32;  // query rows per staged tile
constexpr int DKV_SMEM =
    (2 * BKV + 2 * BQT) * LDS * (int)sizeof(bf16) + 2 * BQT * (int)sizeof(float);

__global__ void __launch_bounds__(NTHREADS)
flash_bwd_dkv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, const bf16* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, bf16* __restrict__ dk,
                     bf16* __restrict__ dv, int S, int H, int KVH, float scale,
                     float scale_log2) {
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* sK = reinterpret_cast<bf16*>(smem);
  bf16* sV = sK + BKV * LDS;
  bf16* sQ = sV + BKV * LDS;
  bf16* sdO = sQ + BQT * LDS;
  float* sL = reinterpret_cast<float*>(sdO + BQT * LDS);  // L * log2e
  float* sD = sL + BQT;

  const int kt = blockIdx.x;
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  const int groups = H / KVH;
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32, g = lane / 4, t = lane % 4;

  const long q_ld = (long)H * HD;
  const long kv_ld = (long)KVH * HD;
  const long kv_off = ((long)b * S + (long)kt * BKV) * kv_ld + (long)kvh * HD;
  load_tile<BKV>(sK, k + kv_off, kv_ld, tid);
  load_tile<BKV>(sV, v + kv_off, kv_ld, tid);

  const int key_row = kt * BKV + warp * 16 + g;  // absolute; and + 8

  float dk_acc[HD / 8][4];
  float dv_acc[HD / 8][4];
#pragma unroll
  for (int n = 0; n < HD / 8; ++n) {
    dk_acc[n][0] = dk_acc[n][1] = dk_acc[n][2] = dk_acc[n][3] = 0.f;
    dv_acc[n][0] = dv_acc[n][1] = dv_acc[n][2] = dv_acc[n][3] = 0.f;
  }

  for (int gi = 0; gi < groups; ++gi) {
    const int h = kvh * groups + gi;
    const long row_base = ((long)b * H + h) * S;
    for (int i = kt * BKV / BQT; i < S / BQT; ++i) {
      __syncthreads();  // every warp is done with the previous q tile
      const long q_off = ((long)b * S + (long)i * BQT) * q_ld + (long)h * HD;
      load_tile<BQT>(sQ, q + q_off, q_ld, tid);
      load_tile<BQT>(sdO, dout + q_off, q_ld, tid);
      if (tid < BQT) {
        sL[tid] = lse[row_base + (long)i * BQT + tid] * LOG2E;
        sD[tid] = delta[row_base + (long)i * BQT + tid];
      }
      __syncthreads();

      float st[BQT / 8][4];   // S^T = K.Q^T, then P^T
      float dpt[BQT / 8][4];  // dP^T = V.dO^T, then dS^T
#pragma unroll
      for (int n = 0; n < BQT / 8; ++n) {
        st[n][0] = st[n][1] = st[n][2] = st[n][3] = 0.f;
        dpt[n][0] = dpt[n][1] = dpt[n][2] = dpt[n][3] = 0.f;
      }
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        uint32_t ak[4], av[4];
        load_a(ak, sK, warp * 16, kk * 16, g, t);
        load_a(av, sV, warp * 16, kk * 16, g, t);
#pragma unroll
        for (int n = 0; n < BQT / 8; ++n) {
          uint32_t bq[2], bdo[2];
          load_b_nmajor(bq, sQ, n * 8, kk * 16, g, t);
          load_b_nmajor(bdo, sdO, n * 8, kk * 16, g, t);
          mma_bf16(st[n], ak, bq);
          mma_bf16(dpt[n], av, bdo);
        }
      }

#pragma unroll
      for (int n = 0; n < BQT / 8; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int qc = n * 8 + 2 * t + (e & 1);  // query row within tile
          const int krow = key_row + (e >> 1) * 8;
          float p = exp2f(st[n][e] * scale_log2 - sL[qc]);
          if (i * BQT + qc < krow) p = 0.f;  // causal: query before key
          st[n][e] = p;
          dpt[n][e] = p * (dpt[n][e] - sD[qc]);
        }
      }

#pragma unroll
      for (int kk = 0; kk < BQT / 16; ++kk) {
        uint32_t ap[4], ads[4];
        acc_to_a(ap, st, kk);
        acc_to_a(ads, dpt, kk);
#pragma unroll
        for (int n = 0; n < HD / 8; ++n) {
          uint32_t bdo[2], bq[2];
          load_b_kmajor(bdo, sdO, kk * 16, n * 8, g, t);
          load_b_kmajor(bq, sQ, kk * 16, n * 8, g, t);
          mma_bf16(dv_acc[n], ap, bdo);
          mma_bf16(dk_acc[n], ads, bq);
        }
      }
    }
  }

  const int row_in_tile = warp * 16 + g;
  store_rows(dk + kv_off, kv_ld, row_in_tile, dk_acc, scale, scale, t);
  store_rows(dv + kv_off, kv_ld, row_in_tile, dv_acc, 1.f, 1.f, t);
}

}  // namespace grit

extern "C" int grit_flash_bwd_dkv(const void* q, const void* k, const void* v,
                                  const void* dout, const void* lse,
                                  const void* delta, void* dk, void* dv,
                                  int B, int S, int H, int KVH, float scale,
                                  void* stream) {
  using namespace grit;
  if (B <= 0 || S <= 0 || S % BKV != 0 || KVH <= 0 || H % KVH != 0)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      DKV_SMEM);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(S / BKV, KVH, B);
  flash_bwd_dkv_kernel<<<grid, NTHREADS, DKV_SMEM, (cudaStream_t)stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (const bf16*)dout,
      (const float*)lse, (const float*)delta, (bf16*)dk, (bf16*)dv, S, H, KVH,
      scale, scale * LOG2E);
  return (int)cudaGetLastError();
}
