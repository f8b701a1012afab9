// Causal GQA flash-attention forward for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel grit_tpu/ops/flash_attention.py:_kernel
// (with _online_update and _diag_mask), launched by flash_attention.
//
// What it computes: per (b, h) O = softmax(scale.Q.K^T, causal).V and the
// row logsumexp LSE = m + log(l), the only residual the backward needs.
// Query head h reads kv head h / (H / KVH).
//
// Design. One block of four warps per (b, h, 64-row q tile); each warp
// owns 16 query rows. An in-block loop over the kv tiles j <= i takes
// the place of the TPU kernel's sequential kv grid axis: the K and V
// tiles (64 x 128 bf16, 16 KB each) are staged in shared memory, scores
// S = Q.K^T and the update O += P.V run on the tensor cores
// (mma.sync m16n8k16, fp32 accumulate), and the running max m, sum l and
// the O accumulator stay in registers in fp32. Tiles above the diagonal
// are never loaded; the diagonal tile masks cols > rows. Blocks with the
// most kv tiles are launched first (reversed q-tile order) so the long
// rows do not trail at the end of the grid.
//
// Numerics: the softmax runs in the log2 domain (exp2f of scale.log2e.S).
// P is rounded to bf16 before the P.V product, as FlashAttention-2 does;
// the Pallas kernel keeps P in fp32. The sum l is taken over the fp32 P,
// so the rounding only perturbs each P.V term by one bf16 ulp (2^-8
// relative), which is what the tolerance against the plain version
// allows for.
//
// What bounds it on the H100: operations. Causal attention at the
// training shape does 2.S^2.hd/2 multiply-adds per (b, h) in each of the
// two products against 2.S.hd bytes per row read, well above the card's
// ~295 operations per byte. This first version uses mma.sync without a
// cp.async/TMA pipeline, so loads and products do not overlap; wgmma and
// a TMA ring are the later step.

#include "flash_common.cuh"

namespace grit {

constexpr int BQ = 64;
constexpr int BK = 64;
constexpr int FWD_SMEM = (BQ + 2 * BK) * LDS * (int)sizeof(bf16);

__global__ void __launch_bounds__(NTHREADS)
flash_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, bf16* __restrict__ o,
                 float* __restrict__ lse, int S, int H, int KVH,
                 float scale_log2) {
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* sQ = reinterpret_cast<bf16*>(smem);
  bf16* sK = sQ + BQ * LDS;
  bf16* sV = sK + BK * LDS;

  const int qt = gridDim.x - 1 - blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (H / KVH);
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32, g = lane / 4, t = lane % 4;

  const long q_ld = (long)H * HD;
  const long kv_ld = (long)KVH * HD;
  const bf16* qb = q + ((long)b * S + (long)qt * BQ) * q_ld + (long)h * HD;
  const bf16* kb = k + (long)b * S * kv_ld + (long)kvh * HD;
  const bf16* vb = v + (long)b * S * kv_ld + (long)kvh * HD;

  load_tile<BQ>(sQ, qb, q_ld, tid);

  float acc[HD / 8][4];
#pragma unroll
  for (int n = 0; n < HD / 8; ++n)
    acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  float m_run[2] = {-INFINITY, -INFINITY};
  float l_run[2] = {0.f, 0.f};
  const int row_in_tile = warp * 16 + g;  // and row_in_tile + 8

  for (int j = 0; j <= qt; ++j) {
    __syncthreads();  // every warp is done with the previous K/V tile
    load_tile<BK>(sK, kb + (long)j * BK * kv_ld, kv_ld, tid);
    load_tile<BK>(sV, vb + (long)j * BK * kv_ld, kv_ld, tid);
    __syncthreads();

    float s[BK / 8][4];
#pragma unroll
    for (int n = 0; n < BK / 8; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      uint32_t a[4];
      load_a(a, sQ, warp * 16, kk * 16, g, t);
#pragma unroll
      for (int n = 0; n < BK / 8; ++n) {
        uint32_t bb[2];
        load_b_nmajor(bb, sK, n * 8, kk * 16, g, t);
        mma_bf16(s[n], a, bb);
      }
    }

    const bool diag = (j == qt);
    float mx[2] = {m_run[0], m_run[1]};
#pragma unroll
    for (int n = 0; n < BK / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = row_in_tile + (e >> 1) * 8;
        const int col = n * 8 + 2 * t + (e & 1);
        float x = s[n][e] * scale_log2;
        if (diag && col > row) x = -INFINITY;
        s[n][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    }
    // Every row sees column 0 in tile 0, so mx is finite from here on.
    mx[0] = quad_max(mx[0]);
    mx[1] = quad_max(mx[1]);
    const float alpha0 = exp2f(m_run[0] - mx[0]);
    const float alpha1 = exp2f(m_run[1] - mx[1]);
    m_run[0] = mx[0];
    m_run[1] = mx[1];
    l_run[0] *= alpha0;
    l_run[1] *= alpha1;
#pragma unroll
    for (int n = 0; n < HD / 8; ++n) {
      acc[n][0] *= alpha0;
      acc[n][1] *= alpha0;
      acc[n][2] *= alpha1;
      acc[n][3] *= alpha1;
    }
#pragma unroll
    for (int n = 0; n < BK / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = exp2f(s[n][e] - m_run[e >> 1]);
        s[n][e] = p;
        l_run[e >> 1] += p;  // per-lane partial; summed over the quad below
      }
    }

#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      uint32_t a[4];
      acc_to_a(a, s, kk);
#pragma unroll
      for (int n = 0; n < HD / 8; ++n) {
        uint32_t bb[2];
        load_b_kmajor(bb, sV, kk * 16, n * 8, g, t);
        mma_bf16(acc[n], a, bb);
      }
    }
  }

  const float l0 = quad_sum(l_run[0]);
  const float l1 = quad_sum(l_run[1]);
  bf16* ob = o + ((long)b * S + (long)qt * BQ) * q_ld + (long)h * HD;
  store_rows(ob, q_ld, row_in_tile, acc, 1.f / l0, 1.f / l1, t);
  if (t == 0) {
    float* lb = lse + ((long)b * H + h) * S + (long)qt * BQ;
    lb[row_in_tile] = (m_run[0] + log2f(l0)) * LN2;
    lb[row_in_tile + 8] = (m_run[1] + log2f(l1)) * LN2;
  }
}

}  // namespace grit

// Plain C entry (bound with ctypes). Returns the cudaError_t of the
// launch; 0 means the kernel was queued on `stream`.
extern "C" int grit_flash_fwd(const void* q, const void* k, const void* v,
                              void* o, void* lse, int B, int S, int H,
                              int KVH, float scale, void* stream) {
  using namespace grit;
  if (B <= 0 || S <= 0 || S % BQ != 0 || KVH <= 0 || H % KVH != 0)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, FWD_SMEM);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(S / BQ, H, B);
  flash_fwd_kernel<<<grid, NTHREADS, FWD_SMEM, (cudaStream_t)stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (bf16*)o, (float*)lse,
      S, H, KVH, scale * LOG2E);
  return (int)cudaGetLastError();
}
