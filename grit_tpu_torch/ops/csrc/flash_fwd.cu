// Causal GQA flash-attention forward for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel grit_tpu/ops/flash_attention.py:_kernel
// (with _online_update and _diag_mask), launched by flash_attention.
//
// What it computes: per (b, h) O = softmax(scale.Q.K^T, causal).V and the
// row logsumexp LSE = m + log(l), the only residual the backward needs.
// Query head h reads kv head h / (H / KVH).
//
// Design, in the style of FlashAttention-3. A work item is one (b, h,
// 128-row q tile). The kernel is persistent: one block per SM (its
// shared memory admits no second), each walking a static list of work
// items, longest first and snaked over the blocks so every block walks
// about the same number of kv tiles (no atomic work counter). A block has
// three warpgroups. Warpgroup 0 is the producer: it gives its registers
// away (setmaxnreg) and one thread issues every load through TMA — an
// item's Q once the previous item's last Q.K^T has landed, then the K and
// V tiles (128 x 128 bf16 each) of the kv tiles j <= i into a ring of
// STAGES shared-memory stages that runs on across items, each stage
// guarded by a full/empty mbarrier pair — so loads run ahead of the
// products, and the next item's loads overlap this item's last tile and
// its output writes.
// Warpgroups 1 and 2 are consumers, 64 query rows each. For each kv tile
// a consumer computes S = Q.K^T with wgmma (m64n128k16, Q and K both
// K-major in swizzled shared memory), runs the online softmax on its fp32
// accumulator in registers (log2 domain; only the diagonal tile is
// masked, tiles above it are never loaded), turns P into bf16 register A
// operands in place (the accumulator layout is the A fragment layout) and
// adds P.V with wgmma (V the MN-major shared B operand). O, the running
// max m and sum l stay in fp32 registers. Two overlaps keep the tensor
// cores busy during the softmax: inside a consumer, tile j's Q.K^T is
// issued together with tile j-1's P.V, so the softmax of tile j runs
// while P.V does (a stage is held until its P.V lands, hence three
// stages); between the consumers, named barriers hand the turn to issue
// products back and forth (ping-pong), so one consumer's softmax runs
// while the other's products do.
//
// Numerics: P is rounded to bf16 before the P.V product, as
// FlashAttention-2 and -3 do; the Pallas kernel keeps P in fp32. The sum
// l is taken over the fp32 P, so the rounding only perturbs each P.V term
// by one bf16 ulp (2^-8 relative), which is what the tolerance against
// the plain version allows for. Every output is summed in one fixed
// order: the kernel is deterministic.
//
// What bounds it on the H100: operations. Causal attention at the
// training shape does 2.S^2.hd/2 multiply-adds per (b, h) in each of the
// two products against 2.S.hd bytes per row read, well above the card's
// ~295 operations per byte. What holds it above that bound (PERF.md):
// the K/V tiles are re-read from L2 by every q tile, and each score costs
// an FFMA and an ex2 besides its share of the products.

#include "hopper.cuh"

namespace grit {

constexpr int BQ = 128;                   // query rows per work item
constexpr int BK = 128;                   // key rows per kv tile
constexpr int STAGES = 3;                 // K/V ring depth
constexpr int TILE_BYTES = BK * HD * 2;   // one 128 x 128 bf16 tile
constexpr int Q_OFF = 0;
constexpr int KV_OFF = TILE_BYTES;        // stage s: K at +2s tiles, V after
constexpr int BAR_OFF = KV_OFF + STAGES * 2 * TILE_BYTES;
constexpr int FWD_SMEM = BAR_OFF + 128 + ATOM_BYTES;  // + alignment slack
constexpr int NTHREADS_FWD = 384;

// Online-softmax step over one tile's raw scores, in place: sc becomes P
// (fp32, log2 domain; with MASK, the diagonal tile, zero where col > row),
// m_run (the scaled running max) and l_run are updated, and alpha is the
// factor O must be rescaled by. Accumulator layout: sc[4j + e] is row
// row0 + 8 * (e >> 1), column 8j + 2t + (e & 1) (see hopper.cuh). The max
// is taken over the raw scores (scale > 0) and each term is one FFMA and
// one ex2; maxima and sums run in four interleaved partials per row.
template <bool MASK>
__device__ __forceinline__ void online_softmax(float (&sc)[64], float (&m_run)[2],
                                               float (&l_run)[2],
                                               float (&alpha)[2], int row0,
                                               int t, float scale_log2) {
  if (MASK) {
#pragma unroll
    for (int i = 0; i < 64; ++i) {
      const int row = row0 + ((i >> 1) & 1) * 8;
      const int col = (i >> 2) * 8 + 2 * t + (i & 1);
      if (col > row) sc[i] = -INFINITY;
    }
  }
  float mx[2][4], sum[2][4];
#pragma unroll
  for (int r = 0; r < 2; ++r)
#pragma unroll
    for (int k = 0; k < 4; ++k) mx[r][k] = -INFINITY, sum[r][k] = 0.f;
#pragma unroll
  for (int i = 0; i < 64; ++i)
    mx[(i >> 1) & 1][(i >> 2) & 3] = fmaxf(mx[(i >> 1) & 1][(i >> 2) & 3], sc[i]);
  float m_new[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    // Every row sees column 0 in tile 0, so the max is finite from here on.
    const float m = quad_max(fmaxf(fmaxf(mx[r][0], mx[r][1]),
                                   fmaxf(mx[r][2], mx[r][3])));
    m_new[r] = fmaxf(m_run[r], m * scale_log2);
    alpha[r] = exp2_ftz(m_run[r] - m_new[r]);
    m_run[r] = m_new[r];
  }
#pragma unroll
  for (int i = 0; i < 64; ++i) {
    const int r = (i >> 1) & 1;
    const float p = exp2_ftz(fmaf(sc[i], scale_log2, -m_new[r]));
    sc[i] = p;
    sum[r][(i >> 2) & 3] += p;  // per-lane partials; summed over the quad
  }
#pragma unroll
  for (int r = 0; r < 2; ++r)
    l_run[r] = l_run[r] * alpha[r] +
               ((sum[r][0] + sum[r][1]) + (sum[r][2] + sum[r][3]));
}

__global__ void __launch_bounds__(NTHREADS_FWD, 1)
flash_fwd_kernel(const __grid_constant__ CUtensorMap tm_q,
                 const __grid_constant__ CUtensorMap tm_k,
                 const __grid_constant__ CUtensorMap tm_v,
                 bf16* __restrict__ o, float* __restrict__ lse, int B, int S,
                 int H, int KVH, float scale_log2) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + ATOM_BYTES - 1) & ~(uint32_t)(ATOM_BYTES - 1);
  const uint32_t sQ = base + Q_OFF;
  // full[STAGES], empty[STAGES], then Q's full and empty barriers
  const uint32_t bars = base + BAR_OFF;
  auto sK = [&](int s) { return base + KV_OFF + 2 * s * TILE_BYTES; };
  auto sV = [&](int s) { return base + KV_OFF + (2 * s + 1) * TILE_BYTES; };
  auto full = [&](int s) { return bars + 8 * s; };
  auto empty = [&](int s) { return bars + 8 * (STAGES + s); };
  const uint32_t q_full = bars + 16 * STAGES;
  const uint32_t q_empty = q_full + 8;

  const int nqt = S / BQ;
  const int n_work = nqt * H * B;
  const int G = gridDim.x, cta = blockIdx.x;
  const int groups = H / KVH;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), 8);  // one arrival per consumer warp
    }
    mbar_init(q_full, 1);
    mbar_init(q_empty, 8);
    mbar_init_fence();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    // Producer: Q of each work item once its predecessor's last Q.K^T has
    // landed, then its K/V tiles through the ring, which runs on across
    // work items — the next item's loads overlap this one's tail.
    setmaxnreg_dec<24>();
    if (threadIdx.x == 0) {
      int it = 0;
      for (int r = 0, w; (w = snake_item(r, cta, G)) < n_work; ++r) {
        const QWork wk = q_work_item(w, nqt, H, B);
        const int kvh = wk.h / groups;
        mbar_wait(q_empty, (r & 1) ^ 1);
        mbar_expect_tx(q_full, TILE_BYTES);
        tma_load_tile(sQ, &tm_q, q_full, wk.h, wk.b * S + wk.qt * BQ, BQ);
        for (int j = 0; j <= wk.qt; ++j, ++it) {
          const int s = it % STAGES;
          mbar_wait(empty(s), ((it / STAGES) & 1) ^ 1);
          mbar_expect_tx(full(s), 2 * TILE_BYTES);
          tma_load_tile(sK(s), &tm_k, full(s), kvh, wk.b * S + j * BK, BK);
          tma_load_tile(sV(s), &tm_v, full(s), kvh, wk.b * S + j * BK, BK);
        }
      }
    }
  } else {
    // Consumers: warpgroup c owns query rows 64c .. 64c + 63 of a tile.
    setmaxnreg_inc<240>();
    const int c = wg - 1;
    const int tid = threadIdx.x % 128;
    const int warp = tid / 32, lane = tid % 32, g = lane / 4, t = lane % 4;
    const int row0 = c * 64 + warp * 16 + g;  // and row0 + 8, in the tile

    float acc[64];
    // S = Q.K_j^T for this warpgroup's rows, into sc.
    auto scores = [&](float (&sc)[64], int s) {
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk)
        wgmma_ss_m64n128(sc, kmajor_desc(sQ, BQ, c * 64, kk),
                         kmajor_desc(sK(s), BK, 0, kk), kk > 0);
      wgmma_commit();
    };
    // O += P.V_s.
    auto add_pv = [&](const uint32_t (&pa)[BK / 16][4], int s) {
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
        wgmma_rs_m64n128_mn(acc, pa[kk], mnmajor_desc(sV(s), BK, kk), 1);
      wgmma_commit();
    };
    auto release = [&](uint32_t bar) {
      __syncwarp();
      if (lane == 0) mbar_arrive(bar);
    };

    // Ping-pong between the two consumers: a warpgroup issues its products
    // only on its turn (named barrier 1 + c) and then passes the turn on,
    // so one warpgroup's softmax runs while the other's products occupy
    // the tensor cores. Consumer 1 lets consumer 0 go first and, to leave
    // no arrival pending at exit, skips its last hand-over. A work item of
    // n kv tiles is n + 1 turns.
    int n_turns = 0;
    for (int r = 0, w; (w = snake_item(r, cta, G)) < n_work; ++r)
      n_turns += q_work_item(w, nqt, H, B).qt + 2;
    int turn = 0;
    auto my_turn = [&]() { named_sync(1 + c, 256); };
    auto pass_turn = [&]() {
      if (c == 0 || ++turn < n_turns) named_arrive(2 - c, 256);
    };
    if (c == 1) named_arrive(1, 256);

    int it = 0;
    for (int r = 0, w; (w = snake_item(r, cta, G)) < n_work; ++r) {
      const QWork wk = q_work_item(w, nqt, H, B);
      const int qt = wk.qt;
#pragma unroll
      for (int i = 0; i < 64; ++i) acc[i] = 0.f;
      float m_run[2] = {-INFINITY, -INFINITY};
      float l_run[2] = {0.f, 0.f};

      // Inside a warpgroup, tile j's scores are computed while tile j-1's
      // P.V runs: the online softmax of tile j overlaps that product, and
      // O is rescaled by tile j's alpha once the product has landed. Q is
      // handed back as soon as the item's last Q.K^T has landed.
      float sc[64];
      uint32_t pa[BK / 16][4];
      float alpha[2];
      mbar_wait(q_full, r & 1);
      mbar_wait(full(it % STAGES), (it / STAGES) & 1);
      my_turn();
      wgmma_fence();
      scores(sc, it % STAGES);
      pass_turn();
      wgmma_wait<0>();
      fence_regs(sc);
      if (qt == 0) {
        release(q_empty);
        online_softmax<true>(sc, m_run, l_run, alpha, row0, t, scale_log2);
      } else {
        online_softmax<false>(sc, m_run, l_run, alpha, row0, t, scale_log2);
      }
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) acc_to_a_flat(pa[kk], sc, kk);
      for (int j = 1; j <= qt; ++j) {
        const int s = (it + j) % STAGES, prev = (it + j - 1) % STAGES;
        mbar_wait(full(s), ((it + j) / STAGES) & 1);
        my_turn();
        wgmma_fence();
        scores(sc, s);
        add_pv(pa, prev);
        pass_turn();
        wgmma_wait<1>();
        fence_regs(sc);
        if (j == qt) {
          release(q_empty);
          online_softmax<true>(sc, m_run, l_run, alpha, row0, t, scale_log2);
        } else {
          online_softmax<false>(sc, m_run, l_run, alpha, row0, t, scale_log2);
        }
        wgmma_wait<0>();
        fence_regs(acc);
        release(empty(prev));
#pragma unroll
        for (int i = 0; i < 64; ++i) acc[i] *= alpha[(i >> 1) & 1];
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk) acc_to_a_flat(pa[kk], sc, kk);
      }
      const int last = (it + qt) % STAGES;
      my_turn();
      wgmma_fence();
      add_pv(pa, last);
      pass_turn();
      wgmma_wait<0>();
      fence_regs(acc);
      release(empty(last));
      it += qt + 1;

      const float l0 = quad_sum(l_run[0]);
      const float l1 = quad_sum(l_run[1]);
      const long q_ld = (long)H * HD;
      bf16* ob = o + ((long)wk.b * S + (long)qt * BQ) * q_ld + (long)wk.h * HD;
      store_acc_rows(ob, q_ld, row0, acc, 1.f / l0, 1.f / l1, t);
      if (t == 0) {
        float* lb = lse + ((long)wk.b * H + wk.h) * S + (long)qt * BQ;
        lb[row0] = (m_run[0] + log2f(l0)) * LN2;
        lb[row0 + 8] = (m_run[1] + log2f(l1)) * LN2;
      }
    }
  }
}

}  // namespace grit

// Plain C entry (bound with ctypes). Builds the TMA maps of this call's
// tensors and returns the cudaError_t of the launch; 0 means the kernel
// was queued on `stream`.
extern "C" int grit_flash_fwd(const void* q, const void* k, const void* v,
                              void* o, void* lse, int B, int S, int H,
                              int KVH, float scale, void* stream) {
  using namespace grit;
  if (B <= 0 || S <= 0 || S % BQ != 0 || KVH <= 0 || H % KVH != 0)
    return (int)cudaErrorInvalidValue;
  CUtensorMap tm_q, tm_k, tm_v;
  int err = make_head_map(&tm_q, q, H, (long)B * S, BQ);
  if (err == 0) err = make_head_map(&tm_k, k, KVH, (long)B * S, BK);
  if (err == 0) err = make_head_map(&tm_v, v, KVH, (long)B * S, BK);
  if (err != 0) return err;
  cudaError_t cerr = cudaFuncSetAttribute(
      flash_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, FWD_SMEM);
  if (cerr != cudaSuccess) return (int)cerr;
  unsigned grid;
  err = persistent_grid((long)B * H * (S / BQ), &grid);
  if (err != 0) return err;
  flash_fwd_kernel<<<grid, NTHREADS_FWD, FWD_SMEM, (cudaStream_t)stream>>>(
      tm_q, tm_k, tm_v, (bf16*)o, (float*)lse, B, S, H, KVH, scale * LOG2E);
  return (int)cudaGetLastError();
}
