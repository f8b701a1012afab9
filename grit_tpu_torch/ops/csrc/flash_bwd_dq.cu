// Causal GQA flash-attention backward, dQ, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
// grit_tpu/ops/flash_attention.py:_bwd_dq_kernel (with _dq_update),
// launched by flash_attention_bwd.
//
// What it computes, FlashAttention-2 style: with S = scale.Q.K^T, the
// forward's row logsumexp L and D = rowsum(dO * O) (a plain tensor op
// outside the kernel, as in JAX):
//   P = exp(S - L) (causal),  dS = P * (dO.V^T - D),  dQ = scale.dS.K,
// query head h reading kv head h / (H / KVH).
//
// Design: the forward's shape of work (flash_fwd.cu). A work item is one
// (b, h, 128-row q tile). The kernel is persistent: one block per SM (its
// shared memory admits no second), each walking a static list of work
// items, longest first and snaked over the blocks (no atomic work
// counter). A block has three warpgroups. Warpgroup 0 is the producer: it
// gives its registers away (setmaxnreg) and one thread issues every load
// through TMA — an item's Q and dO tiles (128 x 128 bf16 each) once the
// previous item's last Q.K^T and dO.V^T have landed, then the K and V
// tiles (64 x 128 bf16 each) of the kv tiles at or below the diagonal
// into a ring of STAGES shared-memory stages that runs on across items,
// each stage guarded by a full/empty mbarrier pair. L and D stay out of
// the ring: a consumer thread owns two query rows and reads their four
// values from global memory once per item.
// Warpgroups 1 and 2 are consumers, 64 query rows each. For each kv tile
// a consumer computes S = Q.K^T and dP = dO.V^T with wgmma (m64n64k16,
// all operands K-major in swizzled shared memory, one commit group each),
// P = exp2(S.scale.log2e - L.log2e) while dP is still running (only the
// warpgroup's diagonal tile is masked; tiles wholly after its rows are
// not computed), dS = P * (dP - D), turns dS into bf16 register A
// operands in place (the accumulator layout is the A fragment layout) and
// adds dS.K with wgmma (K the MN-major shared B operand). dQ stays in 64
// fp32 registers a thread through the whole loop. Two overlaps keep the
// tensor cores busy during the elementwise step: inside a consumer, tile
// j's S and dP products are issued together with tile j-1's dS.K (a stage
// is held until its dS.K lands; 64-row kv tiles leave the registers for
// that, 64 + 32 + 32 + 16 a thread, and the shared memory for four
// stages); between the consumers, named barriers hand the turn to issue
// products back and forth (ping-pong), so one consumer's elementwise step
// runs while the other's products do. The first tile and the last dS.K of
// an item are peeled off the loop, so that no wgmma is issued under a
// condition: ptxas serialises every wgmma of a kernel that does
// (PERF.md has the variants that were timed).
//
// Numerics: dS is rounded to bf16 before the dS.K product (the Pallas
// kernel keeps it fp32); P, dP and the dQ accumulator stay fp32. Every dQ
// row is summed over its kv tiles in one fixed order, in registers: no
// atomics, no partial buffers, and the static schedule sums an item the
// same way whichever block takes it — the kernel is deterministic, which
// bit-identical continuation after a migration depends on.
//
// What bounds it on the H100: operations (three S x S x hd / 2 products
// per (b, h) against O(S.hd) bytes per row). What holds it above that
// bound is in PERF.md.

#include "hopper.cuh"

namespace grit {

constexpr int BQ = 128;                    // query rows per work item
constexpr int BK = 64;                     // key rows per kv tile
constexpr int STAGES = 4;                  // K/V ring depth
constexpr int Q_BYTES = BQ * HD * 2;       // one 128 x 128 bf16 tile
constexpr int KV_BYTES = BK * HD * 2;      // one 64 x 128 bf16 tile
constexpr int Q_OFF = 0;
constexpr int DO_OFF = Q_BYTES;
constexpr int KV_OFF = 2 * Q_BYTES;        // stage s: K at +2s tiles, V after
constexpr int BAR_OFF = KV_OFF + STAGES * 2 * KV_BYTES;
constexpr int DQ_SMEM = BAR_OFF + 128 + ATOM_BYTES;  // + alignment slack
constexpr int NTHREADS_DQ = 384;
constexpr int NS = BK / 2;                 // score registers a thread

// P in place of the raw scores S of one kv tile. Accumulator layout (see
// hopper.cuh): sc[4j + e] is row row0 + 8 * (e >> 1) of the q tile and
// column 8j + 2t + (e & 1) of the kv tile; l2 holds the two rows' L.log2e.
// With MASK (the warpgroup's diagonal tile), P is zero where the key comes
// after the query: column > drow (+ 8 for the second row), drow being
// row0's position in the tile.
template <bool MASK>
__device__ __forceinline__ void probs(float (&sc)[NS], const float (&l2)[2],
                                      int drow, int t, float scale_log2) {
#pragma unroll
  for (int i = 0; i < NS; ++i) {
    const int r = (i >> 1) & 1;
    float p = exp2_ftz(fmaf(sc[i], scale_log2, -l2[r]));
    if (MASK && (i >> 2) * 8 + 2 * t + (i & 1) > drow + 8 * r) p = 0.f;
    sc[i] = p;
  }
}

// dS = P * (dP - D) in place of dP.
__device__ __forceinline__ void dscores(const float (&p)[NS], float (&dp)[NS],
                                        const float (&d)[2]) {
#pragma unroll
  for (int i = 0; i < NS; ++i) dp[i] = p[i] * (dp[i] - d[(i >> 1) & 1]);
}

__global__ void __launch_bounds__(NTHREADS_DQ, 1)
flash_bwd_dq_kernel(const __grid_constant__ CUtensorMap tm_q,
                    const __grid_constant__ CUtensorMap tm_k,
                    const __grid_constant__ CUtensorMap tm_v,
                    const __grid_constant__ CUtensorMap tm_do,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, bf16* __restrict__ dq,
                    int B, int S, int H, int KVH, float scale,
                    float scale_log2) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + ATOM_BYTES - 1) & ~(uint32_t)(ATOM_BYTES - 1);
  const uint32_t sQ = base + Q_OFF, sdO = base + DO_OFF;
  // full[STAGES], empty[STAGES], then Q/dO's full and empty barriers
  const uint32_t bars = base + BAR_OFF;
  auto sK = [&](int s) { return base + KV_OFF + 2 * s * KV_BYTES; };
  auto sV = [&](int s) { return base + KV_OFF + (2 * s + 1) * KV_BYTES; };
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
    // Producer: Q and dO of each work item once its predecessor's last
    // S/dP products have landed, then its K/V tiles through the ring,
    // which runs on across work items.
    setmaxnreg_dec<24>();
    if (threadIdx.x == 0) {
      int it = 0;
      for (int r = 0, w; (w = snake_item(r, cta, G)) < n_work; ++r) {
        const QWork wk = q_work_item(w, nqt, H, B);
        const int kvh = wk.h / groups;
        mbar_wait(q_empty, (r & 1) ^ 1);
        mbar_expect_tx(q_full, 2 * Q_BYTES);
        tma_load_tile(sQ, &tm_q, q_full, wk.h, wk.b * S + wk.qt * BQ, BQ);
        tma_load_tile(sdO, &tm_do, q_full, wk.h, wk.b * S + wk.qt * BQ, BQ);
        const int n = (wk.qt + 1) * (BQ / BK);
        for (int j = 0; j < n; ++j, ++it) {
          const int s = it % STAGES;
          mbar_wait(empty(s), ((it / STAGES) & 1) ^ 1);
          mbar_expect_tx(full(s), 2 * KV_BYTES);
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

    float acc[64];  // dQ
    // S = Q.K_s^T and dP = dO.V_s^T for this warpgroup's rows, one commit
    // group each, so P can be computed while dP runs.
    auto scores = [&](float (&sc)[NS], float (&dp)[NS], int s) {
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk)
        wgmma_ss_m64n64(sc, kmajor_desc(sQ, BQ, c * 64, kk),
                        kmajor_desc(sK(s), BK, 0, kk), kk > 0);
      wgmma_commit();
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk)
        wgmma_ss_m64n64(dp, kmajor_desc(sdO, BQ, c * 64, kk),
                        kmajor_desc(sV(s), BK, 0, kk), kk > 0);
      wgmma_commit();
    };
    // dQ += dS.K_s.
    auto add_dq = [&](const uint32_t (&da)[BK / 16][4], int s) {
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
        wgmma_rs_m64n128_mn(acc, da[kk], mnmajor_desc(sK(s), BK, kk), 1);
      wgmma_commit();
    };
    auto release = [&](uint32_t bar) {
      __syncwarp();
      if (lane == 0) mbar_arrive(bar);
    };

    // Ping-pong between the two consumers: a warpgroup issues its products
    // only on its turn (named barrier 1 + c) and then passes the turn on.
    // Consumer 1 lets consumer 0 go first and, to leave no arrival pending
    // at exit, skips its last hand-over. A work item of n kv tiles is
    // n + 1 turns for both consumers.
    int n_turns = 0;
    for (int r = 0, w; (w = snake_item(r, cta, G)) < n_work; ++r)
      n_turns += (q_work_item(w, nqt, H, B).qt + 1) * (BQ / BK) + 1;
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
      const int n = (qt + 1) * (BQ / BK);
      // This warpgroup's diagonal tile, its last with a key at or before
      // one of its queries, and row0's position in that tile.
      const int last = (qt * BQ + c * 64 + 63) / BK;
      const int drow = qt * BQ + row0 - last * BK;
      const long rows = ((long)wk.b * H + wk.h) * S + (long)qt * BQ + row0;
      const float l2[2] = {lse[rows] * LOG2E, lse[rows + 8] * LOG2E};
      const float d[2] = {delta[rows], delta[rows + 8]};
#pragma unroll
      for (int i = 0; i < 64; ++i) acc[i] = 0.f;

      // Tile j's S and dP are issued with tile j-1's dS.K; P is computed
      // once S has landed, dS once dP has, and tile j-1's stage goes back
      // once its dS.K has. Q and dO go back once the warpgroup's last S
      // and dP have landed. Tile 0: S and dP alone.
      float sc[NS], dp[NS];
      uint32_t da[BK / 16][4];
      mbar_wait(q_full, r & 1);
      int s = it % STAGES;
      mbar_wait(full(s), (it / STAGES) & 1);
      my_turn();
      wgmma_fence();
      scores(sc, dp, s);
      pass_turn();
      wgmma_wait<1>();
      fence_regs(sc);
      if (last == 0)
        probs<true>(sc, l2, drow, t, scale_log2);
      else
        probs<false>(sc, l2, drow, t, scale_log2);
      wgmma_wait<0>();
      fence_regs(dp);
      if (last == 0) release(q_empty);
      dscores(sc, dp, d);
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) acc_to_a_flat(da[kk], dp, kk);
      for (int j = 1; j <= last; ++j) {
        const int prev = s;
        s = (it + j) % STAGES;
        mbar_wait(full(s), ((it + j) / STAGES) & 1);
        my_turn();
        wgmma_fence();
        scores(sc, dp, s);
        add_dq(da, prev);
        pass_turn();
        wgmma_wait<2>();
        fence_regs(sc);
        if (j == last)
          probs<true>(sc, l2, drow, t, scale_log2);
        else
          probs<false>(sc, l2, drow, t, scale_log2);
        wgmma_wait<1>();
        fence_regs(dp);
        if (j == last) release(q_empty);
        dscores(sc, dp, d);
        wgmma_wait<0>();
        fence_regs(acc);
        release(empty(prev));
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk) acc_to_a_flat(da[kk], dp, kk);
      }
      // The diagonal tile's dS.K alone.
      my_turn();
      wgmma_fence();
      add_dq(da, s);
      pass_turn();
      wgmma_wait<0>();
      fence_regs(acc);
      release(empty(s));
      if (last < n - 1) {
        // Consumer 0: the item's last kv tile lies wholly after its rows.
        // It hands the stage back unread and takes the turn it would have
        // used, so both consumers take n + 1 turns.
        const int s2 = (it + n - 1) % STAGES;
        mbar_wait(full(s2), ((it + n - 1) / STAGES) & 1);
        release(empty(s2));
        my_turn();
        pass_turn();
      }
      it += n;

      const long q_ld = (long)H * HD;
      bf16* dst = dq + ((long)wk.b * S + (long)qt * BQ) * q_ld + (long)wk.h * HD;
      store_acc_rows(dst, q_ld, row0, acc, scale, scale, t);
    }
  }
}

}  // namespace grit

// Plain C entry (bound with ctypes). Builds the TMA maps of this call's
// tensors and returns the cudaError_t of the launch; 0 means the kernel
// was queued on `stream`.
extern "C" int grit_flash_bwd_dq(const void* q, const void* k, const void* v,
                                 const void* dout, const void* lse,
                                 const void* delta, void* dq, int B, int S,
                                 int H, int KVH, float scale, void* stream) {
  using namespace grit;
  if (B <= 0 || S <= 0 || S % BQ != 0 || KVH <= 0 || H % KVH != 0)
    return (int)cudaErrorInvalidValue;
  CUtensorMap tm_q, tm_k, tm_v, tm_do;
  int err = make_head_map(&tm_q, q, H, (long)B * S, BQ);
  if (err == 0) err = make_head_map(&tm_do, dout, H, (long)B * S, BQ);
  if (err == 0) err = make_head_map(&tm_k, k, KVH, (long)B * S, BK);
  if (err == 0) err = make_head_map(&tm_v, v, KVH, (long)B * S, BK);
  if (err != 0) return err;
  cudaError_t cerr = cudaFuncSetAttribute(
      flash_bwd_dq_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      DQ_SMEM);
  if (cerr != cudaSuccess) return (int)cerr;
  unsigned grid;
  err = persistent_grid((long)B * H * (S / BQ), &grid);
  if (err != 0) return err;
  flash_bwd_dq_kernel<<<grid, NTHREADS_DQ, DQ_SMEM, (cudaStream_t)stream>>>(
      tm_q, tm_k, tm_v, tm_do, (const float*)lse, (const float*)delta,
      (bf16*)dq, B, S, H, KVH, scale, scale * LOG2E);
  return (int)cudaGetLastError();
}
