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
// Design. A work item is one (b, kv head, 128-row kv tile). The kernel
// is persistent: one block per SM (its shared memory admits no second),
// each walking a static list of work items, the longest (first kv tiles)
// first and snaked over the blocks (no atomic work counter). A block has
// three warpgroups. Warpgroup 0 is the producer: it gives its registers
// away (setmaxnreg) and one thread issues every load through TMA — an
// item's K and V once the previous item's last S^T/dP^T products have
// landed, then for each q head of the group and each 64-row q tile at or
// below the diagonal the Q and dO tiles (64 x 128 bf16) and their 64 L
// and D values into a ring of STAGES shared-memory stages that runs on
// across items, each stage guarded by a full/empty mbarrier pair.
// Warpgroups 1 and 2 are consumers, 64 key
// rows each, working on the transposed problem: per q tile,
//   S^T = K.Q^T and dP^T = V.dO^T  (wgmma m64n64k16, both operands
//                                   K-major in swizzled shared memory),
//   P^T = exp2(S^T.scale.log2e - L.log2e), zero where query < key,
//   dS^T = P^T * (dP^T - D),
//   dV += P^T.dO and dK += dS^T.Q  (wgmma m64n128k16, P^T and dS^T as
//                                   bf16 register A operands made in
//                                   place from the accumulators, dO and Q
//                                   the MN-major shared B operands).
// dK and dV accumulate in fp32 registers through the whole loop, group
// heads included: the GQA group sum that the TPU kernel leaves to a
// separate pass over per-head partials happens here, in one fixed order,
// with no atomics and no partial buffers — deterministic, and dK/dV are
// written once in bf16. A consumer whose 64 keys all lie after a q tile's
// last query skips that tile's products (it still hands the stage back).
// The two consumers take turns to issue products (ping-pong over named
// barriers), so one's elementwise step runs while the other's products
// occupy the tensor cores.
//
// Registers: the dK and dV accumulators take 64 + 64 fp32 registers a
// consumer thread, S^T and dP^T 32 + 32; two consumer warpgroups at 240
// registers and a producer at 24 fill the SM's 65,536. That leaves no
// room to compute the next tile's S^T and dP^T while this tile's dV/dK
// products run: a version that did spilled registers and ran slower.
//
// Numerics: P^T and dS^T are rounded to bf16 before their products with
// dO and Q (the Pallas kernel keeps them fp32); all sums stay fp32.
//
// What bounds it on the H100: operations (four S x S x hd / 2 products
// per (b, h) against O(S.hd) bytes).

#include "hopper.cuh"

namespace grit {

constexpr int BKV = 128;  // key rows per work item
constexpr int BQT = 64;   // query rows per staged tile
constexpr int STAGES = 2;
constexpr int KV_BYTES = BKV * HD * 2;  // one 128 x 128 bf16 tile
constexpr int QT_BYTES = BQT * HD * 2;  // one 64 x 128 bf16 tile
constexpr int ROWV_BYTES = BQT * 4;     // 64 fp32 L or D values
constexpr int K_OFF = 0;
constexpr int V_OFF = KV_BYTES;
constexpr int RING_OFF = 2 * KV_BYTES;  // stage s: Q at +2s tiles, dO after
constexpr int ROWV_OFF = RING_OFF + STAGES * 2 * QT_BYTES;  // L, D per stage
constexpr int BAR_OFF = ROWV_OFF + STAGES * 2 * ROWV_BYTES;
constexpr int DKV_SMEM = BAR_OFF + 128 + ATOM_BYTES;  // + alignment slack
constexpr int NTHREADS_DKV = 384;

// P^T and dS^T of one q tile, in place of S^T and dP^T. Accumulator
// layout (see hopper.cuh): st[4j + e] is key row key0 + 8 * (e >> 1) and
// query q0 + 8j + 2t + (e & 1). L (the forward's logsumexp) and D are the
// tile's 64 values in shared memory. With MASK (a tile that crosses the
// diagonal), P is zero where the query comes before the key.
template <bool MASK>
__device__ __forceinline__ void probs_and_dscores(float (&st)[32],
                                                  float (&dpt)[32],
                                                  const float* L, const float* D,
                                                  int q0, int key0, int t,
                                                  float scale_log2) {
#pragma unroll
  for (int n = 0; n < 32; ++n) {
    const int qc = (n >> 2) * 8 + 2 * t + (n & 1);
    float p = exp2_ftz(fmaf(st[n], scale_log2, -L[qc] * LOG2E));
    if (MASK && q0 + qc < key0 + ((n >> 1) & 1) * 8) p = 0.f;
    st[n] = p;
    dpt[n] = p * (dpt[n] - D[qc]);
  }
}

// Work item w: (kv tile, kv head, batch), kv tiles near the start of the
// sequence first — they walk the most q tiles (see snake_item for the
// order blocks take them in).
struct Work {
  int kt, kvh, b;
};

__device__ __forceinline__ Work work_item(int w, int KVH, int B) {
  const int rem = w % (KVH * B);
  return {w / (KVH * B), rem % KVH, rem / KVH};
}

__global__ void __launch_bounds__(NTHREADS_DKV, 1)
flash_bwd_dkv_kernel(const __grid_constant__ CUtensorMap tm_q,
                     const __grid_constant__ CUtensorMap tm_k,
                     const __grid_constant__ CUtensorMap tm_v,
                     const __grid_constant__ CUtensorMap tm_do,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, bf16* __restrict__ dk,
                     bf16* __restrict__ dv, int B, int S, int H, int KVH,
                     float scale, float scale_log2) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t pad =
      ((raw + ATOM_BYTES - 1) & ~(uint32_t)(ATOM_BYTES - 1)) - raw;
  unsigned char* smem = smem_raw + pad;
  const uint32_t base = raw + pad;
  const uint32_t sK = base + K_OFF, sV = base + V_OFF;
  auto sQ = [&](int s) { return base + RING_OFF + 2 * s * QT_BYTES; };
  auto sdO = [&](int s) { return base + RING_OFF + (2 * s + 1) * QT_BYTES; };
  auto sL = [&](int s) {
    return reinterpret_cast<const float*>(smem + ROWV_OFF + 2 * s * ROWV_BYTES);
  };
  auto sD = [&](int s) {
    return reinterpret_cast<const float*>(smem + ROWV_OFF +
                                          (2 * s + 1) * ROWV_BYTES);
  };
  // full[STAGES], empty[STAGES], then K/V's full and empty barriers
  const uint32_t bars = base + BAR_OFF;
  auto full = [&](int s) { return bars + 8 * s; };
  auto empty = [&](int s) { return bars + 8 * (STAGES + s); };
  const uint32_t kv_full = bars + 16 * STAGES;
  const uint32_t kv_empty = kv_full + 8;

  const int nkt = S / BKV;
  const int n_work = nkt * KVH * B;
  const int G = gridDim.x, cta = blockIdx.x;
  const int groups = H / KVH;
  const int nq = S / BQT;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), 8);  // one arrival per consumer warp
    }
    mbar_init(kv_full, 1);
    mbar_init(kv_empty, 8);
    mbar_init_fence();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    // Producer: K and V of each work item once its predecessor's last
    // S^T/dP^T products have landed, then its q tiles through the ring,
    // which runs on across work items.
    setmaxnreg_dec<24>();
    if (threadIdx.x == 0) {
      int it = 0;
      for (int r = 0, w; (w = snake_item(r, cta, G)) < n_work; ++r) {
        const Work wk = work_item(w, KVH, B);
        const int i0 = wk.kt * (BKV / BQT);
        mbar_wait(kv_empty, (r & 1) ^ 1);
        mbar_expect_tx(kv_full, 2 * KV_BYTES);
        tma_load_tile(sK, &tm_k, kv_full, wk.kvh, wk.b * S + wk.kt * BKV, BKV);
        tma_load_tile(sV, &tm_v, kv_full, wk.kvh, wk.b * S + wk.kt * BKV, BKV);
        for (int gi = 0; gi < groups; ++gi) {
          const int h = wk.kvh * groups + gi;
          const float* lrow = lse + ((long)wk.b * H + h) * S;
          const float* drow = delta + ((long)wk.b * H + h) * S;
          for (int i = i0; i < nq; ++i, ++it) {
            const int s = it % STAGES;
            mbar_wait(empty(s), ((it / STAGES) & 1) ^ 1);
            mbar_expect_tx(full(s), 2 * QT_BYTES + 2 * ROWV_BYTES);
            tma_load_tile(sQ(s), &tm_q, full(s), h, wk.b * S + i * BQT, BQT);
            tma_load_tile(sdO(s), &tm_do, full(s), h, wk.b * S + i * BQT, BQT);
            bulk_load(smem_u32(sL(s)), lrow + i * BQT, ROWV_BYTES, full(s));
            bulk_load(smem_u32(sD(s)), drow + i * BQT, ROWV_BYTES, full(s));
          }
        }
      }
    }
  } else {
    // Consumers: warpgroup c owns key rows 64c .. 64c + 63 of the tile.
    setmaxnreg_inc<240>();
    const int c = wg - 1;
    const int tid = threadIdx.x % 128;
    const int warp = tid / 32, lane = tid % 32, g = lane / 4, t = lane % 4;
    float dk_acc[64], dv_acc[64];

    auto release = [&](uint32_t bar) {
      __syncwarp();
      if (lane == 0) mbar_arrive(bar);
    };
    // S^T = K.Q^T and dP^T = V.dO^T of the q tile in stage s.
    auto scores = [&](float (&st)[32], float (&dpt)[32], int s) {
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk)
        wgmma_ss_m64n64(st, kmajor_desc(sK, BKV, c * 64, kk),
                        kmajor_desc(sQ(s), BQT, 0, kk), kk > 0);
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk)
        wgmma_ss_m64n64(dpt, kmajor_desc(sV, BKV, c * 64, kk),
                        kmajor_desc(sdO(s), BQT, 0, kk), kk > 0);
      wgmma_commit();
    };
    // dV += P^T.dO and dK += dS^T.Q of the q tile in stage s.
    auto add_dkv = [&](const uint32_t (&pa)[BQT / 16][4],
                       const uint32_t (&dsa)[BQT / 16][4], int s) {
#pragma unroll
      for (int kk = 0; kk < BQT / 16; ++kk)
        wgmma_rs_m64n128_mn(dv_acc, pa[kk], mnmajor_desc(sdO(s), BQT, kk), 1);
#pragma unroll
      for (int kk = 0; kk < BQT / 16; ++kk)
        wgmma_rs_m64n128_mn(dk_acc, dsa[kk], mnmajor_desc(sQ(s), BQT, kk), 1);
      wgmma_commit();
    };

    // Ping-pong between the two consumers: a warpgroup issues products only
    // on its turn (named barrier 1 + c) and then passes the turn on, so one
    // warpgroup's elementwise step runs while the other's products occupy
    // the tensor cores. Each q tile is two turns (S^T/dP^T, then dV/dK).
    // Consumer 1 lets consumer 0 go first and, to leave no arrival pending
    // at exit, skips its last hand-over.
    int n_turns = 0;
    for (int r = 0, w; (w = snake_item(r, cta, G)) < n_work; ++r)
      n_turns += 2 * groups * (nq - work_item(w, KVH, B).kt * (BKV / BQT));
    int turn = 0;
    auto my_turn = [&]() { named_sync(1 + c, 256); };
    auto pass_turn = [&]() {
      if (c == 0 || ++turn < n_turns) named_arrive(2 - c, 256);
    };
    if (c == 1) named_arrive(1, 256);

    int it = 0;
    for (int r = 0, w; (w = snake_item(r, cta, G)) < n_work; ++r) {
      const Work wk = work_item(w, KVH, B);
      const int i0 = wk.kt * (BKV / BQT);  // first q tile on the diagonal
      const int key0 = wk.kt * BKV + c * 64 + warp * 16 + g;  // and key0 + 8
      const int wg_first_key = wk.kt * BKV + c * 64;
#pragma unroll
      for (int i = 0; i < 64; ++i) dk_acc[i] = dv_acc[i] = 0.f;
      mbar_wait(kv_full, r & 1);
      for (int gi = 0; gi < groups; ++gi) {
        for (int i = i0; i < nq; ++i, ++it) {
          const int s = it % STAGES;
          // K and V go back to the producer once the item's last S^T/dP^T
          // products have landed.
          const bool last = gi == groups - 1 && i == nq - 1;
          mbar_wait(full(s), (it / STAGES) & 1);
          if ((i + 1) * BQT <= wg_first_key) {
            // Only the diagonal q tile can lie wholly before this warpgroup's
            // keys; it contributes nothing, but the turns are still taken.
            my_turn();
            pass_turn();
            my_turn();
            pass_turn();
            if (last) release(kv_empty);
          } else {
            float st[32], dpt[32];
            my_turn();
            wgmma_fence();
            scores(st, dpt, s);
            pass_turn();
            wgmma_wait<0>();
            fence_regs(st);
            fence_regs(dpt);
            if (last) release(kv_empty);

            if (i * BQT < wg_first_key + 64)
              probs_and_dscores<true>(st, dpt, sL(s), sD(s), i * BQT, key0,
                                      t, scale_log2);
            else
              probs_and_dscores<false>(st, dpt, sL(s), sD(s), i * BQT, key0,
                                       t, scale_log2);
            uint32_t pa[BQT / 16][4], dsa[BQT / 16][4];
#pragma unroll
            for (int kk = 0; kk < BQT / 16; ++kk) {
              acc_to_a_flat(pa[kk], st, kk);
              acc_to_a_flat(dsa[kk], dpt, kk);
            }

            my_turn();
            wgmma_fence();
            fence_regs(dv_acc);
            fence_regs(dk_acc);
            add_dkv(pa, dsa, s);
            pass_turn();
            wgmma_wait<0>();
            fence_regs(dv_acc);
            fence_regs(dk_acc);
          }
          release(empty(s));
        }
      }

      const long kv_ld = (long)KVH * HD;
      const long kv_off =
          ((long)wk.b * S + (long)wk.kt * BKV) * kv_ld + (long)wk.kvh * HD;
      const int row0 = c * 64 + warp * 16 + g;
      store_acc_rows(dk + kv_off, kv_ld, row0, dk_acc, scale, scale, t);
      store_acc_rows(dv + kv_off, kv_ld, row0, dv_acc, 1.f, 1.f, t);
    }
  }
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
  CUtensorMap tm_q, tm_k, tm_v, tm_do;
  int err = make_head_map(&tm_q, q, H, (long)B * S, BQT);
  if (err == 0) err = make_head_map(&tm_do, dout, H, (long)B * S, BQT);
  if (err == 0) err = make_head_map(&tm_k, k, KVH, (long)B * S, BKV);
  if (err == 0) err = make_head_map(&tm_v, v, KVH, (long)B * S, BKV);
  if (err != 0) return err;
  cudaError_t cerr = cudaFuncSetAttribute(
      flash_bwd_dkv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      DKV_SMEM);
  if (cerr != cudaSuccess) return (int)cerr;
  unsigned grid;
  err = persistent_grid((long)B * KVH * (S / BKV), &grid);
  if (err != 0) return err;
  flash_bwd_dkv_kernel<<<grid, NTHREADS_DKV, DKV_SMEM, (cudaStream_t)stream>>>(
      tm_q, tm_k, tm_v, tm_do, (const float*)lse, (const float*)delta,
      (bf16*)dk, (bf16*)dv, B, S, H, KVH, scale, scale * LOG2E);
  return (int)cudaGetLastError();
}
