"""The port on the card: its CUDA kernels against their plain versions, a
short flagship-width training and snapshot round trip, and a flagship-width
decode round against its CPU copy. Every test is
``cuda``-marked and skips without a GPU. This file imports neither JAX nor
the JAX package, so it also runs on a GPU machine without them:

    python -m pytest -m cuda --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""

from __future__ import annotations

import pytest
import torch

from grit_tpu_torch.models import llama
from grit_tpu_torch.models.serving import (
    BatchingConfig,
    ContinuousBatchingEngine,
    InferenceEngine,
    ServingConfig,
)
from grit_tpu_torch.ops import attention
from grit_tpu_torch.ops import flash_attention as fa
from grit_tpu_torch.tree import tree_map
from grit_tpu_torch.workload import llama_trainer

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    """The card, decided here and not at import, so every test worker
    collects the same tests."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (run on the card, see the module "
                    "docstring)")
    return torch.device("cuda", 0)


def _inputs(B, S, H, KVH, device, seed=0):
    gen = torch.Generator(device=device).manual_seed(seed)
    q, do = (torch.randn(B, S, H, 128, generator=gen, device=device)
             .to(torch.bfloat16) for _ in range(2))
    k, v = (torch.randn(B, S, KVH, 128, generator=gen, device=device)
            .to(torch.bfloat16) for _ in range(2))
    return q, k, v, do


def _close(got, want):
    """bf16 outputs agree to 2^-6 of their scale (the kernels round P and
    dS to bf16 before their second product; see chip_smoke.py), over the
    whole tensor and within every 128-row tile of every head: dK and dV
    of the last keys are far smaller than the first key's, so only the
    tile rule sees a wrong tile there. Tensors are (B, S, heads, hd)."""
    got, want = got.float(), want.float()
    err = (got - want).abs()
    if not err.max().item() <= 2.0 ** -6 * max(1.0, want.abs().max().item()):
        return False
    B, S, NH, hd = want.shape
    tiles = (B, S // 128, 128, NH, hd)
    return bool((err.reshape(tiles).amax(dim=(2, 4))
                 <= 2.0 ** -6 * want.abs().reshape(tiles).amax(dim=(2, 4)))
                .all())


# One 128-row tile (the diagonal only), two, three and the flagship's
# sixteen; GQA groups of 1, 2, 4 and 5 q heads per kv head.
@pytest.mark.parametrize("S,H,KVH", [
    (128, 2, 2), (256, 4, 2), (384, 4, 1),
    (128, 8, 2), (128, 10, 2), (384, 2, 2), (384, 8, 2), (384, 10, 2),
    (2048, 2, 2), (2048, 8, 2), (2048, 10, 2)])
def test_kernels_match_plain_versions(cuda_device, S, H, KVH):
    """Each kernel against its plain version, and run twice on the same
    inputs for bitwise equal outputs."""
    B = 2
    q, k, v, do = _inputs(B, S, H, KVH, cuda_device)
    fa.reset_launch_counts()
    o, lse = fa.flash_fwd(q, k, v)
    o2, lse2 = fa.flash_fwd(q, k, v)
    assert torch.equal(o, o2) and torch.equal(lse, lse2)
    po, plse = fa.flash_fwd_plain(q, k, v)
    assert _close(o, po)
    assert (lse - plse).abs().max().item() < 1e-3
    lse3 = plse.reshape(B, H, S).contiguous()
    delta = fa.attention_delta(do, po)
    dq = fa.flash_bwd_dq(q, k, v, do, lse3, delta)
    assert torch.equal(dq, fa.flash_bwd_dq(q, k, v, do, lse3, delta))
    assert _close(dq, fa.flash_bwd_dq_plain(q, k, v, do, lse3, delta))
    dk, dv = fa.flash_bwd_dkv(q, k, v, do, lse3, delta)
    dk2, dv2 = fa.flash_bwd_dkv(q, k, v, do, lse3, delta)
    assert torch.equal(dk, dk2) and torch.equal(dv, dv2)
    pdk, pdv = fa.flash_bwd_dkv_plain(q, k, v, do, lse3, delta)
    assert _close(dk, pdk) and _close(dv, pdv)
    torch.cuda.synchronize()
    assert fa.LAUNCHES == {"flash_fwd": 2, "flash_bwd_dq": 2,
                           "flash_bwd_dkv": 2}


def test_close_rejects_a_dropped_last_kv_tile(cuda_device):
    """At the flagship's S 2048 a dK/dV kernel that left the last kv tile
    of one kv head at zero stays inside the whole-tensor limit, which
    the first key's large gradient sets; the tile rule must reject it."""
    B, S, H, KVH = 1, 2048, 2, 2
    q, k, v, do = _inputs(B, S, H, KVH, cuda_device, seed=3)
    po, plse = fa.flash_fwd_plain(q, k, v)
    lse3 = plse.reshape(B, H, S).contiguous()
    delta = fa.attention_delta(do, po)
    dk, dv = fa.flash_bwd_dkv(q, k, v, do, lse3, delta)
    pdk, pdv = fa.flash_bwd_dkv_plain(q, k, v, do, lse3, delta)
    for got, want in ((dk, pdk), (dv, pdv)):
        assert _close(got, want)
        bad = got.clone()
        bad[0, -128:, -1] = 0
        assert not _close(bad, want)


def test_close_rejects_a_dq_tile_without_its_diagonal_kv_tile(cuda_device):
    """A dQ kernel whose K/V ring lost one stage leaves that 64-row kv
    tile's term out of a q tile's rows. The kernel's dq passes the
    comparison; the plain dq with the last q tile of one head lacking the
    term of its last 64-row kv tile does not: the tile rule rejects it."""
    import chip_smoke  # noqa: PLC0415

    B, S, H, KVH = 1, 2048, 2, 2
    q, k, v, do = _inputs(B, S, H, KVH, cuda_device, seed=3)
    po, plse = fa.flash_fwd_plain(q, k, v)
    lse3 = plse.reshape(B, H, S).contiguous()
    delta = fa.attention_delta(do, po)
    pdq = fa.flash_bwd_dq_plain(q, k, v, do, lse3, delta)
    assert _close(fa.flash_bwd_dq(q, k, v, do, lse3, delta), pdq)
    bad = chip_smoke.drop_diagonal_kv_tile(pdq, q, k, v, do, lse3, delta)
    assert not _close(bad, pdq)
    _, tile = chip_smoke.fault_ratios("dq", bad, pdq)
    assert tile > 1.0


# One warpgroup runs one product helper of csrc/hopper.cuh on tiles that
# TMA loads exactly as the kernels load theirs; the fp32 accumulator is
# written out through its fragment layout.
_PROBE_CU = r"""
#include "hopper.cuh"
using namespace grit;

template <int N>
__device__ void write_acc(float* out, const float (&d)[N / 2], int tid) {
  const int warp = tid / 32, g = (tid % 32) / 4, t = tid % 4;
#pragma unroll
  for (int i = 0; i < N / 2; ++i)
    out[(warp * 16 + g + ((i >> 1) & 1) * 8) * N + (i >> 2) * 8 + 2 * t +
        (i & 1)] = d[i];
}

// which 0: A(64 x 128).B(128 x 128)^T  with wgmma_ss_m64n128
// which 1: A(64 x 128).B(64 x 128)^T   with wgmma_ss_m64n64
// which 2: A(64 x R).B(R x 128), R = brows, with wgmma_rs_m64n128_mn
__global__ void __launch_bounds__(128) probe(
    const __grid_constant__ CUtensorMap ta, const __grid_constant__ CUtensorMap tb,
    const bf16* a, float* out, int which, int brows) {
  extern __shared__ unsigned char raw[];
  const uint32_t base = (smem_u32(raw) + 1023) & ~1023u;
  const uint32_t sA = base, sB = base + 64 * 256, bar = base + 64 * 256 + 128 * 256;
  const int tid = threadIdx.x;
  if (tid == 0) { mbar_init(bar, 1); mbar_init_fence(); }
  __syncthreads();
  if (tid == 0) {
    mbar_expect_tx(bar, (which == 2 ? 0 : 64 * 256) + brows * 256);
    if (which != 2) tma_load_tile(sA, &ta, bar, 0, 0, 64);
    tma_load_tile(sB, &tb, bar, 0, 0, brows);
  }
  mbar_wait(bar, 0);
  if (which == 0) {
    float d[64];
    wgmma_fence();
    for (int kk = 0; kk < 8; ++kk)
      wgmma_ss_m64n128(d, kmajor_desc(sA, 64, 0, kk), kmajor_desc(sB, 128, 0, kk), kk > 0);
    wgmma_commit(); wgmma_wait<0>(); fence_regs(d);
    write_acc<128>(out, d, tid);
  } else if (which == 1) {
    float d[32];
    wgmma_fence();
    for (int kk = 0; kk < 8; ++kk)
      wgmma_ss_m64n64(d, kmajor_desc(sA, 64, 0, kk), kmajor_desc(sB, 64, 0, kk), kk > 0);
    wgmma_commit(); wgmma_wait<0>(); fence_regs(d);
    write_acc<64>(out, d, tid);
  } else {
    float d[64];
    for (int i = 0; i < 64; ++i) d[i] = 0.f;
    const int warp = tid / 32, g = (tid % 32) / 4, t = tid % 4;
    wgmma_fence(); fence_regs(d);
    auto ld = [](const bf16* p) { return *reinterpret_cast<const uint32_t*>(p); };
    for (int kk = 0; kk < brows / 16; ++kk) {
      const bf16* p = a + (warp * 16 + g) * brows + kk * 16 + 2 * t;
      uint32_t f[4] = {ld(p), ld(p + 8 * brows), ld(p + 8), ld(p + 8 * brows + 8)};
      wgmma_rs_m64n128_mn(d, f, mnmajor_desc(sB, brows, kk), 1);
    }
    wgmma_commit(); wgmma_wait<0>(); fence_regs(d);
    write_acc<128>(out, d, tid);
  }
}

extern "C" int grit_probe(const void* a, const void* b, void* out, int which,
                          int brows) {
  CUtensorMap ta, tb;
  int err = make_head_map(&ta, a, 1, 64, 64);
  if (err == 0) err = make_head_map(&tb, b, 1, brows, brows);
  if (err != 0) return err;
  const int smem = 64 * 256 + 128 * 256 + 64 + 1024;
  cudaFuncSetAttribute(probe, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  probe<<<1, 128, smem>>>(ta, tb, (const bf16*)a, (float*)out, which, brows);
  return (int)cudaGetLastError();
}
"""


@pytest.fixture(scope="module")
def probe_lib(tmp_path_factory):
    import ctypes  # noqa: PLC0415
    import subprocess  # noqa: PLC0415

    from grit_tpu_torch.ops import build  # noqa: PLC0415

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    d = tmp_path_factory.mktemp("probe")
    src = d / "probe.cu"
    src.write_text(_PROBE_CU)
    lib = d / "libprobe.so"
    subprocess.run([build.nvcc_path(), *build.NVCC_FLAGS, "-I", str(build.CSRC),
                    "-o", str(lib), str(src)], check=True)
    fn = ctypes.CDLL(str(lib)).grit_probe
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2
    fn.restype = ctypes.c_int
    return fn


@pytest.mark.parametrize("which,brows", [(0, 128), (1, 64), (2, 128), (2, 64)])
def test_wgmma_product_helpers_match_matmul(cuda_device, probe_lib, which,
                                            brows):
    """S = Q.K^T (n128), S^T = K.Q^T (n64) and O += P.V / dV += P^T.dO
    (register A, MN-major B of 128 or 64 rows) against torch.matmul in
    fp32 on the same bf16 inputs. Exact products summed in fp32 in
    another order agree to 1e-4 of their O(10) magnitude; a layout or
    descriptor fault is off by O(1)."""
    gen = torch.Generator(device=cuda_device).manual_seed(which * 10 + brows)
    arows, acols = 64, (brows if which == 2 else 128)
    a = torch.randn(arows, acols, generator=gen, device=cuda_device).bfloat16()
    b = torch.randn(brows, 128, generator=gen, device=cuda_device).bfloat16()
    want = a.float() @ (b.float() if which == 2 else b.float().T)
    out = torch.full_like(want, float("nan"))
    assert probe_lib(a.data_ptr(), b.data_ptr(), out.data_ptr(), which,
                     brows) == 0
    torch.cuda.synchronize()
    assert torch.allclose(out, want, rtol=1e-4, atol=1e-3)


def test_kernel_wrappers_refuse_what_the_kernels_cannot_take(cuda_device):
    q, k, v, _ = _inputs(1, 128, 2, 2, cuda_device)
    with pytest.raises(TypeError, match="bfloat16"):
        fa.flash_fwd(q.float(), k.float(), v.float())
    strided = torch.cat([q, q], dim=2)[:, :, :2]  # head stride of 4 heads
    assert not strided.is_contiguous()
    with pytest.raises(ValueError, match="contiguous"):
        fa.flash_fwd(strided, k, v)
    with pytest.raises(ValueError, match="several devices"):
        fa.flash_fwd(q, k.cpu(), v)


def test_fp32_at_the_flash_shape_is_refused_not_sent_to_the_plain_path(
        cuda_device):
    """The gate has no dtype clause: fp32 at an aligned training shape
    reaches the bf16 kernel's wrapper, which raises; nothing launches."""
    q, k, v, _ = _inputs(1, 128, 2, 2, cuda_device)
    fa.reset_launch_counts()
    with pytest.raises(TypeError, match="bfloat16"):
        attention.causal_attention(q.float(), k.float(), v.float())
    assert fa.LAUNCHES == {name: 0 for name in fa.LAUNCHES}


def test_flagship_width_steps_snapshot_and_resume(cuda_device, tmp_path):
    """Two layers at the flagship widths: each step launches each kernel
    once per layer, and a restored Trainer continues bit-identically."""
    cfg = llama.LlamaConfig.flagship(n_layers=2)
    a = llama_trainer(cfg, batch=1, seq=256, device=cuda_device)
    fa.reset_launch_counts()
    a.run(2)
    assert fa.LAUNCHES == {name: 2 * 2 for name in fa.LAUNCHES}
    d = str(tmp_path / "snap")
    a.snapshot(d)
    want = a.run(2)
    b = llama_trainer(cfg, batch=1, seq=256, device=cuda_device)
    assert b.restore(d) == 2
    assert b.state["params"]["lm_head"].is_cuda
    assert b.run(2) == want


def _rel_l2(got, want) -> float:
    got, want = got.float().cpu(), want.float().cpu()
    return ((got - want).norm() / want.norm()).item()


def test_flagship_decode_round_matches_its_cpu_copy(cuda_device):
    """One continuous-batching decode round at the flagship widths (2
    layers, 4 slots, one free) on the card and on a CPU copy of the same
    params and state: logits and the cache within 2^-6 relative L2 (the
    two devices round bf16 activations at different places; a wrong
    position or mask is off by O(1)), the free slot's rows untouched, and
    no flash kernel launched (serving attention is the plain path)."""
    cfg = llama.LlamaConfig.flagship(n_layers=2)
    params = llama.init_params(
        cfg, torch.Generator(device=cuda_device).manual_seed(0), cuda_device)
    eng = ContinuousBatchingEngine(cfg, params, BatchingConfig(
        n_slots=4, max_seq_len=1024), device=cuda_device)
    gen = torch.Generator().manual_seed(1)
    for n in (100, 37, 5):
        eng.submit(torch.randint(0, cfg.vocab_size, (n,), generator=gen))
    st = eng.state
    cpu_params = tree_map(lambda t: t.cpu(), params)
    cpu_cache = tree_map(lambda t: t.cpu(), st["cache"])
    fa.reset_launch_counts()
    logits, cache = llama.decode_ragged(cfg, params, st["last_token"],
                                        st["cache"], st["lengths"],
                                        st["active"])
    assert logits.is_cuda and fa.LAUNCHES == {n: 0 for n in fa.LAUNCHES}
    want, want_cache = llama.decode_ragged(cfg, cpu_params, st["last_token"],
                                           cpu_cache, st["lengths"],
                                           st["active"])
    assert _rel_l2(logits[:3], want[:3]) <= 2.0 ** -6
    for leaf in ("k", "v"):
        assert _rel_l2(cache[leaf], want_cache[leaf]) <= 2.0 ** -6
        assert not cache[leaf][:, 3].any()
    emitted = eng.step()
    assert sorted(emitted) == [0, 1, 2]
    assert all(0 <= t < cfg.vocab_size for t in emitted.values())


def test_ragged_cache_write_is_deterministic_in_deterministic_mode(
        cuda_device):
    """The per-row cache write (``index_put_``) under
    ``torch.use_deterministic_algorithms(True)`` equals the CPU's, twice."""
    gen = torch.Generator().manual_seed(2)
    cache = torch.randn(4, 64, 2, 128, generator=gen).to(torch.bfloat16)
    new = torch.randn(4, 1, 2, 128, generator=gen).to(torch.bfloat16)
    starts = torch.tensor([0, 63, 5, 9])
    active = torch.tensor([True, True, False, True])
    want = cache.clone()
    llama._ragged_cache_write(want, new, starts, active)
    was = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        for _ in range(2):
            got = cache.to(cuda_device)
            llama._ragged_cache_write(got, new.to(cuda_device),
                                      starts.to(cuda_device),
                                      active.to(cuda_device))
            assert torch.equal(got.cpu(), want)
    finally:
        torch.use_deterministic_algorithms(was)
    assert torch.equal(want[2], cache[2])


def test_serving_engines_given_no_device_land_on_the_card(cuda_device):
    cfg = llama.LlamaConfig.tiny(dim=256, n_heads=2, n_kv_heads=2)
    params = llama.init_params(
        cfg, torch.Generator(device=cuda_device).manual_seed(0), cuda_device)
    cb = ContinuousBatchingEngine(cfg, params, BatchingConfig(
        n_slots=2, max_seq_len=128))
    assert cb.device.type == "cuda" and cb.state["cache"]["k"].is_cuda
    slot = cb.submit([3, 17, 42, 7])
    assert slot in cb.step()
    lock = InferenceEngine(cfg, params, ServingConfig(batch_size=2))
    assert lock.state["cache"]["k"].is_cuda
    assert lock.prefill([[1, 2, 3], [4, 5, 6]]).is_cuda


def test_pinned_dump_and_restore_round_trip_bitwise(cuda_device, tmp_path,
                                                    monkeypatch):
    """The card's snapshot data path, with 1 MiB pieces so that the dump's
    4-slot pinned ring wraps inside every large leaf and the restore's
    pinned blocks are reused across 12 leaves: a bf16/fp32/int64 tree
    (one leaf non-contiguous) dumps to the bytes a CPU dump of the same
    tree writes, its mirror and a delta on the card agree, and restores
    onto the card, pipelined and serial, give it back bitwise."""
    import os

    from grit_tpu_torch.device import snapshot as psnap

    monkeypatch.setattr(psnap, "_PIECE_BYTES", 1 << 20)
    gen = torch.Generator(device=cuda_device).manual_seed(3)
    state = {}
    for i in range(4):
        state[f"bf{i}"] = torch.randn(1536 + i, 1024, generator=gen,
                                      device=cuda_device).to(torch.bfloat16)
        state[f"f{i}"] = torch.randn(1280 + 7 * i, 1024, generator=gen,
                                     device=cuda_device)
    state["i64"] = torch.randint(-2 ** 40, 2 ** 40, (700_001,), generator=gen,
                                 device=cuda_device, dtype=torch.int64)
    state["t"] = torch.randn(1024, 1536, generator=gen, device=cuda_device).T
    state["step"] = torch.tensor(5, device=cuda_device)
    state["tiny"] = torch.ones(3, dtype=torch.bfloat16, device=cuda_device)
    assert not state["t"].is_contiguous()

    def data(d):
        with open(os.path.join(d, psnap.DATA_FILE), "rb") as f:
            return f.read()

    d, mirror, cpu_d = (str(tmp_path / n) for n in ("snap", "pvc", "cpu"))
    psnap.write_snapshot(d, state, hashes=True, mirror=mirror)
    assert psnap.last_write()["staging"].startswith("pinned ring")
    psnap.write_snapshot(cpu_d, {k: v.cpu() for k, v in state.items()},
                         hashes=True)
    assert data(d) == data(cpu_d) == data(mirror)
    assert psnap.SnapshotManifest.load(d).arrays == \
        psnap.SnapshotManifest.load(cpu_d).arrays

    state2 = dict(state, f1=state["f1"] + 1)
    delta = str(tmp_path / "delta")
    psnap.write_snapshot(delta, state2, base=d)
    assert psnap.snapshot_delta_nbytes(delta) == \
        state["f1"].numel() * 4
    like = {k: torch.empty(v.shape, dtype=v.dtype, device="meta")
            for k, v in state2.items()}
    needs = [-(-rec["chunks"][0]["nbytes"] // (1 << 20))
             for rec in psnap.SnapshotManifest.load(delta).arrays]
    for pipe in ("1", "0"):
        monkeypatch.setenv("GRIT_RESTORE_PIPELINE", pipe)
        got = psnap.restore_snapshot(delta, like=like)
        rec = psnap.last_restore_pipeline()
        assert "pinned blocks" in rec["staging"]
        # At most the window's worth of the largest leaf, well under the
        # tree's blocks: the same blocks carried several leaves.
        window = rec["workers"] + 1
        assert max(needs) <= rec["pinned_blocks"] <= window * max(needs) \
            < sum(needs), (rec, needs)
        for k, v in state2.items():
            assert got[k].is_cuda and torch.equal(got[k], v), (pipe, k)
