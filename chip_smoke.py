#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``grit_tpu_torch``) on one GPU.

Run from the repository root on a machine with an NVIDIA H100::

    python3 chip_smoke.py

Phases, each printing its own lines; any failure raises and exits
non-zero without the final result line:

1. device  — the card's name, count and power limit (``nvidia-smi``).
2. build   — compile the three flash-attention kernels from
   ``grit_tpu_torch/ops/csrc`` (one ``nvcc`` per source, in parallel) and
   print each one's ptxas registers, spills and static shared memory; a
   spill fails.
3. kernels — at the flagship attention shape (B 2, S 2048, 20 heads,
   hd 128, bf16) and at a GQA shape (20 q heads on 4 kv heads), each
   kernel against its plain PyTorch version, over the whole tensor and
   within every 128-row tile (planted faults, one zeroed dK/dV tile and
   one dQ tile without the term of its last 64-row kv tile, one stage of
   the dQ kernel's ring, must fail the tile rule); timings of kernel,
   plain version and
   ``scaled_dot_product_attention`` (the yardstick, never used by the
   port); the bound; each kernel run twice on the same inputs must give
   bitwise equal outputs.
4. train   — the main path: a ``Trainer`` at the flagship widths (dim
   2560, 20 heads of 128, hidden 6912, vocab 32000, 13 layers, S 2048,
   batch 2, bf16) takes a few steps; losses finite and falling, and every
   kernel's launch count equals layers × steps.
5. migrate — the system's path: ``python -m grit_tpu_torch.workload``
   trains, is quiesced and dumped through its agentlet, SIGKILLed, and a
   fresh process restores from the snapshot; its losses after the cut
   must equal an uninterrupted run's bit for bit.
6. serve   — the serving path at the flagship widths: a continuous-
   batching engine (4 slots of 4096 positions, temperature 1.0) serves
   Zipf prompts of 1000, 700, 230 and 40 tokens and a fifth of 500 in a
   reused slot, is quiesced and dumped through its serving agentlet after
   24 rounds, and a second engine restores the snapshot and decodes 32
   rounds: tokens and final state bitwise equal to an uninterrupted
   engine's (a planted wrong position must fail that check); a lock-step
   engine snapshots and continues bit-identically. Prefill and decode
   times, a decode-round profile, snapshot size, the tag's zeroed share,
   quiesce, dump, restore and blackout. The serving path launches none
   of the three kernels (its attention is the plain one, as the
   reference's), and the phase fails if one launched.
7. io      — rates of the stages a dump and restore are made of
   (device-host copies, crc32, file write and read) on a buffer the size
   of the flagship's largest leaf.

The second-to-last lines are the kernels' JSON record (with the serving
phase's numbers under ``serving``) and the card's ``name, power limit``;
the last line is the result JSON. ``--seed`` seeds the serving phase's
weights and prompts (default 0). The script
imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import json
import math
import os
import re
import shutil
import signal
import subprocess
import sys
import tempfile
import time
import zlib

REPO = os.path.dirname(os.path.abspath(__file__))

# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit).
PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES = 3.35e12

LAYERS = 13
SEQ = 2048
BATCH = 2
TRAIN_STEPS = 8
MIGRATE_CUT = 3       # quiesce once the workload has printed this step
MIGRATE_STEPS = 8     # both the reference and the restored run end here

KERNELS = {  # name -> (CUDA source, the Pallas kernel it replaces)
    "flash_fwd": ("grit_tpu_torch/ops/csrc/flash_fwd.cu",
                  "grit_tpu/ops/flash_attention.py:43"),
    "flash_bwd_dq": ("grit_tpu_torch/ops/csrc/flash_bwd_dq.cu",
                     "grit_tpu/ops/flash_attention.py:178"),
    "flash_bwd_dkv": ("grit_tpu_torch/ops/csrc/flash_bwd_dkv.cu",
                      "grit_tpu/ops/flash_attention.py:225"),
}


def log(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


# -- phase 1 -------------------------------------------------------------------


def phase_device(torch) -> dict:
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device")
    name = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    log("device", f"{name} x{count}; torch {torch.__version__} "
                  f"cuda {torch.version.cuda}; nvidia-smi: {smi}")
    return {"name": name, "count": count, "smi": smi}


# -- phase 2 -------------------------------------------------------------------


def ptxas_report(build) -> dict:
    """Each kernel's registers a thread at launch, spill bytes and static
    shared memory, as ptxas reported them when the library was built
    (``<stem>.ptxas.log`` beside it). The Hopper kernels move registers
    from their producer to their consumer warpgroups with setmaxnreg after
    launch, and size their shared memory at launch; a spill fails."""
    out = {}
    for stem in build.SOURCES:
        text = (build.BUILD_DIR / f"{stem}.ptxas.log").read_text()
        regs = re.search(r"Used (\d+) registers", text)
        spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                          text)
        smem = re.search(r"(\d+) bytes smem", text)
        if regs is None or spill is None:
            raise RuntimeError(f"no ptxas report for {stem}:\n{text}")
        rep = {"registers": int(regs.group(1)),
               "spill_stores": int(spill.group(1)),
               "spill_loads": int(spill.group(2)),
               "static_smem": int(smem.group(1)) if smem else 0}
        warnings = [ln.strip() for ln in text.splitlines()
                    if "warning" in ln.lower()]
        log("build", f"ptxas {stem}: {rep['registers']} registers a thread at "
                     f"launch, spill stores {rep['spill_stores']} B, spill "
                     f"loads {rep['spill_loads']} B, static smem "
                     f"{rep['static_smem']} B"
                     + (f"; warnings: {warnings}" if warnings else ""))
        if rep["spill_stores"] or rep["spill_loads"]:
            raise AssertionError(f"{stem} spills registers")
        out[stem] = rep
    return out


# -- phase 3 helpers ---------------------------------------------------------------


def cuda_ms(torch, fn, iters: int, warmup: int = 2, windows: int = 1) -> float:
    """Device time of one ``fn()``: the mean over ``iters`` back-to-back
    calls, the median of ``windows`` such windows (one slow window, as a
    clock ramp or another process gives, does not move it)."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    times = []
    for _ in range(windows):
        torch.cuda.synchronize()
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / iters)
    return sorted(times)[len(times) // 2]


def bounds(B, S, H, KVH, hd) -> dict:
    """Least time (ms) for each kernel's work on these inputs: the larger
    of its causal FLOPs over the bf16 peak and its bytes (inputs read
    once, outputs written once) over the HBM rate."""
    pairs = B * H * S * (S + 1) / 2          # causal (query, key) pairs
    qbytes = B * S * H * hd * 2
    kvbytes = B * S * KVH * hd * 2
    rowbytes = B * H * S * 4                 # lse or delta, fp32
    work = {
        # Q.K^T and P.V
        "flash_fwd": (2 * 2 * pairs * hd, qbytes + 2 * kvbytes + qbytes + rowbytes),
        # Q.K^T, dO.V^T, dS.K
        "flash_bwd_dq": (3 * 2 * pairs * hd,
                         2 * qbytes + 2 * kvbytes + 2 * rowbytes + qbytes),
        # K.Q^T, V.dO^T, P^T.dO, dS^T.Q
        "flash_bwd_dkv": (4 * 2 * pairs * hd,
                          2 * qbytes + 2 * kvbytes + 2 * rowbytes + 2 * kvbytes),
    }
    out = {}
    for name, (flops, nbytes) in work.items():
        t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_HBM_BYTES
        out[name] = {"bound_ms": max(t_ops, t_bytes) * 1e3,
                     "bound_by": "operations" if t_ops >= t_bytes else "bytes",
                     "flops": flops}
    return out


def max_err(a, b) -> tuple[float, float]:
    """(max |a - b|, max |b|) in fp32."""
    a, b = a.float(), b.float()
    return (a - b).abs().max().item(), b.abs().max().item()


# Tolerances against the plain versions, on bf16 outputs. The kernels
# round P (and dS) to bf16 before their second product, as
# FlashAttention-2 does, and write bf16; the plain versions compute in
# fp32 and round once. Both effects are bf16 rounding (relative spacing
# 2^-8), so outputs must agree to a few bf16 ulps of their own scale:
# 2^-6 of the reference's largest magnitude, over the whole tensor and
# again within every 128-row tile of every head. The tile rule is the one
# that sees a tile the kernel got wrong: under causal attention dV and dK
# of the last keys are some 100 times smaller than the first key's, so
# zeros in their place stay inside the whole tensor's limit. LSE is an
# fp32 output whose only difference is summation order and exp2 vs exp:
# 1e-3 absolute.
REL_TOL = 2.0 ** -6
LSE_TOL = 1e-3
TILE = 128


def tile_ratio(got, want) -> float:
    """The worst, over 128-row tiles of each (batch, head), of max |err|
    in the tile over ``REL_TOL`` times max |want| in it: at most 1 passes.
    ``got`` and ``want`` are (B, S, heads, hd) with S a multiple of 128."""
    B, S, NH, hd = want.shape
    shape = (B, S // TILE, TILE, NH, hd)
    err = (got.float() - want.float()).abs().reshape(shape).amax(dim=(2, 4))
    scale = want.float().abs().reshape(shape).amax(dim=(2, 4))
    ratio = err / (REL_TOL * scale)
    return ratio.nan_to_num(nan=0.0).max().item()  # 0/0: an exact zero tile


def check_close(label: str, got, want) -> tuple[float, float]:
    """(max |err|, worst tile ratio); raises unless both rules hold."""
    err, scale = max_err(got, want)
    tol = REL_TOL * max(1.0, scale)
    if not err <= tol:
        raise AssertionError(f"{label}: max |err| {err} > {tol} (scale {scale})")
    ratio = tile_ratio(got, want)
    if not ratio <= 1.0:
        raise AssertionError(f"{label}: a 128-row tile's max |err| is {ratio} "
                             f"times 2^-6 of that tile's max |want|")
    return err, ratio


def fault_ratios(label: str, bad, want) -> tuple[float, float]:
    """The checks' own check: ``bad`` is an output with a planted fault.
    Returns the whole-tensor rule's err / tol and the tile rule's worst
    ratio (each passes at <= 1); raises unless the tile rule rejects the
    fault."""
    err, scale = max_err(bad, want)
    whole = err / (REL_TOL * max(1.0, scale))
    ratio = tile_ratio(bad, want)
    if not ratio > 1.0:
        raise AssertionError(f"{label}: the tile check passes a planted "
                             f"fault (ratio {ratio})")
    return whole, ratio


def planted_fault(label: str, got, want) -> tuple[float, float]:
    """``got`` with its last 128-row tile of the last (batch 0) head
    zeroed, as a kernel that dropped its last work item would leave it,
    through :func:`fault_ratios`."""
    bad = got.clone()
    bad[0, -TILE:, -1] = 0
    return fault_ratios(label, bad, want)


DQ_KV_TILE = 64  # key rows of one stage of the dQ kernel's K/V ring


def drop_diagonal_kv_tile(dq, q, k, v, do, lse, delta):
    """A copy of ``dq`` whose last 128-row q tile of the last (batch 0)
    head lacks the term of its last 64-row kv tile, scale.dS.K over keys
    S-64..S — what a dQ kernel whose K/V ring lost one stage would leave.
    That tile is the diagonal tile of the q tile's second half, rows
    S-64..S, the only rows that see those keys. ``lse`` and ``delta`` are
    (B, H, S) fp32."""
    _, S, H, hd = q.shape
    h, rows = H - 1, slice(S - DQ_KV_TILE, S)
    kvh = h // (H // k.shape[2])
    qf, dof = q[0, rows, h].float(), do[0, rows, h].float()
    kf, vf = k[0, rows, kvh].float(), v[0, rows, kvh].float()
    scale = hd ** -0.5
    p = (qf @ kf.T * scale - lse[0, h, rows, None]).exp().tril()
    ds = p * (dof @ vf.T - delta[0, h, rows, None])
    bad = dq.clone()
    bad[0, rows, h] = (dq[0, rows, h].float() - ds @ kf * scale).to(dq.dtype)
    return bad


def launch_resources(torch, calls: dict) -> dict:
    """Shared memory and registers a thread of one launch of each kernel,
    as the CUDA profiler recorded the launch (ptxas knows only static
    shared memory; the kernels size theirs at launch)."""
    from torch.profiler import ProfilerActivity, profile  # noqa: PLC0415

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for fn in calls.values():
            fn()
        torch.cuda.synchronize()
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.unlink(path)
    out = {}
    for ev in events:
        for name in calls:
            if ev.get("cat") == "kernel" and f"{name}_kernel" in ev["name"]:
                out[name] = {"smem": ev["args"].get("shared memory"),
                             "registers": ev["args"].get(
                                 "registers per thread")}
    return out


def phase_kernels(torch, fa, card: str) -> dict:
    """``card`` is the ``name, power limit`` line, printed beside every
    time and bound (a card below 700 W runs slower under load)."""
    import torch.nn.functional as F  # noqa: PLC0415

    dev = torch.device("cuda", 0)
    hd = 128
    results = {}
    for B, S, H, KVH in ((BATCH, SEQ, 20, 20), (BATCH, SEQ, 20, 4)):
        tag = f"B{B} S{S} H{H} KVH{KVH}"
        gen = torch.Generator(device=dev).manual_seed(1234)
        q, do = (torch.randn(B, S, H, hd, generator=gen, device=dev)
                 .to(torch.bfloat16) for _ in range(2))
        k, v = (torch.randn(B, S, KVH, hd, generator=gen, device=dev)
                .to(torch.bfloat16) for _ in range(2))

        o, lse = fa.flash_fwd(q, k, v)
        o_again, lse_again = fa.flash_fwd(q, k, v)
        po, plse = fa.flash_fwd_plain(q, k, v)
        torch.cuda.synchronize()
        if not (torch.equal(o, o_again) and torch.equal(lse, lse_again)):
            raise AssertionError(f"{tag}: forward kernel is not deterministic")
        err, tiles = {}, {}
        err["flash_fwd"], tiles["flash_fwd"] = check_close(f"{tag} O", o, po)
        lse_err = (lse - plse).abs().max().item()
        if not lse_err <= LSE_TOL:
            raise AssertionError(f"{tag} LSE: max |err| {lse_err} > {LSE_TOL}")

        # The backward kernels run on the plain forward's residuals, so
        # each is held against its own plain version alone.
        lse3 = plse.reshape(B, H, S).contiguous()
        delta = fa.attention_delta(do, po)
        dq = fa.flash_bwd_dq(q, k, v, do, lse3, delta)
        dq_again = fa.flash_bwd_dq(q, k, v, do, lse3, delta)
        dk, dv = fa.flash_bwd_dkv(q, k, v, do, lse3, delta)
        dk_again, dv_again = fa.flash_bwd_dkv(q, k, v, do, lse3, delta)
        pdq = fa.flash_bwd_dq_plain(q, k, v, do, lse3, delta)
        pdk, pdv = fa.flash_bwd_dkv_plain(q, k, v, do, lse3, delta)
        torch.cuda.synchronize()
        if not torch.equal(dq, dq_again):
            raise AssertionError(f"{tag}: dq kernel is not deterministic")
        if not (torch.equal(dk, dk_again) and torch.equal(dv, dv_again)):
            raise AssertionError(f"{tag}: dk/dv kernel is not deterministic")
        err["flash_bwd_dq"], tiles["flash_bwd_dq"] = check_close(
            f"{tag} dq", dq, pdq)
        (dk_err, dk_tile), (dv_err, dv_tile) = (
            check_close(f"{tag} dk", dk, pdk), check_close(f"{tag} dv", dv, pdv))
        err["flash_bwd_dkv"] = max(dk_err, dv_err)
        tiles["flash_bwd_dkv"] = max(dk_tile, dv_tile)
        log("kernels", f"{tag}: max|err| O {err['flash_fwd']:.3g} "
                       f"LSE {lse_err:.3g} dq {err['flash_bwd_dq']:.3g} "
                       f"dk/dv {err['flash_bwd_dkv']:.3g}; worst 128-row tile "
                       f"err / (2^-6 tile max) O {tiles['flash_fwd']:.4f} dq "
                       f"{tiles['flash_bwd_dq']:.4f} dk {dk_tile:.4f} dv "
                       f"{dv_tile:.4f}; all three bitwise deterministic on "
                       f"repeat")
        faults = {n: planted_fault(f"{tag} {n}", g, w)
                  for n, g, w in (("dk", dk, pdk), ("dv", dv, pdv))}
        log("kernels", f"{tag}: planted fault, the last kv tile of one kv "
                       f"head zeroed: " + "; ".join(
                           f"{n} whole-tensor err/tol {w:.4f}, worst tile "
                           f"{t:.4f}" for n, (w, t) in faults.items())
                       + " (each passes at <= 1): the tile check rejects it")
        w, t = fault_ratios(f"{tag} dq", drop_diagonal_kv_tile(
            pdq, q, k, v, do, lse3, delta), pdq)
        log("kernels", f"{tag}: planted fault, the plain dq's last q tile of "
                       f"one head without its last {DQ_KV_TILE}-row kv "
                       f"tile's term: "
                       f"whole-tensor err/tol {w:.4f}, worst tile {t:.4f} "
                       f"(each passes at <= 1): the tile check rejects it")

        calls = {
            "flash_fwd": lambda: fa.flash_fwd(q, k, v),
            "flash_bwd_dq": lambda: fa.flash_bwd_dq(q, k, v, do, lse3, delta),
            "flash_bwd_dkv": lambda: fa.flash_bwd_dkv(q, k, v, do, lse3, delta),
        }
        ms = {name: cuda_ms(torch, fn, 20, 5, 5) for name, fn in calls.items()}
        res = launch_resources(torch, calls)
        log("kernels", f"{tag} launch resources (profiler): " + "; ".join(
            f"{name} {r['registers']} registers a thread, {r['smem']} B "
            f"shared memory" for name, r in res.items()))
        plain_ms = {
            "flash_fwd": cuda_ms(torch, lambda: fa.flash_fwd_plain(q, k, v), 3, 1),
            "flash_bwd_dq": cuda_ms(torch, lambda: fa.flash_bwd_dq_plain(
                q, k, v, do, lse3, delta), 3, 1),
            "flash_bwd_dkv": cuda_ms(torch, lambda: fa.flash_bwd_dkv_plain(
                q, k, v, do, lse3, delta), 3, 1),
        }
        # Yardstick: SDPA on the same inputs in its (B, H, S, hd) view,
        # kv heads repeated outside the timed region for GQA. Its
        # backward computes dq, dk and dv in one call, so it stands
        # beside the sum of the two backward kernels, not either alone.
        groups = H // KVH
        qs = q.transpose(1, 2).detach().requires_grad_(True)
        ks = k.transpose(1, 2).repeat_interleave(groups, 1).detach().requires_grad_(True)
        vs = v.transpose(1, 2).repeat_interleave(groups, 1).detach().requires_grad_(True)
        sdpa_fwd = cuda_ms(torch, lambda: F.scaled_dot_product_attention(
            qs, ks, vs, is_causal=True), 20, 5, 5)
        out_s = F.scaled_dot_product_attention(qs, ks, vs, is_causal=True)
        g_s = do.transpose(1, 2)
        sdpa_bwd = cuda_ms(torch, lambda: torch.autograd.grad(
            out_s, (qs, ks, vs), g_s, retain_graph=True), 20, 5, 5)
        bnd = bounds(B, S, H, KVH, hd)
        for name in ms:
            tflops = bnd[name]["flops"] / (ms[name] * 1e-3) / 1e12
            log("kernels", f"{tag} {name}: {ms[name]:.4f} ms ({tflops:.1f} "
                           f"TFLOP/s), bound {bnd[name]['bound_ms']:.4f} ms "
                           f"({bnd[name]['bound_by']}), plain "
                           f"{plain_ms[name]:.3f} ms [{card}]")
        log("kernels", f"{tag} SDPA forward {sdpa_fwd:.4f} ms, SDPA backward "
                       f"{sdpa_bwd:.4f} ms vs dq+dkv kernels "
                       f"{ms['flash_bwd_dq'] + ms['flash_bwd_dkv']:.4f} ms "
                       f"[{card}]")
        results[tag] = {"err": err, "tiles": tiles, "ms": ms, "plain_ms": plain_ms, "res": res,
                        "bounds": bnd, "sdpa_fwd_ms": sdpa_fwd,
                        "sdpa_bwd_ms": sdpa_bwd}
        del qs, ks, vs, out_s
    return results


# -- phase 4 -------------------------------------------------------------------


def check_step_against_plain_path(torch, llama) -> None:
    """One loss and gradient at the flagship width (2 layers) through the
    flash kernels and through the plain attention reference, on the same
    weights and batch. bf16 activations round at other places on the two
    paths, so they agree to bf16 scale: 1e-2 relative on the loss, 5e-2
    relative L2 on every gradient; a wrong kernel is off by O(1)."""
    from grit_tpu_torch.ops import attention  # noqa: PLC0415
    from grit_tpu_torch.tree import flatten_with_names  # noqa: PLC0415

    cfg = llama.LlamaConfig.flagship(n_layers=2)
    gen = torch.Generator(device="cuda").manual_seed(7)
    params = llama.init_params(cfg, gen, "cuda")
    leaves = [p.requires_grad_(True) for _, p in flatten_with_names(params)]
    toks = torch.randint(0, cfg.vocab_size, (BATCH, SEQ + 1), device="cuda",
                         generator=gen)

    def loss_and_grads():
        loss = llama.loss_fn(cfg, params, toks[:, :-1], toks[:, 1:])
        return loss.item(), torch.autograd.grad(loss, leaves)

    flash_loss, flash_grads = loss_and_grads()
    gate = attention._use_flash
    attention._use_flash = lambda *a: False
    try:
        plain_loss, plain_grads = loss_and_grads()
    finally:
        attention._use_flash = gate
    worst = max((a.float() - b.float()).norm().item()
                / max(b.float().norm().item(), 1e-30)
                for a, b in zip(flash_grads, plain_grads))
    rel_loss = abs(flash_loss - plain_loss) / abs(plain_loss)
    log("train", f"flash vs plain attention path (2 layers): loss "
                 f"{flash_loss} vs {plain_loss} (rel {rel_loss:.2e}); worst "
                 f"gradient relative L2 error {worst:.2e}")
    if not (rel_loss <= 1e-2 and worst <= 5e-2):
        raise AssertionError("the flash path's step disagrees with the "
                             "plain path's")


def phase_train(torch, fa) -> dict:
    from grit_tpu_torch.models import llama  # noqa: PLC0415
    from grit_tpu_torch.workload import llama_trainer  # noqa: PLC0415

    check_step_against_plain_path(torch, llama)
    torch.cuda.empty_cache()
    cfg = llama.LlamaConfig.flagship(n_layers=LAYERS)
    tr = llama_trainer(cfg, batch=BATCH, seq=SEQ, device="cuda")
    tr.state  # materialize outside the timed steps
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in _leaves(tr.state["params"]))
    torch.cuda.reset_peak_memory_stats()
    fa.reset_launch_counts()
    losses, step_s = [], []
    for _ in range(TRAIN_STEPS):
        t0 = time.perf_counter()
        loss = float(tr.train_step()["loss"])  # float() syncs the step
        step_s.append(time.perf_counter() - t0)
        losses.append(loss)
    launches = dict(fa.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    steady = sorted(step_s[1:])[len(step_s[1:]) // 2]
    log("train", f"{n_params / 1e9:.3f} B params, layers {LAYERS}, "
                 f"B {BATCH} S {SEQ}; losses {losses}")
    log("train", f"step seconds {[round(s, 4) for s in step_s]}; median "
                 f"after the first {steady:.4f} s = {BATCH * SEQ / steady:.0f} "
                 f"tokens/s; max_memory_allocated {peak / 2**30:.2f} GiB; "
                 f"launches {launches}")
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"non-finite loss: {losses}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"loss did not fall: {losses}")
    for name in KERNELS:
        if launches[name] != LAYERS * TRAIN_STEPS:
            raise AssertionError(f"{name} launched {launches[name]} times, "
                                 f"want {LAYERS * TRAIN_STEPS}")
    del tr
    torch.cuda.empty_cache()
    return {"launches": launches, "losses": losses}


def _leaves(tree):
    from grit_tpu_torch.tree import flatten_with_names  # noqa: PLC0415

    return [x for _, x in flatten_with_names(tree)]


# -- phase 5 -------------------------------------------------------------------


class Workload:
    """One ``python -m grit_tpu_torch.workload`` process, its stdout read
    line by line; ``started`` is the host clock at the spawn."""

    def __init__(self, n_steps: int, env: dict) -> None:
        self.proc = subprocess.Popen(
            [sys.executable, "-m", "grit_tpu_torch.workload",
             "--layers", str(LAYERS), "--seq", str(SEQ),
             "--batch", str(BATCH)],
            cwd=REPO, env={**os.environ, **env, "N_STEPS": str(n_steps)},
            stdout=subprocess.PIPE, text=True)
        self.started = time.perf_counter()
        self.lines: list[str] = []

    def readline(self) -> str:
        line = self.proc.stdout.readline()
        if not line:
            rc = self.proc.wait()
            raise RuntimeError(f"workload exited (rc {rc}) after "
                               f"{self.lines[-5:]}")
        line = line.strip()
        self.lines.append(line)
        return line

    def wait_for(self, pattern: str) -> re.Match:
        while True:
            m = re.match(pattern, self.readline())
            if m:
                return m

    def losses(self) -> dict[int, float]:
        out = {}
        for line in self.lines:
            m = re.match(r"STEP (\d+) (\S+)", line)
            if m:
                out[int(m.group(1))] = float(m.group(2))
        return out

    def finish(self) -> None:
        self.wait_for("DONE")
        if self.proc.wait(timeout=120) != 0:
            raise RuntimeError(f"workload rc {self.proc.returncode}")

    def kill(self) -> None:
        if self.proc.poll() is None:
            self.proc.send_signal(signal.SIGKILL)
        self.proc.wait()


def phase_migrate(work: str) -> dict:
    from grit_tpu_torch.device.agentlet import ToggleClient  # noqa: PLC0415
    from grit_tpu_torch.device.snapshot import snapshot_nbytes  # noqa: PLC0415

    socks = os.path.join(work, "socks")
    snap = os.path.join(work, "ckpt", "hbm")
    os.makedirs(socks)
    env = {"GRIT_TPU_SOCKET_DIR": socks}
    procs: list[Workload] = []
    try:
        ref = Workload(MIGRATE_STEPS, env)
        procs.append(ref)
        ref.finish()
        ref_losses = ref.losses()

        src = Workload(1000, env)
        procs.append(src)
        src.wait_for("READY")
        src.wait_for(rf"STEP {MIGRATE_CUT} ")
        client = ToggleClient(src.proc.pid,
                              path=os.path.join(socks, f"grit-tpu-{src.proc.pid}.sock"))
        t_quiesce = time.perf_counter()
        cut = client.quiesce()
        t_dump = time.perf_counter()
        client.dump(snap)
        t_dumped = time.perf_counter()
        client.close()
        src.kill()
        nbytes = snapshot_nbytes(snap)

        dst = Workload(MIGRATE_STEPS, {**env, "GRIT_TPU_RESTORE_DIR": snap})
        procs.append(dst)
        restored = int(dst.wait_for(r"RESTORED (\d+)").group(1))
        t_restored = time.perf_counter()
        restore_s = float(dst.wait_for(r"RESTORE_SECONDS (\S+)").group(1))
        init_s = float(dst.wait_for(r"INIT_SECONDS (\S+)").group(1))
        dst.wait_for("READY")
        t_ready = time.perf_counter()
        dst.wait_for(r"STEP \d+ ")
        t_first = time.perf_counter()
        dst.finish()
    finally:
        for p in procs:
            p.kill()
    got = dst.losses()
    if restored != cut:
        raise AssertionError(f"restored step {restored}, quiesced at {cut}")
    want = {s: x for s, x in ref_losses.items() if s > cut}
    if got != want:
        raise AssertionError(f"losses after the cut differ from the "
                             f"uninterrupted run: {got} vs {want}")
    quiesce_s, dump_s = t_dump - t_quiesce, t_dumped - t_dump
    log("migrate", f"cut at step {cut}; losses after the cut bitwise equal "
                   f"to the uninterrupted run: {got}")
    log("migrate", f"snapshot {nbytes} bytes; quiesce {quiesce_s:.4f} s; "
                   f"dump {dump_s:.3f} s = {nbytes / dump_s / 1e9:.3f} GB/s; "
                   f"restore {restore_s:.3f} s = "
                   f"{nbytes / restore_s / 1e9:.3f} GB/s; blackout (quiesce → "
                   f"first post-restore step) {t_first - t_quiesce:.3f} s")
    log("migrate", f"restart: kill + spawn {dst.started - t_dumped:.3f} s; "
                   f"spawn → RESTORED {t_restored - dst.started:.3f} s = "
                   f"interpreter and imports "
                   f"{t_restored - dst.started - init_s - restore_s:.3f} s + "
                   f"set-up {init_s:.3f} s + restore "
                   f"{restore_s:.3f} s; RESTORED → READY "
                   f"{t_ready - t_restored:.3f} s; READY → first step "
                   f"{t_first - t_ready:.3f} s")
    return {"cut": cut, "bytes": nbytes}


# -- phase 6 -------------------------------------------------------------------

SERVE_SLOTS = 4
SERVE_MAX_LEN = 4096
SERVE_PROMPTS = (1000, 700, 230, 40)  # the 1024, 1024, 256 and 64 buckets
SERVE_SWAP = (12, 3, 500)  # after round 12, slot 3 leaves; 500 tokens join
SERVE_CUT = 24             # rounds before the migration
SERVE_AFTER = 32           # rounds the restored engine decodes
LOCKSTEP = (2, 512, 16)    # batch, prompt tokens, tokens generated
PROFILE_ROUNDS = 4


def zipf_tokens(torch, n: int, vocab: int, gen) -> "torch.Tensor":
    """``n`` token ids drawn from a Zipf law over the vocabulary (as the
    training workload draws its batches)."""
    zipf = 1.0 / torch.arange(1, vocab + 1, dtype=torch.float64)
    return torch.multinomial(zipf, n, replacement=True,
                             generator=gen).to(torch.int32)


class ServingTraffic:
    """The serving phase's request schedule, the same for every engine
    that runs it: four prompts admitted before round 1 and, after round
    ``SERVE_SWAP[0]``, the release of slot ``SERVE_SWAP[1]`` and the
    admission of a fifth prompt into it. Every event falls before the
    migration's cut, so the restored engine only decodes."""

    def __init__(self, torch, vocab: int, seed: int, sync,
                 buckets: tuple[int, ...]) -> None:
        gen = torch.Generator().manual_seed(seed)
        self.prompts = [zipf_tokens(torch, n, vocab, gen)
                        for n in (*SERVE_PROMPTS, SERVE_SWAP[2])]
        self.sync = sync
        self.buckets = buckets

    def _admit(self, submit, prompt, times: dict) -> int:
        """``submit(prompt)``, its time recorded under the prompt's
        prefill bucket."""
        t0 = time.perf_counter()
        slot = submit(prompt)
        self.sync()
        bucket = next(b for b in self.buckets if len(prompt) <= b)
        times.setdefault(bucket, []).append((time.perf_counter() - t0) * 1e3)
        return slot

    def start(self, submit, times: dict) -> list[int]:
        return [self._admit(submit, p, times) for p in self.prompts[:4]]

    def after_round(self, r: int, submit, release, slots: list[int],
                    times: dict) -> None:
        if r == SERVE_SWAP[0]:
            release(slots[SERVE_SWAP[1]])
            slot = self._admit(submit, self.prompts[4], times)
            if slot != slots[SERVE_SWAP[1]]:
                raise AssertionError(f"the freed slot {slots[SERVE_SWAP[1]]} "
                                     f"was not reused (got {slot})")


def serving_mismatch(torch, got: dict, want: dict, eng, ref) -> str | None:
    """The first difference between a restored engine's run and the
    uninterrupted one: tokens of each round after the cut, the
    bookkeeping leaves, then the KV cache at every position a slot has
    written (positions below its length; the rest holds prefill padding
    in an engine that never went through a snapshot and zeros in one
    restored from the tagged dump, and is written before any read)."""
    for r in sorted(got):
        if got[r] != want[r]:
            return f"round {r}: tokens {got[r]} vs {want[r]}"
    a, b = eng.state, ref.state
    for name in ("lengths", "active", "last_token", "rngs", "n_generated"):
        if not torch.equal(a[name], b[name]):
            return f"state leaf {name} differs"
    dev = a["cache"]["k"].device
    pos = torch.arange(a["cache"]["k"].shape[2], device=dev)
    written = (b["active"].to(dev)[:, None]
               & (pos[None, :] < b["lengths"].to(dev)[:, None]))
    written = written[None, :, :, None, None]
    for leaf in ("k", "v"):
        x, y = a["cache"][leaf], b["cache"][leaf]
        if not torch.equal(torch.where(written, x, 0), torch.where(written, y, 0)):
            return f"KV cache {leaf} differs at a written position"
    return None


def profile_decode(torch, eng, rounds: int) -> dict:
    """Device time by operator over ``rounds`` decode rounds of ``eng``
    (torch.profiler): each operator's kernels' time a round, their sum
    (the device's busy time), and the wall time of the profiled rounds."""
    from torch.autograd import DeviceType  # noqa: PLC0415
    from torch.profiler import ProfilerActivity, profile  # noqa: PLC0415

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(rounds):
            eng.step()
        wall = time.perf_counter() - t0
    ops = []
    for ev in prof.key_averages():
        # Host-side operators, each with the device time of the kernels
        # it launched itself (kernel events would count them twice).
        if ev.device_type != DeviceType.CPU:
            continue
        dev_us = getattr(ev, "self_device_time_total", None)
        if dev_us is None:
            dev_us = ev.self_cuda_time_total
        if dev_us > 0:
            ops.append((ev.key, dev_us / rounds / 1e3))
    ops.sort(key=lambda x: -x[1])
    return {"wall_ms": wall / rounds * 1e3,
            "device_ms": sum(ms for _, ms in ops), "top": ops[:8]}


def phase_serving(torch, fa, work: str, card: str, *, seed: int,
                  cfg=None, device: str = "cuda") -> dict:
    """The serving path: a continuous-batching engine at the flagship
    widths (``cfg`` and ``device`` other than the defaults only to
    rehearse the phase at a small size on the CPU) serves four requests
    and a fifth in a reused slot, is quiesced and dumped through its
    serving agentlet after ``SERVE_CUT`` rounds, and a second engine built
    from the same seed restores the snapshot and decodes ``SERVE_AFTER``
    rounds: its tokens and final state must equal an uninterrupted
    engine's over the same schedule, and a restored state with one slot's
    position one higher must not. Then a lock-step engine snapshots and
    continues in process."""
    import threading  # noqa: PLC0415

    from grit_tpu_torch.device.agentlet import ToggleClient  # noqa: PLC0415
    from grit_tpu_torch.device.snapshot import snapshot_nbytes  # noqa: PLC0415
    from grit_tpu_torch.models import llama  # noqa: PLC0415
    from grit_tpu_torch.models import serving  # noqa: PLC0415
    from grit_tpu_torch.serving import ServingAgentlet  # noqa: PLC0415

    dev = torch.device(device)
    on_card = dev.type == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    cfg = cfg or llama.LlamaConfig.flagship(n_layers=LAYERS)
    bcfg = serving.BatchingConfig(n_slots=SERVE_SLOTS,
                                  max_seq_len=SERVE_MAX_LEN, temperature=1.0,
                                  seed=seed)
    traffic = ServingTraffic(torch, cfg.vocab_size, seed, sync,
                             bcfg.prefill_buckets)
    total = SERVE_CUT + SERVE_AFTER

    def engine():
        """An engine with its own params from the seed (weights ship with
        the pod image, never with the snapshot)."""
        gen = torch.Generator(device=dev).manual_seed(seed)
        return serving.ContinuousBatchingEngine(
            cfg, llama.init_params(cfg, gen, dev), bcfg, device=dev)

    if on_card:
        torch.cuda.empty_cache()
    fa.reset_launch_counts()

    # The uninterrupted run, round by round.
    ref = engine()
    slots = traffic.start(ref.submit, {})
    want, round_ms = {}, []
    for r in range(1, total + 1):
        t0 = time.perf_counter()
        want[r] = ref.step()
        round_ms.append((time.perf_counter() - t0) * 1e3)
        traffic.after_round(r, ref.submit, ref.release, slots, {})
    if not all(len(want[r]) == SERVE_SLOTS for r in want):
        raise AssertionError("a round emitted for fewer than every slot")
    if not all(0 <= t < cfg.vocab_size for r in want for t in want[r].values()):
        raise AssertionError("a token outside the vocabulary")

    # The source serves behind its agentlet on a loop thread; the
    # destination is set up beforehand, as a destination pod is.
    src, dst = engine(), engine()
    prefill_ms: dict = {}
    adapter = ServingAgentlet(src, drain_mode="serialize",
                              path=os.path.join(work, "serve.sock"))
    at_cut = threading.Event()
    box: dict = {"error": None, "tokens": {}}

    def serve_loop() -> None:
        try:
            s = traffic.start(adapter.submit, prefill_ms)
            for r in range(1, SERVE_CUT + 1):
                box["tokens"][r] = adapter.step()
                traffic.after_round(r, adapter.submit, src.release, s,
                                    prefill_ms)
                if r < SERVE_CUT:
                    adapter.batch_boundary()
            at_cut.set()
            deadline = time.monotonic() + 300
            while not adapter.agentlet.quiesce_pending:
                if time.monotonic() > deadline:
                    raise TimeoutError("no quiesce arrived at the cut")
                time.sleep(0.001)
            adapter.batch_boundary()  # drains (serialize), parks, resumes
        except BaseException as exc:  # noqa: BLE001 — re-raised below
            box["error"] = exc
            at_cut.set()

    snap = os.path.join(work, "serve-snap")
    loop = threading.Thread(target=serve_loop, name="serve-loop", daemon=True)
    with adapter:
        loop.start()
        if not at_cut.wait(600) or box["error"] is not None:
            raise RuntimeError(f"serving loop failed: {box['error']!r}")
        # The blackout: quiesce, dump, restore into the destination, its
        # first token. The source stays parked meanwhile, as a migrated
        # pod's source does until it is killed.
        with ToggleClient(0, path=adapter.agentlet.path, timeout=600) as client:
            t_quiesce = time.perf_counter()
            cut = client.quiesce()
            t_dump = time.perf_counter()
            client.dump(snap)
            t_restore = time.perf_counter()
            dst.restore(snap)
            sync()
            t_restored = time.perf_counter()
            got = {SERVE_CUT + 1: dst.step()}
            t_first = time.perf_counter()
            client.resume()
        loop.join(timeout=120)
    if loop.is_alive() or box["error"] is not None:
        raise RuntimeError(f"serving loop failed: {box['error']!r}")
    if cut != SERVE_CUT or box["tokens"] != {r: want[r] for r in box["tokens"]}:
        raise AssertionError(f"the source diverged from the uninterrupted "
                             f"run before the cut (cut at round {cut})")
    nbytes = snapshot_nbytes(snap)
    for r in range(SERVE_CUT + 2, total + 1):
        got[r] = dst.step()
    # The share of the dumped KV bytes the tag zeroed: the source still
    # holds the cut's state (its loop ended at the park).
    tagged = src.snapshot_state()["cache"]
    zeroed = 1 - (int(torch.count_nonzero(tagged["k"]))
                  + int(torch.count_nonzero(tagged["v"]))) / (
                      2 * tagged["k"].numel())
    live = int(((src.state["lengths"] + 1) * src.state["active"]).sum())
    expect_zeroed = 1 - live / (SERVE_SLOTS * SERVE_MAX_LEN)
    del tagged
    bad = serving_mismatch(torch, got, want, dst, ref)
    if bad is not None:
        raise AssertionError(f"the restored engine diverged: {bad}")

    # Planted fault: the same snapshot with one active slot one position
    # further on must fail the same check.
    dst.restore(snap)
    fault_slot = int(torch.nonzero(dst.state["active"])[0])
    dst.state["lengths"][fault_slot] += 1
    planted = serving_mismatch(
        torch, {r: dst.step() for r in range(SERVE_CUT + 1, total + 1)},
        want, dst, ref)
    if planted is None:
        raise AssertionError("the continuation check passed a restored "
                             "state with a wrong position")

    # Lock-step engine: snapshot mid-generation, continue in a second one.
    B, S, n_tok = LOCKSTEP
    lcfg = serving.ServingConfig(batch_size=B, max_seq_len=1024,
                                 temperature=1.0, seed=seed)
    prompt = zipf_tokens(torch, B * S, cfg.vocab_size,
                         torch.Generator().manual_seed(seed + 1)).reshape(B, S)
    lock = serving.InferenceEngine(cfg, ref.params, lcfg, device=dev)
    lock.prefill(prompt)
    lock.generate(n_tok // 2 - 1)
    lsnap = os.path.join(work, "lockstep-snap")
    lock.snapshot(lsnap)
    lwant = lock.generate(n_tok // 2)
    lock2 = serving.InferenceEngine(cfg, src.params, lcfg, device=dev)
    if lock2.restore(lsnap) != n_tok // 2:
        raise AssertionError("lock-step restore lost its n_generated")
    lgot = lock2.generate(n_tok // 2)
    if not (torch.equal(lgot, lwant) and torch.equal(
            lock2.state["cache"]["k"], lock.state["cache"]["k"])):
        raise AssertionError("the lock-step engine did not continue "
                             "bit-identically")
    launches = dict(fa.LAUNCHES)
    if any(launches.values()):
        raise AssertionError(f"the serving path launched flash kernels "
                             f"{launches}; its attention is the plain one")

    prof = profile_decode(torch, ref, PROFILE_ROUNDS) if on_card else None
    steady = sorted(round_ms[2:])[len(round_ms[2:]) // 2]
    kv_bytes = 2 * ref.state["cache"]["k"].numel() * ref.state["cache"]["k"].element_size()
    quiesce_s, dump_s = t_dump - t_quiesce, t_restore - t_dump
    restore_s = t_restored - t_restore
    log("serve", f"flagship widths, {cfg.n_layers} layers, {SERVE_SLOTS} "
                 f"slots x {SERVE_MAX_LEN} positions (KV cache {kv_bytes} "
                 f"bytes), buckets {bcfg.prefill_buckets}, temperature 1.0; "
                 f"prompts {SERVE_PROMPTS}, then {SERVE_SWAP[2]} tokens into "
                 f"slot {SERVE_SWAP[1]} after round {SERVE_SWAP[0]}")
    log("serve", "prefill ms by bucket (source engine; prompts "
                 f"{[len(p) for p in traffic.prompts]}): " + "; ".join(
                     f"{b}: {[round(x, 3) for x in ms]}"
                     for b, ms in sorted(prefill_ms.items())) + f" [{card}]")
    log("serve", f"decode round ms (uninterrupted run, {total} rounds): "
                 f"median after the first two {steady:.3f} = "
                 f"{SERVE_SLOTS / steady * 1e3:.1f} tokens/s; first two "
                 f"{[round(x, 3) for x in round_ms[:2]]} [{card}]")
    if prof is not None:
        log("serve", f"decode round profile ({PROFILE_ROUNDS} rounds under "
                     f"torch.profiler): wall {prof['wall_ms']:.3f} ms a round, "
                     f"device busy {prof['device_ms']:.3f} ms (idle share "
                     f"{1 - prof['device_ms'] / prof['wall_ms']:.3f}; of the "
                     f"unprofiled median round "
                     f"{1 - prof['device_ms'] / steady:.3f}); kernel time by "
                     f"operator, ms a round: " + "; ".join(
                         f"{k} {ms:.3f}" for k, ms in prof["top"]))
    log("serve", f"snapshot {nbytes} bytes; KV bytes the tag zeroed "
                 f"{zeroed:.4f} (expected from the positions "
                 f"{expect_zeroed:.4f}); quiesce {quiesce_s:.4f} s; dump "
                 f"{dump_s:.3f} s = {nbytes / dump_s / 1e9:.3f} GB/s; restore "
                 f"{restore_s:.3f} s = {nbytes / restore_s / 1e9:.3f} GB/s; "
                 f"first token of the restored engine {t_first - t_restored:.3f}"
                 f" s; blackout (quiesce → that token) "
                 f"{t_first - t_quiesce:.3f} s [{card}]")
    log("serve", f"migrated after round {cut}: rounds {SERVE_CUT + 1}.."
                 f"{total} bitwise equal to the uninterrupted run, final "
                 f"state (positions, RNG words, counts, the KV cache at every "
                 f"written position) torch.equal; planted fault (slot {fault_slot} one position "
                 f"on) rejected: {planted}")
    log("serve", f"lock-step: batch {B}, {S}-token prompt, {n_tok} tokens, "
                 f"snapshot after {n_tok // 2}: continues bit-identically; "
                 f"flash kernel launches on the serving path {launches}")
    return {"flash_launches": launches, "decode_round_ms": steady,
            "tokens_per_s": SERVE_SLOTS / steady * 1e3,
            "prefill_ms": {str(b): ms for b, ms in prefill_ms.items()},
            "snapshot_bytes": nbytes, "kv_zeroed_fraction": zeroed,
            "quiesce_s": quiesce_s, "dump_s": dump_s, "restore_s": restore_s,
            "blackout_s": t_first - t_quiesce,
            "device_busy_ms": None if prof is None else prof["device_ms"]}


def phase_io(torch, work: str, card: str) -> None:
    """Rates of the stages the dump and restore are made of, on a buffer
    the size of the flagship's largest leaf (the stacked MLP weights),
    fastest of three calls after a warm-up: device-host copies (pageable,
    as the snapshot code makes them, and pinned), ``zlib.crc32``, and file
    write and read through the page cache beside the snapshot."""
    import numpy as np  # noqa: PLC0415

    n = LAYERS * 2560 * 6912 * 2
    dev = torch.device("cuda", 0)
    src = torch.randint(0, 255, (n,), dtype=torch.uint8, device=dev)
    pinned = torch.empty(n, dtype=torch.uint8, pin_memory=True)
    host = src.cpu().numpy()
    path = os.path.join(work, "io-stage.bin")

    def synced(fn):
        def run():
            fn()
            torch.cuda.synchronize()
        return run

    def write():
        with open(path, "wb") as f:
            f.write(host)

    def read():
        with open(path, "rb") as f:
            f.readinto(memoryview(np.empty(n, np.uint8)))

    stages = [
        ("D2H pageable", synced(lambda: src.cpu())),
        ("D2H pinned", synced(lambda: pinned.copy_(src, non_blocking=True))),
        ("H2D pageable", synced(lambda: torch.from_numpy(host).to(dev))),
        ("H2D pinned", synced(lambda: src.copy_(pinned, non_blocking=True))),
        ("zlib.crc32", lambda: zlib.crc32(host)),
        ("file write", write),
        ("file read", read),
    ]
    rates = []
    for label, fn in stages:
        fn()
        best = float("inf")
        for _ in range(3):
            t0 = time.perf_counter()
            fn()
            best = min(best, time.perf_counter() - t0)
        rates.append(f"{label} {n / best / 1e9:.3f} GB/s")
    os.unlink(path)
    log("io", f"stage rates on {n} bytes ({os.cpu_count()} CPUs): "
              f"{'; '.join(rates)} [{card}]")


# -- main ----------------------------------------------------------------------


def main(argv: list[str] | None = None) -> int:
    import argparse  # noqa: PLC0415

    import torch  # noqa: PLC0415

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--seed", type=int, default=0,
                   help="seed of the serving phase's weights and prompts")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    try:
        from grit_tpu_torch.ops import build  # noqa: PLC0415
        from grit_tpu_torch.ops import flash_attention as fa  # noqa: PLC0415
    except ImportError as exc:
        print(f"chip_smoke: the grit_tpu_torch package is not beside this "
              f"script: {exc}", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    device = phase_device(torch)
    t0 = time.perf_counter()
    build.build_all()
    log("build", f"3 kernels built in {time.perf_counter() - t0:.2f} s "
                 f"into {os.path.relpath(build.BUILD_DIR, REPO)}")
    ptxas_report(build)
    kern = phase_kernels(torch, fa, device["smi"])
    train = phase_train(torch, fa)
    work = tempfile.mkdtemp(prefix="chip-smoke-")
    try:
        phase_migrate(work)
        serve = phase_serving(torch, fa, work, device["smi"], seed=args.seed)
        phase_io(torch, work, device["smi"])
    finally:
        shutil.rmtree(work, ignore_errors=True)

    main_shape = kern[f"B{BATCH} S{SEQ} H20 KVH20"]
    record = {"kernels": [{
        "name": name,
        "route": "cuda",
        "source": src,
        "replaces": replaces,
        "launches": train["launches"][name],
        "max_abs_err": main_shape["err"][name],
        "worst_tile_err_ratio": main_shape["tiles"][name],
        "ms": main_shape["ms"][name],
        "plain_ms": main_shape["plain_ms"][name],
        "bound_ms": main_shape["bounds"][name]["bound_ms"],
        "bound_by": main_shape["bounds"][name]["bound_by"],
        # SDPA's backward computes dq, dk and dv in one call: it is the
        # yardstick of the two backward kernels together, not of either.
        "library_ms": main_shape["sdpa_fwd_ms" if name == "flash_fwd"
                                 else "sdpa_bwd_ms"],
        "smem_bytes": main_shape["res"].get(name, {}).get("smem"),
        "library_covers": ("scaled_dot_product_attention forward"
                           if name == "flash_fwd" else
                           "scaled_dot_product_attention backward: dq, dk "
                           "and dv in one call (flash_bwd_dq + flash_bwd_dkv)"),
    } for name, (src, replaces) in KERNELS.items()],
        # The serving path runs no kernel of the list (its attention is
        # the plain one, as the reference's); its launches and numbers.
        "serving": serve}
    print(json.dumps(record), flush=True)
    print(device["smi"], flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": device["name"], "count": device["count"]}}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
