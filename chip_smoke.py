#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``grit_tpu_torch``) on one GPU.

Run from the repository root on a machine with an NVIDIA H100::

    python3 chip_smoke.py

Phases, each printing its own lines; any failure raises and exits
non-zero without the final result line:

1. device  — the card's name, count and power limit (``nvidia-smi``).
2. build   — compile the three flash-attention kernels from
   ``grit_tpu_torch/ops/csrc`` (one ``nvcc`` per source, in parallel).
3. kernels — at the flagship attention shape (B 2, S 2048, 20 heads,
   hd 128, bf16) and at a GQA shape (20 q heads on 4 kv heads), each
   kernel against its plain PyTorch version; timings of kernel, plain
   version and ``scaled_dot_product_attention`` (the yardstick, never
   used by the port); the bound; dq run twice must be bitwise equal.
4. train   — the main path: a ``Trainer`` at the flagship widths (dim
   2560, 20 heads of 128, hidden 6912, vocab 32000, 13 layers, S 2048,
   batch 2, bf16) takes a few steps; losses finite and falling, and every
   kernel's launch count equals layers × steps.
5. migrate — the system's path: ``python -m grit_tpu_torch.workload``
   trains, is quiesced and dumped through its agentlet, SIGKILLed, and a
   fresh process restores from the snapshot; its losses after the cut
   must equal an uninterrupted run's bit for bit.
6. io      — rates of the stages a dump and restore are made of
   (device-host copies, crc32, file write and read) on a buffer the size
   of the flagship's largest leaf.

The second-to-last lines are the kernels' JSON record and the card's
``name, power limit``; the last line is the result JSON. The script
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


# -- phase 3 helpers ---------------------------------------------------------------


def cuda_ms(torch, fn, iters: int, warmup: int = 2) -> float:
    """Mean device time of ``fn()`` over ``iters`` back-to-back calls."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


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
# 2^-6 of the reference's largest magnitude. LSE is an fp32 output whose
# only difference is summation order and exp2 vs exp: 1e-3 absolute.
REL_TOL = 2.0 ** -6
LSE_TOL = 1e-3


def check_close(label: str, got, want) -> float:
    err, scale = max_err(got, want)
    tol = REL_TOL * max(1.0, scale)
    if not err <= tol:
        raise AssertionError(f"{label}: max |err| {err} > {tol} (scale {scale})")
    return err


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
        po, plse = fa.flash_fwd_plain(q, k, v)
        torch.cuda.synchronize()
        err = {"flash_fwd": check_close(f"{tag} O", o, po)}
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
        pdq = fa.flash_bwd_dq_plain(q, k, v, do, lse3, delta)
        pdk, pdv = fa.flash_bwd_dkv_plain(q, k, v, do, lse3, delta)
        torch.cuda.synchronize()
        if not torch.equal(dq, dq_again):
            raise AssertionError(f"{tag}: dq kernel is not deterministic")
        err["flash_bwd_dq"] = check_close(f"{tag} dq", dq, pdq)
        err["flash_bwd_dkv"] = max(check_close(f"{tag} dk", dk, pdk),
                                   check_close(f"{tag} dv", dv, pdv))
        log("kernels", f"{tag}: max|err| O {err['flash_fwd']:.3g} "
                       f"LSE {lse_err:.3g} dq {err['flash_bwd_dq']:.3g} "
                       f"dk/dv {err['flash_bwd_dkv']:.3g}; dq bitwise "
                       f"deterministic")

        ms = {
            "flash_fwd": cuda_ms(torch, lambda: fa.flash_fwd(q, k, v), 20),
            "flash_bwd_dq": cuda_ms(
                torch, lambda: fa.flash_bwd_dq(q, k, v, do, lse3, delta), 20),
            "flash_bwd_dkv": cuda_ms(
                torch, lambda: fa.flash_bwd_dkv(q, k, v, do, lse3, delta), 20),
        }
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
            qs, ks, vs, is_causal=True), 20)
        out_s = F.scaled_dot_product_attention(qs, ks, vs, is_causal=True)
        g_s = do.transpose(1, 2)
        sdpa_bwd = cuda_ms(torch, lambda: torch.autograd.grad(
            out_s, (qs, ks, vs), g_s, retain_graph=True), 20)
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
        results[tag] = {"err": err, "ms": ms, "plain_ms": plain_ms,
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


def main() -> int:
    import torch  # noqa: PLC0415

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
    kern = phase_kernels(torch, fa, device["smi"])
    train = phase_train(torch, fa)
    work = tempfile.mkdtemp(prefix="chip-smoke-")
    try:
        phase_migrate(work)
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
        "ms": main_shape["ms"][name],
        "plain_ms": main_shape["plain_ms"][name],
        "bound_ms": main_shape["bounds"][name]["bound_ms"],
        "bound_by": main_shape["bounds"][name]["bound_by"],
        # SDPA's backward computes dq, dk and dv in one call: it is the
        # yardstick of the two backward kernels together, not of either.
        "library_ms": main_shape["sdpa_fwd_ms" if name == "flash_fwd"
                                 else "sdpa_bwd_ms"],
        "library_covers": ("scaled_dot_product_attention forward"
                           if name == "flash_fwd" else
                           "scaled_dot_product_attention backward: dq, dk "
                           "and dv in one call (flash_bwd_dq + flash_bwd_dkv)"),
    } for name, (src, replaces) in KERNELS.items()]}
    print(json.dumps(record), flush=True)
    print(device["smi"], flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": device["name"], "count": device["count"]}}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
