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
   kernel's launch count equals layers × steps. Then the same steps with
   phase 9's frozen-trunk optimizer, timed the same way: losses finite,
   the forward launched layers × steps times, the backward kernels never.
5. migrate — the system's path: ``python -m grit_tpu_torch.workload``
   trains, is quiesced and dumped through its agentlet, SIGKILLed, and a
   fresh process restores from the snapshot; its losses after the cut
   must equal an uninterrupted run's bit for bit (that run starts beside
   the source, which waits parked at its first step until the run is
   done, so nothing timed overlaps it). The dump's and the
   restore's data path (pinned staging ring, restore readers) and their
   legs are printed. The observability and fault seams ride along: the
   script plays the node and configures the migration's flight log; the
   source runs with the flight recorder, a trace sink, its ``/metrics``
   server and ``GRIT_FAULT_POINTS=device.agentlet.dump:raise:x1`` (the
   first dump must fail with the injected fault, the agentlet's status
   still answer, the retry commit; the blackout includes the failed
   request); ``/metrics``' snapshot bytes must equal the snapshot's; the
   flight log must hold the source's dump bracket with its chunks and
   the destination's one ``restart.start`` (its prefetch, before
   ``import torch``), ``restart.end`` and place bracket, from the right
   pids in wall-clock order; the trace must hold ``snapshot.write`` and
   ``snapshot.restore`` with no orphan span. The phase profiler's folded
   stacks of the source's dump and the destination's place must lie
   beside the flight log, every stack under a category; the
   destination's ``/metrics``, up from its prefetch, must read the
   snapshot's bytes as its place progress (shipped and total), profiler
   ticks, and answer ``/debug/threadz`` and ``/version``. An ``obs`` line,
   printed before the kernels record, splits the blackout by the flight
   log, kill to ``place.start`` at ``restart.start``.
6. serve   — the serving path at the flagship widths: a continuous-
   batching engine (4 slots of 4096 positions, temperature 1.0) serves
   Zipf prompts of 1000, 700, 230 and 40 tokens and a fifth of 500 in a
   reused slot, is quiesced and dumped through its serving agentlet after
   24 rounds, and a second engine restores the snapshot and decodes 32
   rounds: tokens and final state bitwise equal to an uninterrupted
   engine's (a planted wrong position must fail that check); a lock-step
   engine snapshots and continues bit-identically. Then the snapshot
   fan-out: the source completes one request, is snapshotted, and two
   clone engines restore that snapshot by post-copy (``fan_out_clones``),
   each serving a new request on the free slot while its KV cache still
   lands; after ``absorb_restored`` every stream's tokens equal the
   source's. Prefill and decode times, a decode-round profile, snapshot
   size, the tag's zeroed share, quiesce, dump, restore and blackout,
   each clone's hot set and tail. The serving path launches none of the
   three kernels (its attention is the plain one, as the reference's),
   and the phase fails if one launched.
7. io      — rates of the stages a dump and restore are made of
   (device-host copies, crc32, sha256, file write and read) on a buffer
   the size of the flagship's largest leaf; the port's crc32c library
   (built here with the host compiler, its path printed) held to the RFC
   3720 vectors and to its plain version at unaligned lengths on both of
   its paths, and timed against ``zlib.crc32``; zlib level 1, the codec
   stage's, on one 64 MiB piece.
8. precopy — the reference agent's pre-copy and streamed-stage migration
   of phase 5's flagship cut to 2 layers (the widths stay the
   flagship's), driven as the agent drives it: a live pass at
   step 2 (quiesce, hashed dump mirrored to a PVC directory, resume), the
   blackout at step 3 (quiesce with a dump spec: a boundary clone written
   to ``<hbm>-spec`` as a delta against the live pass while the loop
   steps on to its park; the dump validates it and re-ships, mirrored,
   what changed; it must answer ``validated``), a re-dump of the parked
   state against the delta that must write nothing, the mirrors' COMMIT
   identities against the primaries' manifests, then a streamed stage of
   the three trees in the agent's journal
   format: metadata staged, a destination spawned, the data streamed in
   64 MiB pieces only once it prints ``RESTORE_BEGIN``. Its losses after
   the cut must equal an uninterrupted run's at that depth bit for bit, its
   restore must have waited on the stream, and a second stage whose
   journal fails mid-stream must make the destination exit non-zero with
   ``SnapshotIntegrityError``; the uninterrupted run, the reference, runs
   beside that last destination, where nothing is timed. Tree sizes,
   dirty shares, dump and restore legs and the blackout split print as
   ``[precopy]`` lines.
9. frozen  — the fine-tune ``bench.py`` migrates, at phase 5's shape:
   ``--optimizer frozen-trunk`` (sgd 0.5 on ``final_norm`` and
   ``lm_head``, the trunk frozen). An uninterrupted run counts each
   kernel's launches a step (its trunk runs no backward, so only the
   forward may launch); then it is migrated through the
   port's node hook, ``TpuDeviceCheckpointHook``, with pre-copy and
   speculation on: ``predump`` at step 2 (the non-parking probe: it must
   answer ``probe`` with no fallback, and the steps the source took
   meanwhile are printed), the blackout (it must answer ``validated``;
   the leaves written since the live pass must be exactly ``final_norm``,
   ``lm_head`` and the step, and the re-ship must write those the last
   step touched), the kernel libraries the snapshot carries uploaded
   beside the mirrors, a streamed stage, and a destination with an empty
   ``GRIT_TPU_COMPILE_CACHE`` that must seed the three libraries, compile
   none and continue bit-identically; a second destination restores the
   staged tree with ``GRIT_RESTORE_POSTCOPY=1`` and must continue
   bitwise too (hot set, READY, first step and tail printed). Then the
   harness's MNIST workload (``--model mnist``) migrated once through
   ``AutoDeviceHook``, bitwise, and a pid without an agentlet skipped
   loudly; the MNIST reference, the MNIST destination, the
   uninterrupted frozen-trunk run (the launch counts' run) and the
   post-copy destination start together after the MNIST dump (so the
   post-copy numbers are taken beside them). ``[frozen]`` lines.
10. wire   — phase 5's flagship at 2 layers migrated over the wire into
   this script's own receiver (both runs' sources start together and
   wait parked at their first step, so their process starts overlap;
   the reference's frames and journal: frame
   crc, codec records decoded and checked against their crc of the raw
   bytes, waterline lines, eof): the dump carries a wire spec and a PVC
   mirror, the rest of the tree is staged after it and a destination
   spawned on the landed tree, which continues bitwise from the source's
   own run, resumed after the dump. (a) raw (the default codec): the wire
   carries the raw bytes; (b) under ``GRIT_SNAPSHOT_CODEC=zlib``: the
   wire carries codec records, the mirror is a container with a
   ``.gritc`` sidecar, and a second destination restores from it,
   bitwise too; before the source resumes, a second dump of it into a
   receiver that hangs up mid-stream must answer ``ok`` with a failed
   wire block and a committed mirror. A byte flipped in one frame must
   fail the stream. Bytes raw and on the wire,
   records compressed and raw, ``send_s``, ``stall_s``,
   ``dump_overlap_bytes``, dump and blackout print as ``[wire]`` lines.
11. lora   — the north star's workload (the JAX package's
   ``examples/workload.py``): ``--model lora`` at Llama-2-7B's full width
   (32 layers, dim 4096, 32 heads of 128, hidden 11008, vocab 32000, f32
   params, bf16 activations), adapters of rank 16 on ``wq`` and ``wv``, S
   2048, batch 8, per-layer remat. An uninterrupted run of 6 steps; a run
   quiesced after step 3 through its agentlet, dumped, killed, and a fresh
   process that rebuilds the frozen base from its seed, restores the
   adapters and their Adam state and continues: its losses must equal the
   uninterrupted run's bit for bit, and each step must launch the forward
   64 times (twice a layer under remat) and dQ and dK/dV 32 times. Step
   seconds, tokens/s, ``max_memory_allocated``, snapshot bytes and the
   blackout split (process start, base rebuild, restore, first step),
   read against the north star's 60 s. ``[lora]`` lines.
12. remat  — the same trainer at 4 layers, batch 2: one loss and the
   adapters' gradients with remat off and on, bitwise equal, the forward
   launched twice a layer with it on, the peak memory lower; both peaks
   printed. ``[remat]`` lines.
13. moe    — ``bench.py``'s MoE model (``bench_moe``: dim 1024, 12
   layers, 8 heads of 128, hidden 3584, 8 experts, top-2, bf16, about
   0.82 B params) at batch 16 x seq 512: the bench's forward tokens/s,
   then ``--model moe`` trained with Adam and migrated as phase 11 is,
   bitwise, each kernel launched 12 times a step; its uninterrupted
   run starts beside the source, as phase 5's does (two such models fit
   on the card; LoRA-7B's do not), and the step times are the
   destination's. ``[moe]`` lines.
14. moe_serve — phase 6's serving path for the same MoE model (both
   engines dispatch on ``MoeLlamaConfig``): a continuous-batching engine
   of 4 slots x 1024 positions at temperature 1.0, Zipf prompts of 700,
   500, 230 and 40 tokens and a fifth of 300 in a reused slot, migrated
   through its serving agentlet after 24 rounds and bitwise equal to an
   uninterrupted engine after it; the lock-step engine likewise; no
   flash launch. Then the masked prefill: a 230-token prompt padded to
   its 256 bucket with the pads masked out of the routing must give the
   unpadded prompt's next-token logits (at non-binding capacity, within
   2^-6 of their largest). ``[moe_serve]`` lines.
15. long_context — four ranks of ``grit_tpu_torch.parallel.launch`` on
   the one card over ``LOCAL_GLOO`` (gloo for barriers, a CUDA tensor's
   bytes between the ranks' device buffers; one launch runs
   phases 15 and 16, and the kernels are built before it): the flagship
   widths (4 layers, remat; 13 until PR 12) at B 1 x S 8192, 2048
   positions a rank.
   ``forward_sp`` with the ring and with Ulysses against the dense flash
   forward on the whole sequence (run on every rank), the loss's
   gradients against dense, bytewise equal on every rank; one Trainer
   step of each scheme, the state bytewise equal on every rank, and rank
   0's snapshot restored into a dense Trainer byte for byte, which steps
   on. Ulysses launches each kernel a layer, the ring none.
   ``[long_context]`` lines.
16. pipeline — the same ranks as pipeline stages: the flagship widths
   at 12 layers (four stages of 3, remat), B 8 x S 2048 in 4
   microbatches, and the MoE model (12 layers, capacity factor 8, so
   nothing drops) at B 16 x S 512: logits and cross-entropy gradients of
   each stage against the dense model (for the MoE model microbatch by
   microbatch, as the pipeline routes), every rank's tick time and
   launches (each stage's layers a tick, bubbles included). Then pp × ep
   in the same launch: the MoE model on a (pipe 2, expert 2) mesh of the
   four ranks (6 layers a stage, 4 experts a rank,
   ``moe_llama.forward_pp(mesh=)``), its logits and gradients held to the
   ``moe`` leg's dense reference, its staged shards dumped by the four
   ranks into one manifest (``pp_stage_shardings``' descriptors),
   restored by every rank onto the mesh bitwise and by rank 0 densely,
   byte for byte. ``[pipeline]`` lines.
17. gang   — phase 16's dense pipeline at 4 layers (one a stage; 12
   until PR 12) as a training gang: four ranks
   (one stage each, Adam 1e-4, Zipf batches) whose agentlets carry a
   slice gate over a file rendezvous with the lockstep collective take a
   few steps; four port hooks (``TpuDeviceCheckpointHook`` under
   ``GRIT_SLICE_HOSTS=4``) dump them into ``host-<k>`` from four threads
   started about a step apart. Every manifest must carry the same step;
   the sources resume to cut + 3, and four fresh ranks each restore
   ``host-<k>`` and run to cut + 3: losses and final state bitwise equal
   to their source's, and each kernel launched 14 / 7 / 7 times a step
   on every rank. The cut, each rank's step at its request and barrier
   wait, dump seconds and bytes, the gang blackout (first request to the
   last commit), restore seconds and launches a rank a step print as
   ``[gang]`` lines. Then phase 20's pipe axis, in the same restore
   launch: the restored stages' state taken over by a pipelined Trainer
   on a pipe mesh (``STAGE_RULES``) writes one manifest (layer leaves
   staged (4, ...), each rank its stage's chunk, the rest once), a fresh
   pipelined Trainer restores it and both take a step, bitwise alike;
   rank 0 restores the staged arrays into a dense model
   (``from_stage_params``) whose loss on that step's batch must be the
   pipeline's within 1e-3.

18. mesh   — the flagship at 2 layers (phase 8's depth) sharded by
   ``LLAMA_RULES`` over a (data 1, fsdp 2, model 2) mesh of four ranks
   on the card, over ``LOCAL_GLOO`` (gloo's own CUDA path crashes under
   DTensor's functional collectives): B 2 x S 2048, Adam
   1e-4, Zipf batches. Three sharded steps, each loss within 1e-3
   relative of a dense Trainer's on rank 0; the step's collectives by
   kind, device and bytes (the group's own count), every one on CUDA
   tensors; all-reduces of an int64 and an fp64 sum past fp32's
   precision, a bf16 sum and an fp32 maximum, each exact; a sharded snapshot (one manifest, ``named`` descriptors,
   every array covered exactly once by its chunks, the bytes the dense
   state's); two more steps. A fresh launch restores it onto (1,2,2)
   (losses and final shards bitwise the source's), onto (2,1,2) and into
   a dense Trainer (losses within 1e-2), each restored state's every
   leaf bitwise the source's at the cut (a digest of the whole tensor,
   gathered); each kernel launched 4 times a step on every rank.
   ``[mesh]`` lines.
19. ep     — in phase 18's two launches: ``bench.py``'s MoE model (12
   layers, 8 experts top-2 at capacity 1.25, bf16) sharded by
   ``MOE_LLAMA_RULES`` over the same (1,2,2) mesh, expert-parallel (4
   experts and 4 heads a rank) with the whole batch's routing, B 16 x S
   512, Adam 1e-4: three steps within 1e-3 of a dense Trainer's on rank
   0, the dropped share of routed slots, the step's collectives, a
   sharded snapshot restored by the fresh launch onto (1,2,2) (bitwise),
   (2,1,2) and one device (within 1e-2), every restored leaf the
   source's at the cut, each kernel launched 12 times a step on every
   rank. Then the serving grids sharded by ``KV_CACHE_RULES`` (slots over
   fsdp, kv heads over model): phase 6's flagship grid at 2 layers (4
   slots x 4096, temperature 1.0) and phase 14's MoE grid (4 x 1024,
   greedy); each decodes 8 rounds with the single-device engine's tokens
   (rank 0, same process), is snapshotted after round 4, and the fresh
   launch restores it onto (1,2,2) (tokens and the written cache's
   digest bitwise), (1,1,4) and one device (the source's tokens); no
   kernel launches. ``[ep]`` lines.
20. gang_mesh — in phase 18's two launches: the sharded flagship, once
   phase 18's steps are done, trains on behind each rank's
   ``Agentlet(lambda: tr.state)`` (no ``shardings=``: the leaves describe
   themselves) with a slice gate over a file rendezvous and the lockstep
   collective; four port hooks (``TpuDeviceCheckpointHook`` under
   ``GRIT_SLICE_HOSTS=4``) started a step apart cut it into ``host-<k>``
   legs (each rank's own shards as process k of 4, through the
   speculative pass): one step in every leg, every rank parked there.
   The sources resume to cut + 3; the fresh launch restores each rank's
   leg onto (1,2,2) with ``GRIT_RESTORE_POSTCOPY=1`` (losses and final
   shards bitwise the source's) and the legs' merged view
   (``merge_legs``) onto (2,1,2) (within 1e-2); each serving grid of
   phase 19 is restored onto (1,2,2) by post-copy too (the source's
   slots parked until the cache lands), its tokens and written cache
   bitwise the blocking restore's. The pipe axis runs in phase 17's
   restore launch. Gang blackout, each leg's dump, hot-set and tail
   seconds, launches: ``[gang_mesh]`` lines.

21. mesh8 — one launch of eight ranks sharing the card over
   ``LOCAL_GLOO``: ``dryrun_multichip(8)``'s three phases
   (``grit_tpu_torch.entry``: the tiny llama's (2,2,2) step against dense
   in bf16 and f32, the dp × pp × ep MoE step on (data 2, pipe 2,
   expert 2) against the same stages in sequence, the ring and Ulysses
   forwards over the eight ranks), then the flagship at 2 layers on
   (2,2,2), B 4 x S 2048: two steps within 1e-3 of dense (rank 0), its
   sharded snapshot restored in the same launch onto (2,2,2) bitwise;
   each kernel launched 2 times a step on every rank; then ``entry()``
   in this process on the card, its logits finite. ``[mesh8]`` lines.

The second-to-last lines are the script's wall time, the kernels' JSON
record (with the serving phase's numbers under ``serving``, phase 8's
under ``precopy``, phase 9's under ``frozen_trunk``, phase 10's under
``wire``, phase 7's crc32c and codec rates under ``io``, phases 11-13's
under ``lora_7b``, ``remat`` and ``moe``, and phases 14-16's under
``moe_serving``, ``long_context`` and ``pipeline``, phase 17's under
``gang`` (phase 20's pipe axis under ``gang.pipe``), phase 18's under
``mesh``, phase 19's under ``ep`` (phase 20's grids under
``ep.grids.*.postcopy``), phase 20's under ``gang_mesh``, phase 21's
under ``mesh8``; each kernel's ``launches`` sums phases 4, 9, 10, 11, 12,
13, 15, 16, 17, 18, 19, 20 and 21, every rank's)
and the card's ``name, power limit``; the last line is the result JSON.
``--seed`` seeds the serving phases' and the parallel phases' weights
and prompts (default 0). The script imports nothing of JAX or of the
JAX package.
"""

from __future__ import annotations

import contextlib
import hashlib
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


_T0 = time.perf_counter()


def log(phase: str, msg: str) -> None:
    """One line of ``phase``, stamped with the seconds since the script
    started."""
    print(f"[{phase}] +{time.perf_counter() - _T0:.0f}s {msg}", flush=True)


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
        text = (build.build_dir() / f"{stem}.ptxas.log").read_text()
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


def timed_steps(torch, fa, tr) -> tuple[list[float], list[float], dict]:
    """Losses, seconds and kernel launches of :data:`TRAIN_STEPS` steps of
    ``tr``, each step timed on the host clock up to its loss's readback
    (which waits for the step's device work)."""
    tr.state  # materialize outside the timed steps
    torch.cuda.synchronize()
    fa.reset_launch_counts()
    losses, step_s = [], []
    for _ in range(TRAIN_STEPS):
        t0 = time.perf_counter()
        loss = float(tr.train_step()["loss"])  # float() syncs the step
        step_s.append(time.perf_counter() - t0)
        losses.append(loss)
    return losses, step_s, dict(fa.LAUNCHES)


def median_after_first(step_s: list[float]) -> float:
    return sorted(step_s[1:])[len(step_s[1:]) // 2]


def phase_train(torch, fa) -> dict:
    from grit_tpu_torch.models import llama  # noqa: PLC0415
    from grit_tpu_torch.train import optim  # noqa: PLC0415
    from grit_tpu_torch.workload import FROZEN_TRUNK_LR, llama_trainer  # noqa: PLC0415

    check_step_against_plain_path(torch, llama)
    torch.cuda.empty_cache()
    cfg = llama.LlamaConfig.flagship(n_layers=LAYERS)
    tr = llama_trainer(cfg, batch=BATCH, seq=SEQ, device="cuda")
    n_params = sum(p.numel() for p in _leaves(tr.state["params"]))
    torch.cuda.reset_peak_memory_stats()
    losses, step_s, launches = timed_steps(torch, fa, tr)
    peak = torch.cuda.max_memory_allocated()
    steady = median_after_first(step_s)
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

    # Phase 9's fine-tune, timed as the Adam steps above were.
    tr = llama_trainer(cfg, batch=BATCH, seq=SEQ, device="cuda",
                       optimizer=optim.frozen_trunk(FROZEN_TRUNK_LR))
    f_losses, f_step_s, f_launches = timed_steps(torch, fa, tr)
    f_steady = median_after_first(f_step_s)
    log("train", f"frozen-trunk (sgd {FROZEN_TRUNK_LR} on final_norm and "
                 f"lm_head): losses {f_losses}; step seconds "
                 f"{[round(s, 4) for s in f_step_s]}; median after the first "
                 f"{f_steady:.4f} s (Adam {steady:.4f} s); launches "
                 f"{f_launches}")
    if not all(math.isfinite(x) for x in f_losses):
        raise AssertionError(f"non-finite frozen-trunk loss: {f_losses}")
    if f_launches != {"flash_fwd": LAYERS * TRAIN_STEPS, "flash_bwd_dq": 0,
                      "flash_bwd_dkv": 0}:
        raise AssertionError(f"frozen-trunk launches {f_launches}")
    del tr
    torch.cuda.empty_cache()
    return {"launches": launches, "losses": losses, "step_s": steady,
            "frozen_step_s": f_steady, "frozen_launches": f_launches}


def _leaves(tree):
    from grit_tpu_torch.tree import flatten_with_names  # noqa: PLC0415

    return [x for _, x in flatten_with_names(tree)]


# -- phase 5 -------------------------------------------------------------------


# The flagship workload of phases 5 and 8 (a rehearsal on the CPU sets
# ["--config", "tiny", "--device", "cpu", "--seq", "128"]).
WORKLOAD_ARGS = ["--layers", str(LAYERS), "--seq", str(SEQ),
                 "--batch", str(BATCH)]


class Workload:
    """One ``python -m grit_tpu_torch.workload`` process (``args``: its
    arguments, by default :data:`WORKLOAD_ARGS`), its stdout read line by
    line; ``started`` is the host clock at the spawn."""

    def __init__(self, n_steps: int, env: dict,
                 stderr_path: str | None = None,
                 args: list[str] | None = None) -> None:
        stderr = open(stderr_path, "w") if stderr_path else None
        try:
            self.proc = subprocess.Popen(
                [sys.executable, "-m", "grit_tpu_torch.workload",
                 *(WORKLOAD_ARGS if args is None else args)],
                cwd=REPO, env={**os.environ, **env, "N_STEPS": str(n_steps)},
                stdout=subprocess.PIPE, stderr=stderr, text=True)
        finally:
            if stderr is not None:
                stderr.close()
        self.started = time.perf_counter()
        self.args = WORKLOAD_ARGS if args is None else args
        self.lines: list[str] = []
        self.times: list[float] = []  # host clock at each line's arrival
        self._drain = None

    def readline(self) -> str:
        line = self.proc.stdout.readline()
        if not line:
            rc = self.proc.wait()
            raise RuntimeError(f"workload exited (rc {rc}) after "
                               f"{self.lines[-5:]}")
        line = line.strip()
        self.times.append(time.perf_counter())
        self.lines.append(line)
        return line

    def drain(self) -> None:
        """Read the rest of stdout on a thread: a fast loop would otherwise
        fill the pipe and block in a print, short of its checkpoint point."""
        import threading  # noqa: PLC0415

        def run():
            for line in self.proc.stdout:
                self.lines.append(line.strip())

        self._drain = threading.Thread(target=run, daemon=True)
        self._drain.start()

    def find(self, pattern: str) -> re.Match | None:
        """The first line already read that matches ``pattern``."""
        for line in self.lines:
            m = re.match(pattern, line)
            if m:
                return m
        return None

    def arrival(self, pattern: str) -> float:
        """The host clock at the arrival of the first line already read
        that matches ``pattern``."""
        return next(t for line, t in zip(self.lines, self.times)
                    if re.match(pattern, line))

    def kernels(self) -> dict:
        """The ``KERNELS`` line: launches, libraries built and loaded."""
        line = next(x for x in self.lines if x.startswith("KERNELS "))
        return json.loads(line.split(" ", 1)[1])

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


def fmt_legs(legs: dict, keys: tuple[str, ...]) -> str:
    return ", ".join(f"{k} {legs[k]:.3f}" for k in keys)


DUMP_LEGS = ("copy_wait", "crc", "sha256", "compare", "write", "tee", "wall")
RESTORE_LEGS = ("pin", "stage_wait", "read", "place", "wall")


def start_beside_reference(n_steps: int, env: dict, socks: str,
                           procs: list, args: list[str] | None = None,
                           src_env: dict | None = None):
    """The uninterrupted reference run of ``n_steps`` and a source of the
    same workload started together, so that their process starts overlap;
    the source parks at its first checkpoint point until the reference
    has finished, then resumes. Nothing here is timed, and once the
    reference is done the source has the card to itself. ``src_env``: the
    source's environment where it differs from the reference's. Returns
    the finished reference, the source and its ``ToggleClient``."""
    from grit_tpu_torch.device.agentlet import ToggleClient  # noqa: PLC0415

    ref = Workload(n_steps, env, args=args)
    procs.append(ref)
    src = Workload(1000, env if src_env is None else src_env, args=args)
    procs.append(src)
    src.wait_for("READY")
    client = ToggleClient(
        src.proc.pid, path=os.path.join(socks, f"grit-tpu-{src.proc.pid}.sock"))
    client.quiesce()
    ref.finish()
    client.resume()
    return ref, src, client


# The source's armed fault: its first dump request must fail, and the
# retry commit.
MIGRATE_FAULT = "device.agentlet.dump:raise:x1"


def free_ports(n: int) -> list[int]:
    """``n`` distinct free ports (held open together while they are
    picked, so the kernel cannot hand out one twice)."""
    import socket  # noqa: PLC0415

    socks = [socket.socket() for _ in range(n)]
    try:
        for s in socks:
            s.bind(("127.0.0.1", 0))
        return [s.getsockname()[1] for s in socks]
    finally:
        for s in socks:
            s.close()


def free_port() -> int:
    return free_ports(1)[0]


def scrape_metric(port: int, line_prefix: str) -> float:
    """The value of the first ``/metrics`` sample line on ``port`` that
    starts with ``line_prefix``."""
    import urllib.request  # noqa: PLC0415

    with urllib.request.urlopen(f"http://127.0.0.1:{port}/metrics",
                                timeout=30) as resp:
        text = resp.read().decode()
    for line in text.splitlines():
        if line.startswith(line_prefix + " "):
            return float(line.rsplit(" ", 1)[1])
    raise AssertionError(f"/metrics on port {port} has no {line_prefix!r}")


def flight_checks(events: list[dict], src_pid: int, dst_pid: int,
                  nbytes: int, kill_wall: float) -> dict:
    """The migration's flight log holds the source's dump bracket with its
    chunks, ``dump.end``'s bytes the snapshot's, and the destination's
    ``restart.start`` (after the kill at ``kill_wall``), ``restart.end``
    and place bracket, each once from the right pid and in wall-clock
    order. Returns those events by name."""
    def one(ev: str, pid: int) -> dict:
        got = [e for e in events if e["ev"] == ev and e["pid"] == pid]
        if len(got) != 1:
            raise AssertionError(f"flight log: {len(got)} {ev} from pid "
                                 f"{pid}, want 1")
        return got[0]

    ev = {"dump.start": one("dump.start", src_pid),
          "dump.end": one("dump.end", src_pid),
          "restart.start": one("restart.start", dst_pid),
          "restart.end": one("restart.end", dst_pid),
          "place.start": one("place.start", dst_pid),
          "place.end": one("place.end", dst_pid)}
    chunks = [e for e in events if e["ev"] == "dump.chunk"
              and e["pid"] == src_pid]
    if not chunks:
        raise AssertionError("flight log: no dump.chunk from the source")
    if ev["dump.end"].get("bytes") != nbytes or \
            chunks[-1]["bytes"] != nbytes:
        raise AssertionError(f"flight log: dump.end bytes "
                             f"{ev['dump.end'].get('bytes')}, last chunk "
                             f"{chunks[-1]['bytes']}, snapshot {nbytes}")
    order = ([ev["dump.start"]] + chunks
             + [ev[k] for k in ("dump.end", "restart.start", "restart.end",
                                "place.start", "place.end")])
    if ev["restart.start"]["wall"] <= kill_wall:
        raise AssertionError("flight log: restart.start before the kill")
    walls = [e["wall"] for e in order]
    if walls != sorted(walls):
        raise AssertionError("flight log: events out of wall-clock order: "
                             f"{[(e['ev'], e['wall']) for e in order]}")
    if not (ev["place.end"].get("ok") and ev["dump.end"].get("ok", True)):
        raise AssertionError("flight log: a bracket closed with ok=false")
    ev["chunks"] = len(chunks)
    return ev


def trace_checks(spans: list[dict]) -> dict:
    """The trace sink holds the dump's and the restore's spans, and every
    span's parent is in it."""
    names = {x["name"] for x in spans}
    for want in ("snapshot.write", "snapshot.restore"):
        if want not in names:
            raise AssertionError(f"trace: no {want} span in {sorted(names)}")
    ids = {x["spanId"] for x in spans}
    orphans = [x["name"] for x in spans
               if x["parentSpanId"] and x["parentSpanId"] not in ids]
    if orphans:
        raise AssertionError(f"trace: orphan spans {orphans}")
    return {"spans": len(spans), "names": sorted(names)}


def read_folded(path: str) -> dict:
    """A phase profiler's folded file: its ``# grit-prof`` header and its
    ``category;frame;... count`` lines. Fails on a file with no stack or
    a stack whose first segment is not a category. Returns the samples
    by category and the header's ticks."""
    from grit_tpu_torch.obs.profile import CATEGORIES  # noqa: PLC0415

    with open(path, encoding="utf-8") as f:
        lines = f.read().splitlines()
    if not lines or not lines[0].startswith("# grit-prof "):
        raise AssertionError(f"{path}: no '# grit-prof' header")
    header = json.loads(lines[0][len("# grit-prof "):])
    by_cat: dict[str, int] = {}
    for line in lines[1:]:
        body, _, count = line.rpartition(" ")
        cat = body.split(";", 1)[0]
        if cat not in CATEGORIES:
            raise AssertionError(f"{path}: stack under {cat!r}, not a "
                                 f"category of {CATEGORIES}")
        by_cat[cat] = by_cat.get(cat, 0) + int(count)
    if not by_cat:
        raise AssertionError(f"{path}: no stack ({header})")
    return {"samples": by_cat, "ticks": header["ticks"]}


def scrape_destination(port: int, nbytes: int, timeout: float = 10.0) -> dict:
    """Poll the restored process's ``/metrics`` (bounded by ``timeout``)
    until its place progress reads the snapshot's bytes, shipped and
    total, and its profiler has ticked; then ``/debug/threadz`` and
    ``/version`` must answer. Returns what it read."""
    import urllib.request  # noqa: PLC0415

    def get(path: str) -> tuple[int, str]:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                    timeout=5) as resp:
            return resp.status, resp.read().decode()

    deadline = time.perf_counter() + timeout
    seen = None
    while True:
        try:
            vals = {}
            for line in get("/metrics")[1].splitlines():
                if line and not line.startswith("#"):
                    key, _, value = line.rpartition(" ")
                    vals[key] = float(value)
            seen = {
                "shipped": vals.get('grit_progress_bytes_shipped{role="workload"}'),
                "total": vals.get('grit_progress_total_bytes{role="workload"}'),
                "prof_ticks": sum(v for k, v in vals.items() if k.startswith(
                    "grit_prof_sample_ticks_total{"))}
            if seen["shipped"] == seen["total"] == nbytes \
                    and seen["prof_ticks"] > 0:
                break
        except OSError as exc:
            seen = repr(exc)
        if time.perf_counter() > deadline:
            raise AssertionError(f"destination /metrics after {timeout} s: "
                                 f"{seen}, snapshot {nbytes} bytes")
        time.sleep(0.05)
    threadz, threads = get("/debug/threadz")
    version, stamp = get("/version")
    if (threadz, version) != (200, 200) or "--- thread" not in threads \
            or not stamp.startswith("grit-tpu "):
        raise AssertionError(f"destination /debug/threadz {threadz}, "
                             f"/version {version}")
    return {**seen, "version": stamp.strip()}


def phase_migrate(work: str, card: str) -> dict:
    """Returns the uninterrupted run's losses (``ref_losses``) beside the
    migration's numbers and its ``obs`` record; the snapshot is removed.

    The script plays the node: it configures the migration's flight log
    in ``ckpt`` (role ``node``) and brackets the quiesce and each dump
    request there, as the agent's hook does. The source runs with the
    flight recorder, a trace sink, its ``/metrics`` server and an armed
    fault (:data:`MIGRATE_FAULT`); the destination with the recorder, the
    sink and its ``/metrics`` server with a short sampler period, which
    its prefetch starts before ``import torch``; the uninterrupted run
    with none of them. No process is started for the new checks."""
    from concurrent.futures import ThreadPoolExecutor  # noqa: PLC0415
    from unittest import mock  # noqa: PLC0415

    from grit_tpu_torch.device.snapshot import snapshot_nbytes  # noqa: PLC0415
    from grit_tpu_torch.obs import flight, trace  # noqa: PLC0415

    socks = os.path.join(work, "socks")
    ckpt = os.path.join(work, "ckpt")
    snap = os.path.join(ckpt, "hbm")
    trace_file = os.path.join(work, "trace.jsonl")
    os.makedirs(socks)
    env = {"GRIT_TPU_SOCKET_DIR": socks}
    obs_env = {"GRIT_FLIGHT": "1", "GRIT_TPU_TRACE_FILE": trace_file}
    port, dst_port = free_ports(2)
    src_env = {**env, **obs_env, "GRIT_WORKLOAD_METRICS_PORT": str(port),
               "GRIT_FAULT_POINTS": MIGRATE_FAULT}
    wall_of = time.time() - time.perf_counter()  # host clock → wall clock

    def node(ev: str, **fields) -> None:
        # Only the script's own calls see GRIT_FLIGHT: the processes it
        # starts get their environment from their own dicts.
        with mock.patch.dict(os.environ, {"GRIT_FLIGHT": "1"}):
            if ev == "configure":
                flight.configure(ckpt, "node")
            else:
                flight.emit(ev, **fields)

    procs: list[Workload] = []
    try:
        node("configure")
        log_path = flight.current().path
        ref, src, client = start_beside_reference(
            MIGRATE_STEPS, env, socks, procs, src_env=src_env)
        ref_losses = ref.losses()
        pid = src.proc.pid
        src.wait_for(rf"STEP {MIGRATE_CUT} ")
        t_quiesce = time.perf_counter()
        node("quiesce.start", dir=ckpt, workload_pid=pid)
        cut = client.quiesce()
        node("quiesce.end", dir=ckpt, workload_pid=pid, ok=True)
        # The armed fault fails the first request; the agentlet must
        # answer after it and the retry must commit.
        node("dump.start", dir=ckpt, workload_pid=pid)
        t_fail = time.perf_counter()
        try:
            client.dump(snap)
            raise AssertionError(f"{MIGRATE_FAULT} did not fire")
        except RuntimeError as exc:
            if "injected fault at device.agentlet.dump" not in str(exc):
                raise
            fault_error = str(exc)
        node("dump.end", dir=ckpt, workload_pid=pid, ok=False)
        failed_s = time.perf_counter() - t_fail
        status = client.status()
        if not (status["ok"] and status["paused"]):
            raise AssertionError(f"agentlet after the fault: {status}")
        node("dump.start", dir=ckpt, workload_pid=pid)
        t_dump = time.perf_counter()
        dump_legs = client.dump(snap)["legs"]
        t_dumped = time.perf_counter()
        node("dump.end", dir=ckpt, workload_pid=pid, ok=True)
        nbytes = snapshot_nbytes(snap)
        scraped = scrape_metric(port,
                                'grit_snapshot_bytes_total{op="write"}')
        if scraped != nbytes:
            raise AssertionError(f"/metrics snapshot bytes {scraped}, "
                                 f"snapshot {nbytes}")
        client.close()
        src.kill()
        t_kill = time.perf_counter()

        dst = Workload(MIGRATE_STEPS,
                       {**env, **obs_env, "GRIT_TPU_RESTORE_DIR": snap,
                        "GRIT_WORKLOAD_METRICS_PORT": str(dst_port),
                        "GRIT_OBS_SAMPLE_S": "0.1"})
        procs.append(dst)
        restored = int(dst.wait_for(r"RESTORED (\d+)").group(1))
        t_restored = time.perf_counter()
        # Scraped from a thread while the destination trains on, so the
        # host clock's reading of its first step is not held up.
        scraper = ThreadPoolExecutor(1)
        scraping = scraper.submit(scrape_destination, dst_port, nbytes)
        restore_s = float(dst.wait_for(r"RESTORE_SECONDS (\S+)").group(1))
        pipe = json.loads(dst.wait_for(r"RESTORE_PIPELINE (.+)").group(1))
        init_s = float(dst.wait_for(r"INIT_SECONDS (\S+)").group(1))
        dst.wait_for("READY")
        t_ready = time.perf_counter()
        dst.wait_for(r"STEP \d+ ")
        t_first = time.perf_counter()
        dst.finish()
        scraped_dst = scraping.result()
        scraper.shutdown()
        events = flight.read_flight_file(log_path)
        spans = trace.read_trace_file(trace_file)
        profiled = {
            phase: read_folded(os.path.join(
                ckpt, f".grit-prof-{phase}-p{p.proc.pid}.folded"))
            for phase, p in (("dump", src), ("place", dst))}
    finally:
        flight.reset()
        trace.close_export()
        for p in procs:
            p.kill()
        shutil.rmtree(ckpt, ignore_errors=True)
    got = dst.losses()
    if restored != cut:
        raise AssertionError(f"restored step {restored}, quiesced at {cut}")
    want = {s: x for s, x in ref_losses.items() if s > cut}
    if got != want or len(want) != MIGRATE_STEPS - cut:
        raise AssertionError(f"losses after the cut differ from the "
                             f"uninterrupted run: {got} vs {want}")
    fl = flight_checks(events, pid, dst.proc.pid, nbytes, wall_of + t_kill)
    tr = trace_checks(spans)
    node = [e for e in events if e["pid"] == os.getpid()]
    q0 = next(e["wall"] for e in node if e["ev"] == "quiesce.start")
    q1 = next(e["wall"] for e in node if e["ev"] == "quiesce.end")
    d0 = next(e["wall"] for e in node if e["ev"] == "dump.start")
    d1 = [e["wall"] for e in node if e["ev"] == "dump.end"][-1]
    kill, first = wall_of + t_kill, wall_of + t_first
    obs = {"card": card,
           "blackout_s": t_first - t_quiesce,
           "quiesce_s": q1 - q0,
           "dump_s": d1 - d0,
           "failed_request_s": failed_s,
           "source_dump_s": fl["dump.end"]["wall"] - fl["dump.start"]["wall"],
           "dump_to_kill_s": kill - d1,
           "kill_to_place_s": fl["place.start"]["wall"] - kill,
           "kill_to_restart_s": fl["restart.start"]["wall"] - kill,
           "restart_to_place_s": (fl["place.start"]["wall"]
                                  - fl["restart.start"]["wall"]),
           "place_s": fl["place.end"]["wall"] - fl["place.start"]["wall"],
           "rest_s": first - fl["place.end"]["wall"],
           "flight_events": len(events), "dump_chunks": fl["chunks"],
           "trace_spans": tr["spans"], "metrics_snapshot_bytes": scraped,
           "fault": MIGRATE_FAULT, "destination_metrics": scraped_dst,
           "profile": profiled}
    if abs(obs["kill_to_restart_s"] + obs["restart_to_place_s"]
           - obs["kill_to_place_s"]) > 1e-3:
        raise AssertionError(f"kill → restart.start → place.start does not "
                             f"sum to kill → place.start: {obs}")
    obs["flight_sum_s"] = (obs["quiesce_s"] + (d0 - q1) + obs["dump_s"]
                           + obs["dump_to_kill_s"] + obs["kill_to_place_s"]
                           + obs["place_s"] + obs["rest_s"])
    quiesce_s, dump_s = t_fail - t_quiesce, t_dumped - t_dump
    log("migrate", f"cut at step {cut}; losses after the cut bitwise equal "
                   f"to the uninterrupted run: {got}")
    log("migrate", f"armed {MIGRATE_FAULT}: the first dump failed in "
                   f"{failed_s:.4f} s ({fault_error}); status answered; the "
                   f"retry committed")
    log("migrate", f"snapshot {nbytes} bytes; quiesce {quiesce_s:.4f} s; "
                   f"dump {dump_s:.3f} s = {nbytes / dump_s / 1e9:.3f} GB/s; "
                   f"restore {restore_s:.3f} s = "
                   f"{nbytes / restore_s / 1e9:.3f} GB/s; blackout (quiesce → "
                   f"first post-restore step, the failed request included) "
                   f"{t_first - t_quiesce:.3f} s [{card}]")
    log("migrate", f"data path: dump through {dump_legs['staging']}, "
                   f"seconds {fmt_legs(dump_legs, DUMP_LEGS)}; restore "
                   f"through {pipe['staging']} with {pipe['workers']} "
                   f"readers, seconds {fmt_legs(pipe, RESTORE_LEGS)}, "
                   f"overlap fraction {pipe['overlap_fraction']:.3f} [{card}]")
    log("migrate", f"restart: kill + spawn {dst.started - t_kill:.3f} s; "
                   f"spawn → RESTORED {t_restored - dst.started:.3f} s = "
                   f"interpreter and imports "
                   f"{t_restored - dst.started - init_s - restore_s:.3f} s + "
                   f"set-up {init_s:.3f} s + restore "
                   f"{restore_s:.3f} s; RESTORED → READY "
                   f"{t_ready - t_restored:.3f} s; READY → first step "
                   f"{t_first - t_ready:.3f} s")
    log("migrate", f"flight log: {len(events)} events, the source's dump "
                   f"bracket with {fl['chunks']} chunks and "
                   f"{fl['dump.end']['bytes']} bytes, the destination's "
                   f"restart.start, restart.end and place bracket, in "
                   f"wall-clock order; "
                   f"trace: {tr['spans']} spans {tr['names']}, no orphan; "
                   f"/metrics snapshot bytes {scraped:.0f} = the snapshot's")
    log("migrate", "blackout by the flight log: " + ", ".join(
        f"{k} {obs[k]:.3f}" for k in ("quiesce_s", "dump_s",
                                      "failed_request_s", "source_dump_s",
                                      "dump_to_kill_s", "kill_to_place_s",
                                      "kill_to_restart_s",
                                      "restart_to_place_s", "place_s",
                                      "rest_s", "flight_sum_s",
                                      "blackout_s")) + f" s [{card}]")
    log("migrate", "phase profiler samples by category: " + "; ".join(
        f"{phase} ({profiled[phase]['ticks']} ticks) " + ", ".join(
            f"{c} {n}" for c, n in sorted(profiled[phase]["samples"].items()))
        for phase in ("dump", "place")) + f"; destination /metrics: place "
        f"progress {scraped_dst['shipped']:.0f} of "
        f"{scraped_dst['total']:.0f} bytes, profiler ticks "
        f"{scraped_dst['prof_ticks']:.0f}, /debug/threadz and /version "
        f"({scraped_dst['version']}) answered [{card}]")
    return {"cut": cut, "bytes": nbytes, "ref_losses": ref_losses,
            "dump_s": dump_s, "restore_s": restore_s,
            "dump_legs": dump_legs, "restore_legs": pipe,
            "blackout_s": t_first - t_quiesce, "obs": obs}


# -- phase 6 -------------------------------------------------------------------

SERVE_SLOTS = 4
SERVE_MAX_LEN = 4096
SERVE_PROMPTS = (1000, 700, 230, 40)  # the 1024, 1024, 256 and 64 buckets
SERVE_SWAP = (12, 3, 500)  # after round 12, slot 3 leaves; 500 tokens join
SERVE_CUT = 24             # rounds before the migration
SERVE_AFTER = 32           # rounds the restored engine decodes
LOCKSTEP = (2, 512, 16)    # batch, prompt tokens, tokens generated
PROFILE_ROUNDS = 4
FANOUT_CLONES = 2          # post-copy clones of the source's snapshot
FANOUT_FREE = 2            # the source's slot whose request completes first
FANOUT_PROMPT = 40         # tokens of the request each clone serves first
FANOUT_ROUNDS = 8          # tokens of every stream compared after the absorb


def zipf_tokens(torch, n: int, vocab: int, gen) -> "torch.Tensor":
    """``n`` token ids drawn from a Zipf law over the vocabulary (as the
    training workload draws its batches)."""
    zipf = 1.0 / torch.arange(1, vocab + 1, dtype=torch.float64)
    return torch.multinomial(zipf, n, replacement=True,
                             generator=gen).to(torch.int32)


class ServingTraffic:
    """The serving phase's request schedule, the same for every engine
    that runs it: four prompts of ``prompts[:4]`` tokens admitted before
    round 1 and, after round ``swap[0]``, the release of slot ``swap[1]``
    and the admission of a prompt of ``swap[2]`` tokens into it. Every
    event falls before the migration's cut, so the restored engine only
    decodes."""

    def __init__(self, torch, vocab: int, seed: int, sync,
                 buckets: tuple[int, ...], prompts: tuple[int, ...],
                 swap: tuple[int, int, int]) -> None:
        gen = torch.Generator().manual_seed(seed)
        self.prompts = [zipf_tokens(torch, n, vocab, gen)
                        for n in (*prompts, swap[2])]
        self.swap = swap
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
        if r == self.swap[0]:
            release(slots[self.swap[1]])
            slot = self._admit(submit, self.prompts[4], times)
            if slot != slots[self.swap[1]]:
                raise AssertionError(f"the freed slot {slots[self.swap[1]]} "
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


def profile_ops(torch, fn, rounds: int) -> dict:
    """Device time by operator over ``rounds`` calls of ``fn``
    (torch.profiler): each operator's kernels' time a call, their sum
    (the device's busy time), and the wall time of the profiled calls."""
    from torch.autograd import DeviceType  # noqa: PLC0415
    from torch.profiler import ProfilerActivity, profile  # noqa: PLC0415

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(rounds):
            fn()
        torch.cuda.synchronize()
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


def serving_fanout(torch, serving, src, cfg, bcfg, dev, work: str,
                   sync) -> dict:
    """The snapshot fan-out: ``src`` (the migration's source, parked at the
    cut with every slot in flight) completes one request (slot
    ``FANOUT_FREE`` is released), is snapshotted, admits a new request into
    the freed slot and decodes ``FANOUT_ROUNDS`` rounds. Two clone engines
    restore that snapshot by post-copy (``fan_out_clones``), each serves
    the same request on the free slot while its KV tail lands, absorbs
    the restored streams, and decodes: every stream's tokens must equal
    the source's. The clones are freed before this returns."""
    from grit_tpu_torch.api import config  # noqa: PLC0415
    from grit_tpu_torch.device.snapshot import SnapshotManifest  # noqa: PLC0415
    from grit_tpu_torch.serving import fan_out_clones  # noqa: PLC0415

    src.release(FANOUT_FREE)
    fan_snap = os.path.join(work, "fanout-snap")
    src.snapshot(fan_snap)
    prompt = zipf_tokens(torch, FANOUT_PROMPT, cfg.vocab_size,
                         torch.Generator().manual_seed(FANOUT_PROMPT))
    new = src.submit(prompt)
    if new != FANOUT_FREE:
        raise AssertionError(f"the new request took slot {new}")
    want: dict = {s: [] for s in range(SERVE_SLOTS)}
    for _ in range(FANOUT_ROUNDS):
        for s, tok in src.step().items():
            want[s].append(tok)
    sizes = [sum(c["nbytes"] for c in rec["chunks"])
             for rec in SnapshotManifest.load(fan_snap).arrays]
    hot_cut = config.RESTORE_POSTCOPY_HOT_MB.get_float() * 1e6
    cold = [n for n in sizes if n > hot_cut]
    clones = [serving.ContinuousBatchingEngine(cfg, src.params, bcfg,
                                               device=dev)
              for _ in range(FANOUT_CLONES)]
    legs = fan_out_clones(fan_snap, clones)
    out = []
    try:
        firsts = []
        for leg in legs:
            if leg.error is not None:
                raise RuntimeError(f"clone {leg.ordinal} failed to restore: "
                                   f"{leg.error!r}")
            free = leg.engine.free_slots()
            if free != [FANOUT_FREE]:
                raise AssertionError(f"clone {leg.ordinal}: free slots {free} "
                                     f"while the tail lands, want "
                                     f"[{FANOUT_FREE}]")
            firsts.append(leg.serve_first(prompt))
            sync()
            if not leg.served_before_tail:
                raise AssertionError(f"clone {leg.ordinal}: its first token "
                                     "came after the KV tail had landed")
        for leg, first in zip(legs, firsts):
            leg.finish()
            got: dict = {s: [] for s in range(SERVE_SLOTS)}
            got[FANOUT_FREE].append(first)
            while min(len(v) for v in got.values()) < FANOUT_ROUNDS:
                for s, tok in leg.engine.step().items():
                    got[s].append(tok)
            got = {s: v[:FANOUT_ROUNDS] for s, v in got.items()}
            if got != want:
                raise AssertionError(f"clone {leg.ordinal} diverged from the "
                                     f"source: {got} vs {want}")
            out.append({"ordinal": leg.ordinal,
                        "hot_placed_s": leg.hot_placed_s,
                        "first_token_s": leg.first_token_s,
                        "tail_s": leg.handle.tail_s,
                        "served_before_tail": leg.served_before_tail})
    finally:
        leg = None
        del clones, legs, leg
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        shutil.rmtree(fan_snap, ignore_errors=True)
    return {"legs": out, "cold_bytes": sum(cold),
            "hot_bytes": sum(sizes) - sum(cold)}


def phase_serving(torch, fa, work: str, card: str, *, seed: int,
                  cfg=None, device: str = "cuda", label: str = "serve",
                  max_len: int = SERVE_MAX_LEN,
                  prompts: tuple[int, ...] = SERVE_PROMPTS,
                  swap: tuple[int, int, int] = SERVE_SWAP,
                  fanout: bool = True) -> dict:
    """The serving path: a continuous-batching engine at the flagship
    widths (phase 14 passes the MoE model's ``cfg``, ``max_len``,
    ``prompts`` and ``swap``, and logs as ``label``; ``device`` other than
    the card only to rehearse the phase at a small size on the CPU) of
    ``max_len`` positions a slot serves four requests
    and a fifth in a reused slot, is quiesced and dumped through its
    serving agentlet after ``SERVE_CUT`` rounds, and a second engine built
    from the same seed restores the snapshot and decodes ``SERVE_AFTER``
    rounds: its tokens and final state must equal an uninterrupted
    engine's over the same schedule, and a restored state with one slot's
    position one higher must not. Then a lock-step engine snapshots and
    continues in process. With ``fanout`` (phase 6; phase 14 leaves it
    to phase 6) the source's snapshot then fans out into post-copy
    clones."""
    import threading  # noqa: PLC0415

    from grit_tpu_torch.device.agentlet import ToggleClient  # noqa: PLC0415
    from grit_tpu_torch.device.snapshot import snapshot_nbytes  # noqa: PLC0415
    from grit_tpu_torch.models import llama, moe_llama  # noqa: PLC0415
    from grit_tpu_torch.models import serving  # noqa: PLC0415
    from grit_tpu_torch.serving import ServingAgentlet  # noqa: PLC0415

    dev = torch.device(device)
    on_card = dev.type == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    cfg = cfg or llama.LlamaConfig.flagship(n_layers=LAYERS)
    family = moe_llama if isinstance(cfg, moe_llama.MoeLlamaConfig) else llama
    bcfg = serving.BatchingConfig(n_slots=SERVE_SLOTS, max_seq_len=max_len,
                                  temperature=1.0, seed=seed)
    traffic = ServingTraffic(torch, cfg.vocab_size, seed, sync,
                             bcfg.prefill_buckets, prompts, swap)
    total = SERVE_CUT + SERVE_AFTER

    def engine():
        """An engine with its own params from the seed (weights ship with
        the pod image, never with the snapshot)."""
        gen = torch.Generator(device=dev).manual_seed(seed)
        return serving.ContinuousBatchingEngine(
            cfg, family.init_params(cfg, gen, dev), bcfg, device=dev)

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
    expect_zeroed = 1 - live / (SERVE_SLOTS * max_len)
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
    shutil.rmtree(snap)
    shutil.rmtree(lsnap)
    if fanout:
        fanout = serving_fanout(torch, serving, src, cfg, bcfg, dev, work, sync)
    launches = dict(fa.LAUNCHES)
    if any(launches.values()):
        raise AssertionError(f"the serving path launched flash kernels "
                             f"{launches}; its attention is the plain one")

    prof = profile_ops(torch, ref.step, PROFILE_ROUNDS) if on_card else None
    steady = sorted(round_ms[2:])[len(round_ms[2:]) // 2]
    kv_bytes = 2 * ref.state["cache"]["k"].numel() * ref.state["cache"]["k"].element_size()
    quiesce_s, dump_s = t_dump - t_quiesce, t_restore - t_dump
    restore_s = t_restored - t_restore
    log(label, f"{type(cfg).__name__} dim {cfg.dim}, {cfg.n_layers} layers, "
                f"{SERVE_SLOTS} slots x {max_len} positions (KV cache "
                f"{kv_bytes} bytes), buckets {bcfg.prefill_buckets}, "
                f"temperature 1.0; prompts {prompts}, then {swap[2]} tokens "
                f"into slot {swap[1]} after round {swap[0]}")
    log(label, "prefill ms by bucket (source engine; prompts "
                f"{[len(p) for p in traffic.prompts]}): " + "; ".join(
                    f"{b}: {[round(x, 3) for x in ms]}"
                    for b, ms in sorted(prefill_ms.items())) + f" [{card}]")
    log(label, f"decode round ms (uninterrupted run, {total} rounds): "
                f"median after the first two {steady:.3f} = "
                f"{SERVE_SLOTS / steady * 1e3:.1f} tokens/s; first two "
                f"{[round(x, 3) for x in round_ms[:2]]} [{card}]")
    if prof is not None:
        log(label, f"decode round profile ({PROFILE_ROUNDS} rounds under "
                   f"torch.profiler): wall {prof['wall_ms']:.3f} ms a round, "
                   f"device busy {prof['device_ms']:.3f} ms (idle share "
                   f"{1 - prof['device_ms'] / prof['wall_ms']:.3f}; of the "
                   f"unprofiled median round "
                   f"{1 - prof['device_ms'] / steady:.3f}); kernel time by "
                   f"operator, ms a round: " + "; ".join(
                       f"{k} {ms:.3f}" for k, ms in prof["top"]))
    log(label, f"snapshot {nbytes} bytes; KV bytes the tag zeroed "
                f"{zeroed:.4f} (expected from the positions "
                f"{expect_zeroed:.4f}); quiesce {quiesce_s:.4f} s; dump "
                f"{dump_s:.3f} s = {nbytes / dump_s / 1e9:.3f} GB/s; restore "
                f"{restore_s:.3f} s = {nbytes / restore_s / 1e9:.3f} GB/s; "
                f"first token of the restored engine {t_first - t_restored:.3f}"
                f" s; blackout (quiesce → that token) "
                f"{t_first - t_quiesce:.3f} s [{card}]")
    log(label, f"migrated after round {cut}: rounds {SERVE_CUT + 1}.."
                f"{total} bitwise equal to the uninterrupted run, final "
                f"state (positions, RNG words, counts, the KV cache at every "
                f"written position) torch.equal; planted fault (slot {fault_slot} one position "
                f"on) rejected: {planted}")
    log(label, f"lock-step: batch {B}, {S}-token prompt, {n_tok} tokens, "
                f"snapshot after {n_tok // 2}: continues bit-identically; "
                f"flash kernel launches on the serving path {launches}")
    for leg in fanout["legs"] if fanout else ():
        log(label, f"post-copy clone {leg['ordinal']}: hot set placed "
                   f"{leg['hot_placed_s']:.4f} s, first token of a new "
                   f"request {leg['first_token_s']:.4f} s with the KV tail "
                   f"still landing, tail {leg['tail_s']:.3f} s "
                   f"({fanout['cold_bytes']} cold bytes) [{card}]")
    if fanout:
        log(label, f"fan-out of {FANOUT_CLONES} post-copy clones of a "
                   f"snapshot with slot {FANOUT_FREE} free: after "
                   f"absorb_restored every stream's next {FANOUT_ROUNDS} "
                   f"tokens (the migrated ones and the request each clone "
                   f"served on the free slot) bitwise equal to the source's;"
                   f" hot set {fanout['hot_bytes']} bytes")
    return {"flash_launches": launches, "fanout": fanout, "decode_round_ms": steady,
            "tokens_per_s": SERVE_SLOTS / steady * 1e3,
            "prefill_ms": {str(b): ms for b, ms in prefill_ms.items()},
            "snapshot_bytes": nbytes, "kv_zeroed_fraction": zeroed,
            "quiesce_s": quiesce_s, "dump_s": dump_s, "restore_s": restore_s,
            "blackout_s": t_first - t_quiesce,
            "device_busy_ms": None if prof is None else prof["device_ms"]}


def phase_io(torch, work: str, card: str) -> dict:
    """Rates of the stages the dump and restore are made of, on a buffer
    the size of the flagship's largest leaf (the stacked MLP weights),
    fastest of three calls after a warm-up: device-host copies (pageable
    and pinned; the snapshot stages through pinned buffers), ``zlib.crc32``
    and ``hashlib.sha256`` (the chunk checksum and the pre-copy chunk
    identity), and file write and read through the page cache beside the
    snapshot; then the crc32c library and the codec's zlib
    (:func:`io_codec_and_crc32c`, whose numbers it returns)."""
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
        ("hashlib.sha256", lambda: hashlib.sha256(host).digest()),
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
    return io_codec_and_crc32c(host, card)


# RFC 3720 section B.4, and the usual check value of "123456789".
CRC32C_VECTORS = ((bytes(32), 0x8A9136AA), (b"\xff" * 32, 0x62A8AB43),
                  (bytes(range(32)), 0x46DD794E),
                  (bytes(range(31, -1, -1)), 0x113FDB5C),
                  (b"123456789", 0xE3069283))


def io_codec_and_crc32c(host, card: str) -> dict:
    """The port's crc32c library (``grit_tpu_torch/checksum.py``, built here
    with the host compiler) on both of its paths, held to the RFC 3720
    vectors and to its plain version on a few MiB at unaligned lengths,
    then timed against ``zlib.crc32`` on ``host`` (fastest of three after a
    warm-up); zlib level 1 (the codec stage's) compressing and
    decompressing one 64 MiB dump piece of ``host``."""
    from grit_tpu_torch import checksum  # noqa: PLC0415

    t0 = time.perf_counter()
    path = checksum.path()
    build_s = time.perf_counter() - t0
    checked = 0
    for table in (False, True):
        checksum.force_table(table)
        try:
            for data, want in CRC32C_VECTORS:
                if checksum.crc32c(data) != want:
                    raise AssertionError(f"crc32c (table {table}) of "
                                         f"{data[:8]!r}...: not {want:#x}")
            for k, length in enumerate((1, 4095, 1 << 20, (2 << 20) + 7)):
                view = host[k + 1:k + 1 + length]  # unaligned starts
                if checksum.crc32c(view) != checksum.plain_crc32c(view):
                    raise AssertionError(f"crc32c (table {table}) disagrees "
                                         f"with its plain version at length "
                                         f"{length}")
                checked += length
        finally:
            checksum.force_table(False)

    def best_of(fn, reps: int = 3) -> float:
        fn()
        best = float("inf")
        for _ in range(reps):
            t0 = time.perf_counter()
            fn()
            best = min(best, time.perf_counter() - t0)
        return best

    n = host.nbytes
    crc32c_s = best_of(lambda: checksum.crc32c(host))
    checksum.force_table(True)
    try:
        table_s = best_of(lambda: checksum.crc32c(host), reps=1)
    finally:
        checksum.force_table(False)
    crc32_s = best_of(lambda: zlib.crc32(host))
    piece = host[:64 << 20]
    t0 = time.perf_counter()
    packed = zlib.compress(piece, 1)
    compress_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    if zlib.decompress(packed) != piece.tobytes():
        raise AssertionError("zlib round trip changed the piece")
    decompress_s = time.perf_counter() - t0
    out = {"crc32c_path": path, "crc32c_build_s": build_s,
           "crc32c_gbps": n / crc32c_s / 1e9,
           "crc32c_table_gbps": n / table_s / 1e9,
           "crc32_gbps": n / crc32_s / 1e9,
           "zlib1_compress_gbps": piece.nbytes / compress_s / 1e9,
           "zlib1_decompress_gbps": piece.nbytes / decompress_s / 1e9,
           "zlib1_ratio": len(packed) / piece.nbytes}
    log("io", f"crc32c library: path {path} (built and loaded in "
              f"{build_s:.3f} s); RFC 3720 vectors and {checked} bytes at "
              f"unaligned lengths equal to the plain version on both paths; "
              f"{out['crc32c_gbps']:.3f} GB/s ({out['crc32c_table_gbps']:.3f} "
              f"on the table path) against zlib.crc32 "
              f"{out['crc32_gbps']:.3f} GB/s on {n} bytes; zlib level 1 on "
              f"one 64 MiB piece: compress {out['zlib1_compress_gbps']:.4f} "
              f"GB/s, decompress {out['zlib1_decompress_gbps']:.3f} GB/s, "
              f"ratio {out['zlib1_ratio']:.4f} [{card}]")
    return out


# -- phase 8 -------------------------------------------------------------------

PRECOPY_LIVE = 2          # step of the live pre-copy pass
STAGE_PIECE = 64 << 20    # bytes of each streamed piece of a data file
# The pre-copy migration's depth (its widths are the flagship's): two
# migrations of the whole Adam state and two dumps of it are the
# script's longest phase at 13 layers; this depth keeps the script
# within its time. Its reference is an uninterrupted run at this depth.
PRECOPY_LAYERS = 2
PRECOPY_ARGS = ["--layers", str(PRECOPY_LAYERS), "--seq", str(SEQ),
                "--batch", str(BATCH)]


class Stager:
    """A streamed stage in the reference agent's journal format
    (``grit_tpu/agent/copy.py:81-153``): files copied from ``src`` into
    ``dst``, one flushed JSON line per event in ``dst``'s stage journal —
    ``{"file", "staged", "done"}`` for a whole file, ``{"file", "staged"}``
    for each waterline advance of a streamed one, then ``{"complete":
    true}`` or ``{"failed": msg}``."""

    def __init__(self, src: str, dst: str) -> None:
        from grit_tpu_torch.metadata import STAGE_JOURNAL_FILE  # noqa: PLC0415

        import threading  # noqa: PLC0415

        self.src, self.dst = src, dst
        os.makedirs(dst, exist_ok=True)
        self.journal = open(os.path.join(dst, STAGE_JOURNAL_FILE), "w")
        self.bytes = 0
        self._lock = threading.Lock()  # files stream on threads of their own

    def _emit(self, rec: dict, nbytes: int = 0) -> None:
        with self._lock:
            self.bytes += nbytes
            self.journal.write(json.dumps(rec) + "\n")
            self.journal.flush()

    def stage_file(self, rel: str) -> None:
        os.makedirs(os.path.dirname(os.path.join(self.dst, rel)), exist_ok=True)
        shutil.copyfile(os.path.join(self.src, rel), os.path.join(self.dst, rel))
        size = os.path.getsize(os.path.join(self.dst, rel))
        self._emit({"file": rel, "staged": size, "done": True}, size)

    def preallocate(self, rel: str) -> None:
        """The destination file at its full size, as a chunked transfer
        leaves it: a read the journal does not gate would see zeros."""
        os.makedirs(os.path.dirname(os.path.join(self.dst, rel)), exist_ok=True)
        with open(os.path.join(self.dst, rel), "wb") as f:
            f.truncate(os.path.getsize(os.path.join(self.src, rel)))

    def stream_file(self, rel: str, limit: int | None = None) -> None:
        """Copy ``rel`` piece by piece, a waterline line after each; with
        ``limit``, stop after that many bytes (no ``done`` line)."""
        size = os.path.getsize(os.path.join(self.src, rel))
        end = size if limit is None else min(limit, size)
        with open(os.path.join(self.src, rel), "rb") as fin, \
                open(os.path.join(self.dst, rel), "r+b") as fout:
            water = 0
            while water < end:
                piece = fin.read(min(STAGE_PIECE, end - water))
                fout.write(piece)
                fout.flush()
                water += len(piece)
                self._emit({"file": rel, "staged": water}
                           | ({"done": True} if water >= size else {}),
                           len(piece))

    def stream_files(self, rels: list[str]) -> None:
        """Each file on a thread of its own, as the agent's transfer
        copies files in parallel."""
        from concurrent.futures import ThreadPoolExecutor  # noqa: PLC0415

        with ThreadPoolExecutor(max_workers=len(rels)) as pool:
            for fut in [pool.submit(self.stream_file, rel) for rel in rels]:
                fut.result()

    def complete(self) -> None:
        self._emit({"complete": True})
        self.journal.close()

    def fail(self, msg: str) -> None:
        self._emit({"failed": msg})
        self.journal.close()


def mirror_commit_files(d: str) -> dict:
    """The ``{"files": ...}`` identity map of a mirror COMMIT's second line."""
    with open(os.path.join(d, "COMMIT")) as f:
        f.readline()
        return json.loads(f.readline())["files"]


def precopy_env(work: str) -> tuple[str, dict]:
    """Phase 8's socket dir (made here) and its workloads' environment."""
    socks = os.path.join(work, "socks-precopy")
    os.makedirs(socks, exist_ok=True)
    return socks, {"GRIT_TPU_SOCKET_DIR": socks, "GRIT_SNAP_SPECULATE": "1"}


def phase_precopy(work: str, card: str, source: tuple) -> dict:
    """The reference agent's pre-copy and streamed-stage migration of the
    flagship trainer at :data:`PRECOPY_LAYERS` layers (an uninterrupted
    run at that depth is the reference), driven here as the agent drives
    it: a live pass
    (quiesce, hashed dump mirrored to the PVC, resume), the blackout (a
    quiesce with a dump spec, whose concurrent pass writes a boundary
    clone to ``-spec`` against the live pass; the dump must validate it
    and re-ship, mirrored, what changed), a zero-dirty re-dump, the
    mirrors' COMMIT identities, then a destination that restores while
    the three trees' data files still stream in, and a planted
    ``failed`` journal line it must refuse. ``source``: its
    :func:`precopy_source` parked by :func:`park_all` (as
    :func:`early_sources` parks it)."""
    from grit_tpu_torch.device.agentlet import ToggleClient  # noqa: PLC0415
    from grit_tpu_torch.device.snapshot import (  # noqa: PLC0415
        DATA_FILE, INDEX_FILE, MANIFEST_FILE, SPEC_SUFFIX, SnapshotManifest,
        snapshot_delta_nbytes, snapshot_exists, snapshot_nbytes)
    from grit_tpu_torch.metadata import manifest_data_file_signature  # noqa: PLC0415

    log("precopy", f"free disk beside the trees "
                   f"{shutil.disk_usage(work).free / 1e9:.1f} GB")
    socks, env = precopy_env(work)
    host, pvc, dst_root = (os.path.join(work, n) for n in ("host", "pvc", "dst"))
    # Speculation on: the blackout's validated re-ship (delta) references
    # its concurrent pass (spec), which deltas against the live pass (base).
    trees = {"base": "main-precopy/hbm", "delta": "main/hbm",
             "spec": "main/hbm" + SPEC_SUFFIX, "redump": "main-redump/hbm"}
    at = {k: os.path.join(host, rel) for k, rel in trees.items()}
    procs: list[Workload] = []
    try:
        src, parked = source
        procs.append(src)
        parked.resume()
        parked.close()
        src.wait_for(rf"STEP {PRECOPY_LIVE} ")
        client = ToggleClient(src.proc.pid, path=os.path.join(
            socks, f"grit-tpu-{src.proc.pid}.sock"), timeout=600)
        # The live pass, as the agent's predump parks it.
        t0 = time.perf_counter()
        live_step = client.quiesce()
        t1 = time.perf_counter()
        live = client.dump(at["base"], hashes=True,
                           mirror=os.path.join(pvc, trees["base"]))["legs"]
        t2 = time.perf_counter()
        client.resume()
        live_s = t2 - t1
        src.wait_for(rf"STEP {MIGRATE_CUT} ")
        # The blackout: quiesce with a dump spec, the delta dump mirrored.
        t_quiesce = time.perf_counter()
        cut = client.quiesce(dump_spec={
            "dir": at["delta"], "base": at["base"],
            "mirror": os.path.join(pvc, trees["delta"])})
        t_dump = time.perf_counter()
        resp = client.dump(at["delta"], base=at["base"],
                           mirror=os.path.join(pvc, trees["delta"]))
        t_dumped = time.perf_counter()
        spec = resp.get("speculative", {})
        if spec.get("outcome") != "validated":
            raise AssertionError(f"the blackout's speculation did not "
                                 f"validate: {spec}")
        blackout_legs = resp["legs"]
        # Reuse-path check while the source is still parked (outside the
        # blackout's account).
        redump = client.dump(at["redump"], base=at["delta"])["legs"]
        t_redumped = time.perf_counter()
        client.close()
        src.kill()
        t_killed = time.perf_counter()
    finally:
        for p in procs:
            p.kill()

    sizes = {k: snapshot_nbytes(d) for k, d in at.items()}
    dirty = {k: json.load(open(os.path.join(at[k], MANIFEST_FILE))).get("dirty")
             for k in ("delta", "spec", "redump")}
    metas_at = {k: SnapshotManifest.load(at[k]).meta["step"]
                for k in ("spec", "delta")}
    if spec["dirty_bytes"] != dirty["delta"]["bytes"] or \
            spec["clean_bytes"] + spec["dirty_bytes"] != sizes["delta"]:
        raise AssertionError(f"the speculative accounting {spec} disagrees "
                             f"with the re-ship's manifest {dirty['delta']}")
    re_chunks = [c for rec in SnapshotManifest.load(at["redump"]).arrays
                 for c in rec["chunks"]]
    if dirty["redump"]["bytes"] != 0 or not all(c.get("ref_dir")
                                                for c in re_chunks):
        raise AssertionError(f"the re-dump of a parked state wrote bytes: "
                             f"{dirty['redump']}")
    if snapshot_delta_nbytes(at["delta"]) != dirty["delta"]["bytes"]:
        raise AssertionError("the delta's dirty block disagrees with its chunks")
    mirrors = {}
    for k in ("base", "spec", "delta"):
        mirror = os.path.join(pvc, trees[k])
        if not snapshot_exists(mirror):
            raise AssertionError(f"the {k} mirror did not commit")
        manifest = json.load(open(os.path.join(at[k], MANIFEST_FILE)))
        want = {"size": snapshot_delta_nbytes(at[k]),
                "sig": manifest_data_file_signature(manifest, DATA_FILE)}
        got = mirror_commit_files(mirror)[DATA_FILE]
        if got != want:
            raise AssertionError(f"the {k} mirror records {got}, the primary "
                                 f"{want}")
        mirrors[k] = got["size"]
    shutil.rmtree(host)  # the agent's upload would skip every mirrored file

    # The streamed stage: metadata first, the destination spawned, the
    # data streamed only once it has begun its restore.
    # The -spec sibling ships with the re-ship, as the agent ships it.
    metas = [f"{trees[k]}/{n}" for k in ("delta", "spec", "base")
             for n in ("COMMIT", MANIFEST_FILE, INDEX_FILE)]
    datas = [f"{trees[k]}/{DATA_FILE}" for k in ("delta", "spec", "base")]

    def stage(stderr_path=None, prestaged=()):
        """The destination spawned over a fresh stage. ``prestaged`` data
        files are staged whole first, outside the blackout's account, as
        the agent's prestage ships the base before the blackout."""
        stager = Stager(pvc, dst_root)
        for rel in prestaged:
            stager.stage_file(rel)
        t_stage = time.perf_counter()
        for rel in metas:
            stager.stage_file(rel)
        for rel in datas:
            if rel not in prestaged:
                stager.preallocate(rel)
        dst = Workload(MIGRATE_STEPS, {
            **env, "GRIT_TPU_RESTORE_DIR": os.path.join(dst_root, trees["delta"])},
            stderr_path=stderr_path, args=PRECOPY_ARGS)
        procs.append(dst)
        dst.wait_for("RESTORE_BEGIN")
        return stager, dst, t_stage, time.perf_counter()

    def migrate_in(prestaged=()) -> dict:
        """Stage, restore while the rest streams, run to the end; the
        destination's numbers, from the stage's start."""
        stager, dst, t_stage, t_begin = stage(prestaged=prestaged)
        stager.stream_files([rel for rel in datas if rel not in prestaged])
        stager.complete()
        t_streamed = time.perf_counter()
        run = {"restored": int(dst.wait_for(r"RESTORED (\d+)").group(1))}
        t_restored = time.perf_counter()
        run["restore_s"] = float(dst.wait_for(r"RESTORE_SECONDS (\S+)").group(1))
        run["pipe"] = json.loads(dst.wait_for(r"RESTORE_PIPELINE (.+)").group(1))
        run["init_s"] = float(dst.wait_for(r"INIT_SECONDS (\S+)").group(1))
        dst.wait_for("READY")
        t_ready = time.perf_counter()
        dst.wait_for(r"STEP \d+ ")
        t_first = time.perf_counter()
        dst.finish()
        run.update(losses=dst.losses(), staged_bytes=stager.bytes,
                   spawn_s=dst.started - t_stage,
                   begin_s=t_begin - dst.started,
                   streamed_s=t_streamed - t_begin,
                   first_s=t_first - t_restored, ready_s=t_first - t_ready,
                   stage_to_first_s=t_first - t_stage)
        return run

    try:
        runs = {"streamed": migrate_in(),
                "base prestaged": migrate_in(prestaged=(datas[2],))}

        # Planted fault: the stage again, its stager dying a quarter of
        # the way through the delta's data, must be refused. The
        # uninterrupted run at this depth, the reference, runs beside it:
        # nothing is timed here.
        ref = Workload(MIGRATE_STEPS, env, args=PRECOPY_ARGS)
        procs.append(ref)
        err_path = os.path.join(work, "precopy-fault.stderr")
        fstager, fdst, _, _ = stage(err_path)
        fstager.stream_file(datas[0], limit=os.path.getsize(
            os.path.join(pvc, datas[0])) // 4)
        fstager.fail("planted: the stager died mid-stream")
        while fdst.proc.stdout.readline():
            pass
        frc = fdst.proc.wait(timeout=300)
        with open(err_path) as f:
            ferr = f.read()
        ref.finish()
        ref_losses = ref.losses()
    finally:
        for p in procs:
            p.kill()
        shutil.rmtree(pvc, ignore_errors=True)
        shutil.rmtree(dst_root, ignore_errors=True)

    want = {s: x for s, x in ref_losses.items() if s > cut}
    for label, run in runs.items():
        if run["restored"] != cut:
            raise AssertionError(f"{label}: restored step {run['restored']}, "
                                 f"quiesced at {cut}")
        if not want or run["losses"] != want:
            raise AssertionError(f"{label}: losses after the cut differ from "
                                 f"the uninterrupted run: {run['losses']} vs "
                                 f"{want}")
    # stage_wait counts only reads that found their bytes not yet staged:
    # a restore that began after the stream had ended shows 0. (With the
    # base prestaged, a small delta may land before the reads need it.)
    pipe = runs["streamed"]["pipe"]
    if not pipe["stage_wait"] > 0 or not pipe["streamed"]:
        raise AssertionError(f"the restore never waited on the stream: {pipe}")
    if frc == 0 or "SnapshotIntegrityError" not in ferr \
            or "mid-transfer" not in ferr:
        raise AssertionError(f"a failed journal line was not refused (rc "
                             f"{frc}): {ferr[-2000:]}")

    dump_s, redump_s = t_dumped - t_dump, t_redumped - t_dumped
    kill_s = t_killed - t_redumped
    # The re-dump check and the tree checks between kill and stage are
    # this script's, not the migration's.
    for run in runs.values():
        run["blackout_s"] = (t_dumped - t_quiesce) + kill_s + run["stage_to_first_s"]
    log("precopy", f"trees: base {sizes['base']} B (live pass at step "
                   f"{live_step}, sha256 per chunk); speculative pass "
                   f"{sizes['spec']} B (clone at step {metas_at['spec']}) with "
                   f"{dirty['spec']['bytes']} dirty against the base "
                   f"({dirty['spec']['chunks']} of {dirty['spec']['totalChunks']}"
                   f" chunks); validated re-ship {sizes['delta']} B (parked at "
                   f"step {metas_at['delta']}) with {dirty['delta']['bytes']} "
                   f"dirty ({dirty['delta']['bytes'] / dirty['delta']['totalBytes']:.4f}"
                   f", {dirty['delta']['chunks']} of "
                   f"{dirty['delta']['totalChunks']} chunks), re-dump "
                   f"{sizes['redump']} B with {dirty['redump']['bytes']} dirty "
                   f"(every chunk a reference)")
    log("precopy", f"speculation: outcome {spec['outcome']}, overlap_s "
                   f"{spec['overlap_s']}, validate_s {spec['validate_s']}, "
                   f"clean_bytes {spec['clean_bytes']}, dirty_bytes "
                   f"{spec['dirty_bytes']}; device memory {spec.get('hbm')}; "
                   f"blackout dump {dump_s:.3f} s; {PRECOPY_LAYERS} layers "
                   f"[{card}]")
    for label, secs, legs in (("live pass", live_s, live),
                              ("speculative pass (inside the dump's join)",
                               spec["overlap_s"], spec["legs"]),
                              ("blackout dump", dump_s, blackout_legs),
                              ("re-dump", redump_s, redump)):
        log("precopy", f"{label}: {secs:.3f} s = "
                       f"{legs['total_bytes'] / secs / 1e9:.3f} GB/s of state "
                       f"({legs['bytes']} B written); seconds "
                       f"{fmt_legs(legs, DUMP_LEGS)}; through {legs['staging']}; "
                       f"mirror committed {legs['mirror']} [{card}]")
    log("precopy", f"mirrors: base {mirrors['base']} B, spec "
                   f"{mirrors['spec']} B, delta {mirrors['delta']} B, all "
                   f"committed; each COMMIT's "
                   f"data-h0000.bin size and signature equal the primary "
                   f"MANIFEST's")
    for label, run in runs.items():
        pipe = run["pipe"]
        log("precopy", f"restore, {label}: {run['restore_s']:.3f} s = "
                       f"{pipe['bytes'] / run['restore_s'] / 1e9:.3f} GB/s "
                       f"through {pipe['staging']} with {pipe['workers']} "
                       f"readers, seconds {fmt_legs(pipe, RESTORE_LEGS)}, "
                       f"overlap fraction {pipe['overlap_fraction']:.3f}; "
                       f"stager {run['staged_bytes']} B in all, data streamed "
                       f"{run['streamed_s']:.3f} s after RESTORE_BEGIN [{card}]")
        log("precopy", f"blackout, {label} (quiesce → first post-restore "
                       f"step, the script's checks left out) "
                       f"{run['blackout_s']:.3f} s = quiesce "
                       f"{t_dump - t_quiesce:.4f} + dump {dump_s:.3f} + kill "
                       f"{kill_s:.3f} + metadata stage and spawn "
                       f"{run['spawn_s']:.3f} + spawn → RESTORE_BEGIN "
                       f"{run['begin_s']:.3f} (set-up {run['init_s']:.3f}) + "
                       f"restore {run['restore_s']:.3f} + RESTORED → first "
                       f"step {run['first_s']:.3f} (READY → first step "
                       f"{run['ready_s']:.3f}) [{card}]")
    log("precopy", f"cut at step {cut}; losses after the cut bitwise equal "
                   f"to the uninterrupted run in both restores: "
                   f"{runs['streamed']['losses']}; planted failed journal "
                   f"line refused (rc {frc}, SnapshotIntegrityError) [{card}]")
    return {"bytes": sizes, "dirty": dirty, "mirror_bytes": mirrors,
            "live_s": live_s, "dump_s": dump_s, "redump_s": redump_s,
            "speculative": {k: v for k, v in spec.items() if k != "legs"},
            "legs": {"live": live, "blackout": blackout_legs,
                     "speculative": spec["legs"],
                     "redump": redump,
                     "restore": runs["streamed"]["pipe"],
                     "restore_base_prestaged": runs["base prestaged"]["pipe"]},
            "restore_s": runs["streamed"]["restore_s"],
            "blackout_s": runs["streamed"]["blackout_s"],
            "restore_base_prestaged_s": runs["base prestaged"]["restore_s"],
            "blackout_base_prestaged_s": runs["base prestaged"]["blackout_s"],
            "cut": cut}


# -- phase 9 -------------------------------------------------------------------

FROZEN_AFTER = 5       # steps the restored frozen-trunk runs take past the cut
MNIST_ARGS = ["--model", "mnist"]  # the harness workload's twin (rehearsal:
MNIST_AFTER = 5                    # ... + ["--device", "cpu"])
TRAINABLE = ("['params']['final_norm']", "['params']['lm_head']")


class HookCalls:
    """The toggle client of a hook's open connection, instrumented: the
    host clock when the quiesce returned (the park), and the dump's
    response (the writer's legs, the speculative outcome)."""

    def __init__(self, client) -> None:
        self.parked_at = None
        self.dump_resp: dict = {}
        quiesce, dump = client.quiesce, client.dump

        def timed_quiesce(**kw):
            out = quiesce(**kw)
            self.parked_at = time.perf_counter()
            return out

        def kept_dump(*a, **kw):
            self.dump_resp = dump(*a, **kw)
            return self.dump_resp

        client.quiesce, client.dump = timed_quiesce, kept_dump


class HookWarnings:
    """Warnings the port's device hook logs while it is installed."""

    def __init__(self) -> None:
        import logging  # noqa: PLC0415

        self.messages: list[str] = []
        self.handler = logging.Handler(logging.WARNING)
        self.handler.emit = lambda rec: self.messages.append(rec.getMessage())
        logging.getLogger("grit_tpu_torch.device.hook").addHandler(self.handler)

    def close(self) -> None:
        import logging  # noqa: PLC0415

        logging.getLogger("grit_tpu_torch.device.hook").removeHandler(
            self.handler)


def _chain_names(d: str, base: str) -> tuple[set, set]:
    """Leaf names of the committed delta ``d`` whose bytes lie outside
    ``base`` (written since it), and those ``d`` wrote itself."""
    from grit_tpu_torch.device.snapshot import SnapshotManifest  # noqa: PLC0415

    since, own = set(), set()
    for rec in SnapshotManifest.load(d).arrays:
        for c in rec["chunks"]:
            at = os.path.normpath(os.path.join(d, c.get("ref_dir", ".")))
            if at != os.path.normpath(base):
                since.add(rec["name"])
            if not c.get("ref_dir"):
                own.add(rec["name"])
    return since, own


def frozen_env(work: str) -> tuple[str, dict, list[str]]:
    """Phase 9's socket dir (made here), its source's environment and
    arguments."""
    from grit_tpu_torch.ops import build  # noqa: PLC0415

    socks = os.path.join(work, "socks-frozen")
    os.makedirs(socks, exist_ok=True)
    env = {"GRIT_TPU_SOCKET_DIR": socks,
           "GRIT_TPU_COMPILE_CACHE": str(build.build_dir()),
           "GRIT_SNAP_SPECULATE": "1"}
    return socks, env, WORKLOAD_ARGS + ["--optimizer", "frozen-trunk"]


def phase_frozen(work: str, card: str, *, train: dict,
                 source: tuple) -> dict:
    """The bench's migrated flagship, the frozen-trunk fine-tune (sgd 0.5
    on ``final_norm`` and ``lm_head``, the trunk frozen), migrated as the
    reference agent does with pre-copy and speculation on, through the
    port's ``TpuDeviceCheckpointHook``: ``predump`` at step 2 (the
    non-parking probe: the loop steps through it), the blackout (a
    quiesce whose concurrent pass writes a boundary clone to ``-spec``
    against the probe, then the validated re-ship of what the last step
    touched), the carried kernel libraries uploaded beside the mirrors, a
    streamed stage of all three trees into a destination whose
    ``GRIT_TPU_COMPILE_CACHE`` is empty, which restores and continues.
    Then the harness's MNIST workload, migrated through
    ``AutoDeviceHook``; the uninterrupted frozen-trunk run, long enough to
    pass the cut, and a second destination that restores the staged tree
    by post-copy (``GRIT_RESTORE_POSTCOPY=1``) run beside the MNIST
    twin's reference and destination. ``train``: phase 4's record, whose
    step times this phase prints. ``source``: its :func:`frozen_source`
    parked by :func:`park_all` (as :func:`early_sources` parks it)."""
    from grit_tpu_torch.device.agentlet import ToggleClient  # noqa: PLC0415
    from grit_tpu_torch.device.hook import TpuDeviceCheckpointHook  # noqa: PLC0415
    from grit_tpu_torch.device.snapshot import (  # noqa: PLC0415
        DATA_FILE, INDEX_FILE, MANIFEST_FILE, SPEC_SUFFIX, SnapshotManifest,
        snapshot_delta_nbytes, snapshot_exists, snapshot_nbytes)
    from grit_tpu_torch.ops import build  # noqa: PLC0415
    from grit_tpu_torch.ops.build import COMPILE_CACHE_SUBDIR  # noqa: PLC0415

    cache_src = str(build.build_dir())
    libs = sorted(build.library_path(stem).name for stem in build.SOURCES)
    socks, env, args = frozen_env(work)
    host, pvc, dst_root = (os.path.join(work, n)
                           for n in ("host-f", "pvc-f", "dst-f"))
    dst_cache = os.path.join(work, "dst-kernel-cache")
    os.makedirs(dst_cache)
    trees = {"base": "main-precopy/hbm", "delta": "main/hbm",
             "spec": "main/hbm" + SPEC_SUFFIX}
    at = {k: os.path.join(host, rel) for k, rel in trees.items()}
    saved_env = {k: os.environ.get(k) for k in env}
    os.environ.update(env)  # the hook's process: the agent's environment
    warnings = HookWarnings()
    probes: list[dict] = []
    client_dump = ToggleClient.dump

    def kept_dump(self, *a, **kw):
        resp = client_dump(self, *a, **kw)
        if kw.get("speculative"):
            probes.append(resp)
        return resp

    ToggleClient.dump = kept_dump  # the probe's response, for its outcome
    procs: list[Workload] = []
    try:
        src, parked = source
        procs.append(src)
        parked.resume()
        parked.close()
        src.wait_for(rf"STEP {PRECOPY_LIVE} ")
        hook = TpuDeviceCheckpointHook(timeout=600)
        status = ToggleClient(src.proc.pid, path=os.path.join(
            socks, f"grit-tpu-{src.proc.pid}.sock"), timeout=600)
        step_before = status.status()["step"]
        t0 = time.perf_counter()
        hook.predump(src.proc.pid, os.path.dirname(at["base"]),
                     mirror=os.path.join(pvc, os.path.dirname(trees["base"])))
        live_s = time.perf_counter() - t0
        step_after = status.status()["step"]
        status.close()
        src.wait_for(rf"STEP {MIGRATE_CUT} ")
        calls = HookCalls(hook._client(src.proc.pid))
        t_quiesce = time.perf_counter()
        hook.dump(src.proc.pid, os.path.dirname(at["delta"]), base=at["base"],
                  mirror=os.path.join(pvc, os.path.dirname(trees["delta"])))
        t_dumped = time.perf_counter()
        src.kill()
        # The agent's upload ships what the mirror did not: the carried
        # libraries (the mirrors hold the snapshot's own files).
        carried = sorted(os.listdir(os.path.join(at["delta"],
                                                 COMPILE_CACHE_SUBDIR)))
        shutil.copytree(os.path.join(at["delta"], COMPILE_CACHE_SUBDIR),
                        os.path.join(pvc, trees["delta"], COMPILE_CACHE_SUBDIR))
        t_uploaded = time.perf_counter()
    finally:
        ToggleClient.dump = client_dump
        warnings.close()
        for k, v in saved_env.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        for p in procs:
            p.kill()

    if warnings.messages:
        raise AssertionError(f"the hook warned: {warnings.messages}")
    if [r.get("speculative", {}).get("outcome") for r in probes] != ["probe"]:
        raise AssertionError(f"the predump was not served as a probe: {probes}")
    probe = probes[0]
    resp = calls.dump_resp
    spec = resp.get("speculative", {})
    if spec.get("outcome") != "validated":
        raise AssertionError(f"the blackout's speculation did not validate: "
                             f"{spec}")
    base_chunks = [c for rec in SnapshotManifest.load(at["base"]).arrays
                   for c in rec["chunks"]]
    if not all("sha256" in c for c in base_chunks):
        raise AssertionError("the live pass was not hashed")
    manifest = json.load(open(os.path.join(at["delta"], MANIFEST_FILE)))
    cut = manifest["meta"]["step"]
    spec_step = SnapshotManifest.load(at["spec"]).meta["step"]
    trainable = set(TRAINABLE) | {"['step']"}
    since, dirty_names = _chain_names(at["delta"], at["base"])
    if since != trainable:
        raise AssertionError(f"leaves written since the live pass: "
                             f"{sorted(since)}, not the trainable slice and "
                             f"the step")
    want_dirty = trainable if cut > spec_step else set()
    if dirty_names != want_dirty:
        raise AssertionError(f"the re-ship (parked at step {cut}, clone at "
                             f"{spec_step}) wrote {sorted(dirty_names)}, "
                             f"want {sorted(want_dirty)}")
    dirty = manifest["dirty"]
    if snapshot_delta_nbytes(at["delta"]) != dirty["bytes"] or \
            spec["dirty_bytes"] != dirty["bytes"]:
        raise AssertionError(f"the re-ship's dirty accounting disagrees: "
                             f"{dirty} vs {spec}")
    for k in trees:
        if not snapshot_exists(os.path.join(pvc, trees[k])):
            raise AssertionError(f"the {k} mirror did not commit")
    if carried != libs:
        raise AssertionError(f"the snapshot carried {carried}, not {libs}")
    sizes = {k: snapshot_nbytes(d) for k, d in at.items()}
    spec_dirty = json.load(open(os.path.join(at["spec"], MANIFEST_FILE)))["dirty"]
    shutil.rmtree(host)

    # The streamed stage: metadata and the carried libraries first, the
    # destination spawned, the data streamed once it begins its restore.
    # The -spec sibling ships with the re-ship, as the agent ships it.
    metas = [f"{trees[k]}/{n}" for k in ("delta", "spec", "base")
             for n in ("COMMIT", MANIFEST_FILE, INDEX_FILE)]
    metas += [f"{trees['delta']}/{COMPILE_CACHE_SUBDIR}/{n}" for n in libs]
    datas = [f"{trees[k]}/{DATA_FILE}" for k in ("delta", "spec", "base")]
    n_steps = cut + FROZEN_AFTER
    dst_env = {**env, "GRIT_TPU_COMPILE_CACHE": dst_cache,
               "GRIT_TPU_RESTORE_DIR": os.path.join(dst_root, trees["delta"])}
    try:
        stager = Stager(pvc, dst_root)
        t_stage = time.perf_counter()
        for rel in metas:
            stager.stage_file(rel)
        for rel in datas:
            stager.preallocate(rel)
        dst = Workload(n_steps, dst_env, args=args)
        procs.append(dst)
        dst.wait_for("RESTORE_BEGIN")
        t_begin = time.perf_counter()
        stager.stream_files(datas)
        stager.complete()
        restored = int(dst.wait_for(r"RESTORED (\d+)").group(1))
        t_restored = time.perf_counter()
        restore_s = float(dst.wait_for(r"RESTORE_SECONDS (\S+)").group(1))
        pipe = json.loads(dst.wait_for(r"RESTORE_PIPELINE (.+)").group(1))
        seeded = pipe["seeded"]
        init_s = float(dst.wait_for(r"INIT_SECONDS (\S+)").group(1))
        dst.wait_for("READY")
        t_ready = time.perf_counter()
        dst.wait_for(r"STEP \d+ ")
        t_first = time.perf_counter()
        dst.finish()
        dst_kernels = dst.kernels()
    finally:
        for p in procs:
            p.kill()
        shutil.rmtree(pvc, ignore_errors=True)

    # The uninterrupted run, long enough to pass the cut, and the post-copy
    # destination from the staged tree (READY follows the hot set, the
    # first step joins the tail) start beside the MNIST twin's reference
    # and destination, where nothing else is timed.
    try:
        mnist, (ref, pc) = mnist_twin(work, card, beside=lambda: [
            Workload(n_steps, env, args=args),
            Workload(n_steps, {**dst_env, "GRIT_RESTORE_POSTCOPY": "1"},
                     args=args)])
    finally:
        shutil.rmtree(dst_root, ignore_errors=True)
    pc_restored = int(pc.find(r"RESTORED (\d+)").group(1))
    pc_hot_s = float(pc.find(r"RESTORE_SECONDS (\S+)").group(1))
    pc_pipe = json.loads(pc.find(r"RESTORE_PIPELINE (.+)").group(1))
    pc_ready, pc_first = pc.arrival("READY"), pc.arrival(r"STEP \d+ ")
    pc_tail = json.loads(pc.find(r"RESTORE_POSTCOPY (.+)").group(1))
    pc_kernels = pc.kernels()
    ref_losses, ref_kernels = ref.losses(), ref.kernels()
    got, pc_got = dst.losses(), pc.losses()
    want = {s: x for s, x in ref_losses.items() if s > cut}
    if restored != cut or len(want) != FROZEN_AFTER or got != want:
        raise AssertionError(f"restored step {restored} (cut {cut}); losses "
                             f"after the cut {got}, uninterrupted {want}")
    if pc_restored != cut or pc_got != want or not pc_pipe.get("postcopy"):
        raise AssertionError(f"post-copy destination: restored {pc_restored} "
                             f"(cut {cut}), losses {pc_got} vs {want}, "
                             f"pipeline {pc_pipe}")
    if not all(math.isfinite(x) for x in ref_losses.values()):
        raise AssertionError(f"non-finite frozen-trunk loss: {ref_losses}")
    in_cache = sorted(os.listdir(dst_cache))
    if seeded != len(libs) or in_cache != libs or dst_kernels["built"]:
        raise AssertionError(
            f"the destination seeded {seeded} files, holds {in_cache} and "
            f"compiled {dst_kernels['built']}: want {libs} seeded, none built")
    per_step = {n: ref_kernels["launches"][n] / n_steps for n in KERNELS}
    if per_step != {"flash_fwd": LAYERS, "flash_bwd_dq": 0,
                    "flash_bwd_dkv": 0}:
        raise AssertionError(f"frozen-trunk launches a step {per_step}")
    if sorted(dst_kernels["loaded"].values()) != [
            n for n in libs if n.startswith("libflash_fwd-")]:
        raise AssertionError(f"the destination loaded "
                             f"{dst_kernels['loaded']}, not the carried "
                             f"forward kernel")
    share = dirty["bytes"] / dirty["totalBytes"]
    dump_s = t_dumped - calls.parked_at
    quiesce_s = calls.parked_at - t_quiesce
    kill_s = t_uploaded - t_dumped
    first_step_s = t_first - t_ready
    # The tree checks between the upload and the stage are this script's.
    blackout_s = (t_uploaded - t_quiesce) + (t_first - t_stage)
    log("frozen", f"frozen-trunk flagship (sgd 0.5 on final_norm and "
                  f"lm_head): losses of the uninterrupted run "
                  f"{[ref_losses[s] for s in sorted(ref_losses)]}; step "
                  f"{train['frozen_step_s']:.4f} s against Adam's "
                  f"{train['step_s']:.4f} s (both phase 4's, in process, "
                  f"median after the first) [{card}]")
    log("frozen", f"launches a step, uninterrupted run: {per_step} "
                  f"({ref_kernels['launches']} in {n_steps} steps); "
                  f"destinations {dst_kernels['launches']} and "
                  f"{pc_kernels['launches']} in {len(got)} steps each")
    log("frozen", f"live pass (hook predump, the non-parking probe) "
                  f"{live_s:.3f} s: the source completed "
                  f"{step_after - step_before} steps during it (steps "
                  f"{step_before} → {step_after}; "
                  f"{live_s / max(1, step_after - step_before):.4f} s a step "
                  f"while the pass ran); base {sizes['base']} B "
                  f"hashed and mirrored; writer legs "
                  f"{fmt_legs(probe['legs'], DUMP_LEGS)}; device memory "
                  f"{probe['speculative'].get('hbm')} [{card}]")
    log("frozen", f"blackout dump {dump_s:.3f} s (quiesce {quiesce_s:.4f} s, "
                  f"with the boundary clone and the pass's launch): "
                  f"speculation {spec['outcome']}, overlap_s "
                  f"{spec['overlap_s']}, validate_s {spec['validate_s']}, "
                  f"clean_bytes {spec['clean_bytes']}, dirty_bytes "
                  f"{spec['dirty_bytes']} (clone at step {spec_step}, parked "
                  f"at {cut}: {sorted(dirty_names)}); the pass wrote "
                  f"{spec_dirty['bytes']} B against the live pass "
                  f"(legs {fmt_legs(spec['legs'], DUMP_LEGS)}); the re-ship "
                  f"{fmt_legs(resp['legs'], DUMP_LEGS)}; device memory "
                  f"{spec.get('hbm')} [{card}]")
    log("frozen", f"trees: base {sizes['base']} B, spec {sizes['spec']} B, "
                  f"re-ship {sizes['delta']} B with dirty {dirty['bytes']} B "
                  f"of {dirty['totalBytes']} ({share:.4f}; {dirty['chunks']} "
                  f"of {dirty['totalChunks']} chunks); written since the "
                  f"live pass: {sorted(since)}")
    log("frozen", f"restore {restore_s:.3f} s = "
                  f"{pipe['bytes'] / restore_s / 1e9:.3f} GB/s, "
                  f"{stager.bytes} B staged, seconds "
                  f"{fmt_legs(pipe, RESTORE_LEGS)}; first step after READY "
                  f"{first_step_s:.3f} s [{card}]")
    log("frozen", f"blackout (quiesce → first post-restore step, the "
                  f"script's checks left out) {blackout_s:.3f} s = quiesce "
                  f"{quiesce_s:.4f} + dump {dump_s:.3f} + kill and library "
                  f"upload {kill_s:.3f} + metadata stage and spawn "
                  f"{dst.started - t_stage:.3f} + spawn → RESTORE_BEGIN "
                  f"{t_begin - dst.started:.3f} (set-up {init_s:.3f}) + "
                  f"restore and RESTORED → READY {t_ready - t_begin:.3f} + "
                  f"first step {first_step_s:.3f} [{card}]")
    log("frozen", f"post-copy destination (staged tree): hot set "
                  f"{pc_hot_s:.4f} s ({pc_pipe['bytes']} B), spawn → READY "
                  f"{pc_ready - pc.started:.3f} s, READY → first step (joins "
                  f"the tail) {pc_first - pc_ready:.3f} s, tail_s "
                  f"{pc_tail['tail_s']:.3f}; against the blocking "
                  f"destination's restore {restore_s:.3f} s and first step "
                  f"{first_step_s:.3f} s; losses after the cut bitwise equal "
                  f"[{card}]")
    log("frozen", f"kernel libraries: carried {len(carried)} ({carried}); the "
                  f"destination seeded {seeded} into an empty "
                  f"GRIT_TPU_COMPILE_CACHE, compiled none, loaded "
                  f"{dst_kernels['loaded']}")
    log("frozen", f"cut at step {cut}; losses after the cut bitwise equal to "
                  f"the uninterrupted frozen-trunk run in both destinations: "
                  f"{got}")
    return {"step_s": train["frozen_step_s"],
            "launches": ref_kernels["launches"],
            "launches_per_step": per_step,
            "launches_all": {n: ref_kernels["launches"][n]
                             + dst_kernels["launches"][n]
                             + pc_kernels["launches"][n] for n in KERNELS},
            "bytes": sizes, "dirty": dirty, "dirty_share": share,
            "live_s": live_s, "live_steps": step_after - step_before,
            "probe_hbm": probe["speculative"].get("hbm"),
            "speculative": {k: v for k, v in spec.items() if k != "legs"},
            "quiesce_s": quiesce_s, "dump_s": dump_s,
            "dump_legs": resp["legs"], "spec_legs": spec["legs"],
            "restore_s": restore_s, "restore_legs": pipe,
            "first_step_s": first_step_s, "blackout_s": blackout_s,
            "postcopy": {"hot_s": pc_hot_s, "tail_s": pc_tail["tail_s"],
                         "spawn_to_ready_s": pc_ready - pc.started,
                         "first_step_s": pc_first - pc_ready},
            "seeded": seeded, "built_on_destination": dst_kernels["built"],
            "cut": cut, "mnist": mnist}


def mnist_twin(work: str, card: str, beside
               ) -> tuple[dict, list[Workload]]:
    """The harness's MNIST workload migrated once through the port's
    ``AutoDeviceHook``; with no agentlet (this process), the hook skips
    loudly. After the dump, its uninterrupted reference, its destination
    and the workloads ``beside()`` starts run at once (none of the MNIST
    ones is timed); returns the twin's record and those workloads,
    finished."""
    from grit_tpu_torch.device.hook import HBM_SUBDIR, AutoDeviceHook  # noqa: PLC0415

    socks = os.path.join(work, "socks-mnist")
    os.makedirs(socks)
    env = {"GRIT_TPU_SOCKET_DIR": socks}
    saved = os.environ.get("GRIT_TPU_SOCKET_DIR")
    os.environ["GRIT_TPU_SOCKET_DIR"] = socks
    warnings = HookWarnings()
    procs: list[Workload] = []
    try:
        hook = AutoDeviceHook(timeout=300)
        skipped = hook.dump(os.getpid(), os.path.join(work, "no-agentlet"))
        src = Workload(10 ** 9, env, args=MNIST_ARGS)
        procs.append(src)
        src.wait_for("READY")
        src.wait_for(r"STEP 3 ")
        src.drain()  # an MNIST step is far shorter than a pipe's worth
        ckpt = os.path.join(work, "mnist-ckpt")
        t0 = time.perf_counter()
        hook.dump(src.proc.pid, ckpt)
        dump_s = time.perf_counter() - t0
        src.kill()
        snap = os.path.join(ckpt, HBM_SUBDIR)
        cut = json.load(open(os.path.join(snap, "MANIFEST.json")))["meta"]["step"]
        others = beside()
        procs.extend(others)
        ref = Workload(cut + MNIST_AFTER, env, args=MNIST_ARGS)
        procs.append(ref)
        dst = Workload(cut + MNIST_AFTER, {**env, "GRIT_TPU_RESTORE_DIR": snap},
                       args=MNIST_ARGS)
        procs.append(dst)
        ref.finish()
        restored = int(dst.wait_for(r"RESTORED (\d+)").group(1))
        dst.finish()
        for other in others:
            other.finish()
    finally:
        warnings.close()
        if saved is None:
            os.environ.pop("GRIT_TPU_SOCKET_DIR", None)
        else:
            os.environ["GRIT_TPU_SOCKET_DIR"] = saved
        for p in procs:
            p.kill()
    got = dst.losses()
    want = {s: x for s, x in ref.losses().items() if s > cut}
    if skipped is not None or not any(
            f"no agentlet socket for pid {os.getpid()}" in m
            for m in warnings.messages):
        raise AssertionError(f"no loud skip without an agentlet: "
                             f"{warnings.messages}")
    if restored != cut or len(got) != MNIST_AFTER or got != want:
        raise AssertionError(f"MNIST: restored {restored} (cut {cut}), "
                             f"losses {got} vs {want}")
    log("frozen", f"MNIST twin (hidden 16, batch 16, Adam): migrated through "
                  f"AutoDeviceHook at step {cut} (dump {dump_s:.3f} s), "
                  f"{MNIST_AFTER} losses after the cut bitwise equal: "
                  f"{[got[s] for s in sorted(got)]}; a pid without an "
                  f"agentlet skipped loudly [{card}]")
    return {"cut": cut, "dump_s": dump_s, "losses": got}, others


# -- phase 10 ------------------------------------------------------------------

WIRE_STREAMS = 2
# The wire runs' depth (their widths are the flagship's): the codec
# compresses nearly every bf16 block on the host's cores, so its dump
# grows with the state; this depth keeps the script within its time.
WIRE_LAYERS = 2
WIRE_RUNS = (("raw", "none"), ("zlib", "zlib"))  # (label, codec)


class Receiver:
    """A migration destination's wire receiver, written for this script in
    the reference's frame format and journal (``grit_tpu/agent/copy.py``,
    ``WireReceiver``): ``u32 header length | header JSON | payload``
    frames on any number of connections; a ``chunk`` frame's payload is
    checked against its crc32 (of the raw bytes, after the codec record's
    decode for a frame with ``"c"``) and written at its raw offset, and a
    waterline line ``{"file", "staged"}`` goes to the stage journal in
    ``dst`` whenever the contiguous prefix grows; ``eof`` waits for the
    waterline to reach its total and writes the ``done`` line. Any bad
    frame fails the session: a ``{"failed": msg}`` line, every connection
    closed. Planted faults: ``flip_frame`` flips a byte of that chunk
    frame's payload on arrival; ``close_after`` hangs up on every stream
    once that many payload bytes have arrived."""

    def __init__(self, dst: str, *, flip_frame: int | None = None,
                 close_after: int | None = None) -> None:
        import socket  # noqa: PLC0415
        import threading  # noqa: PLC0415

        from grit_tpu_torch.metadata import STAGE_JOURNAL_FILE  # noqa: PLC0415

        self.dst = dst
        os.makedirs(dst, exist_ok=True)
        self.journal = open(os.path.join(dst, STAGE_JOURNAL_FILE), "w")
        self.flip_frame, self.close_after = flip_frame, close_after
        self.srv = socket.socket()
        self.srv.bind(("127.0.0.1", 0))
        self.srv.listen(16)
        self.endpoint = f"127.0.0.1:{self.srv.getsockname()[1]}"
        self.error: str | None = None
        self.hung_up = False
        self.records = {"raw": 0, "compressed": 0, "zero": 0}
        self.wire_bytes = 0   # payload bytes received
        self.raw_bytes = 0    # raw bytes written
        self._fds: dict[str, int] = {}
        self._water: dict[str, int] = {}
        self._pending: dict[str, dict[int, int]] = {}
        self._frames = 0
        self._conns: list = []
        self._cond = threading.Condition()
        self._thread = threading.Thread(target=self._accept, daemon=True)
        self._thread.start()

    def _accept(self) -> None:
        import threading  # noqa: PLC0415

        while True:
            try:
                conn, _ = self.srv.accept()
            except OSError:
                return
            with self._cond:
                self._conns.append(conn)
            threading.Thread(target=self._serve, args=(conn,),
                             daemon=True).start()

    def _drop_all(self) -> None:
        """Hang up every stream (shutdown first: it wakes a thread blocked
        in ``recv`` and tells the sender at once). Holds ``_cond``."""
        import socket  # noqa: PLC0415

        for c in self._conns:
            try:
                c.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            c.close()

    @staticmethod
    def _exact(conn, n: int) -> bytearray:
        """``n`` bytes read straight into one buffer."""
        out = bytearray(n)
        view, got = memoryview(out), 0
        while got < n:
            k = conn.recv_into(view[got:])
            if not k:
                raise ConnectionError(f"peer closed mid-frame ({got}/{n} "
                                      "bytes)")
            got += k
        return out

    def _serve(self, conn) -> None:
        import struct  # noqa: PLC0415

        try:
            while self.error is None:
                head = conn.recv(4)
                if not head:
                    return
                if len(head) < 4:
                    head += self._exact(conn, 4 - len(head))
                (hlen,) = struct.unpack(">I", head)
                header = json.loads(self._exact(conn, hlen))
                payload = self._exact(conn, int(header.get("n", 0)))
                self._frame(header, payload)
        except (OSError, ValueError, KeyError, zlib.error) as exc:
            if not self.hung_up:
                self._fail(f"{type(exc).__name__}: {exc}")

    def _frame(self, header: dict, payload: bytearray) -> None:
        kind = header.get("t")
        if kind == "eof":
            self._eof(header["rel"], int(header["total"]))
            return
        if kind != "chunk":
            raise ValueError(f"unexpected frame {header}")
        with self._cond:
            self._frames += 1
            k = self._frames
            self.wire_bytes += len(payload)
            if self.close_after is not None and \
                    self.wire_bytes > self.close_after and not self.hung_up:
                self.hung_up = True
                self._drop_all()
                return
        if k == self.flip_frame and payload:
            payload[0] ^= 0x01
        codec = header.get("c")
        if codec is None:
            raw = payload
        elif codec == "zero":
            raw = bytes(int(header["rn"]))
        elif codec == "zlib":
            raw = zlib.decompress(payload)
        else:
            raise ValueError(f"codec {codec!r} is not this receiver's")
        if len(raw) != int(header.get("rn", len(payload))) or \
                zlib.crc32(raw) != int(header["crc"]):
            raise ValueError(f"frame crc mismatch at {header['rel']}@"
                             f"{header['off']} ({len(payload)} bytes)")
        rel, off = header["rel"], int(header["off"])
        with self._cond:
            fd = self._fds.get(rel)
            if fd is None:
                path = os.path.join(self.dst, rel)
                os.makedirs(os.path.dirname(path), exist_ok=True)
                fd = self._fds[rel] = os.open(path, os.O_RDWR | os.O_CREAT)
        # Streams write apart; eof closes the file only once the waterline,
        # moved after each write, has passed every byte.
        os.pwrite(fd, raw, off)
        with self._cond:
            self.raw_bytes += len(raw)
            self.records["raw" if codec in (None, "none") else
                         "zero" if codec == "zero" else "compressed"] += 1
            pend = self._pending.setdefault(rel, {})
            pend[off] = len(raw)
            water = self._water.get(rel, 0)
            while water in pend:
                water += pend.pop(water)
            if water != self._water.get(rel, 0):
                self._water[rel] = water
                self.journal.write(json.dumps({"file": rel, "staged": water})
                                   + "\n")
                self.journal.flush()
            self._cond.notify_all()

    def _eof(self, rel: str, total: int) -> None:
        deadline = time.monotonic() + 300
        with self._cond:
            while self._water.get(rel, 0) < total and self.error is None:
                if time.monotonic() > deadline:
                    raise ValueError(f"{rel} ended short "
                                     f"({self._water.get(rel, 0)}/{total})")
                self._cond.wait(1.0)
            if self.error is None:
                os.close(self._fds.pop(rel))
                self.journal.write(json.dumps(
                    {"file": rel, "staged": total, "done": True}) + "\n")
                self.journal.flush()

    def _fail(self, msg: str) -> None:
        with self._cond:
            if self.error is not None:
                return
            self.error = msg
            self.journal.write(json.dumps({"failed": msg}) + "\n")
            self.journal.flush()
            self._drop_all()
            self._cond.notify_all()

    def stage_file(self, src: str, rel: str) -> None:
        """A whole file of the tree, as the agent ships the rest after the
        dump."""
        os.makedirs(os.path.dirname(os.path.join(self.dst, rel)), exist_ok=True)
        shutil.copyfile(src, os.path.join(self.dst, rel))
        with self._cond:
            self.journal.write(json.dumps(
                {"file": rel, "staged": os.path.getsize(src), "done": True})
                + "\n")
            self.journal.flush()

    def complete(self) -> None:
        with self._cond:
            self.journal.write(json.dumps({"complete": True}) + "\n")
            self.journal.flush()

    def close(self) -> None:
        import socket  # noqa: PLC0415

        try:
            self.srv.shutdown(socket.SHUT_RDWR)  # wakes the accept thread
        except OSError:
            pass
        self.srv.close()
        with self._cond:
            self._drop_all()
            for fd in self._fds.values():
                os.close(fd)
            self._fds.clear()
        self.journal.close()


def precopy_source(work: str) -> tuple:
    """Phase 8's source spawned, not yet waited for: ``(source, socket
    dir)``."""
    socks, env = precopy_env(work)
    return Workload(1000, env, args=PRECOPY_ARGS), socks


def frozen_source(work: str) -> tuple:
    """Phase 9's source spawned, not yet waited for: ``(source, socket
    dir)``."""
    socks, env, args = frozen_env(work)
    return Workload(10 ** 6, env, args=args), socks


def spawn_wire_sources(work: str, runs: tuple) -> dict:
    """The sources of the :func:`wire_run` ``runs`` (``(label, codec)``
    pairs) spawned, not yet waited for: each is phase 5's flagship at
    :data:`WIRE_LAYERS` layers under ``GRIT_SNAPSHOT_CODEC=codec``.
    Returns ``{label: (source, environment, socket dir)}``."""
    args = WORKLOAD_ARGS[:]
    args[args.index("--layers") + 1] = str(WIRE_LAYERS)
    started = {}
    for label, codec in runs:
        socks = os.path.join(work, f"socks-wire-{label}")
        os.makedirs(socks)
        env = {"GRIT_TPU_SOCKET_DIR": socks, "GRIT_SNAPSHOT_CODEC": codec}
        started[label] = (Workload(1000, env, args=args), env, socks)
    return started


def park_all(started: dict) -> dict:
    """Each spawned ``{key: (source, socket dir)}`` parked at its first
    checkpoint point as soon as it is ready, each on a thread of its own
    (one parked after another would leave the later ones stepping past
    the steps their phases cut at): ``{key: (source, its ToggleClient)}``.
    Any failure kills them all."""
    from concurrent.futures import ThreadPoolExecutor, as_completed  # noqa: PLC0415

    from grit_tpu_torch.device.agentlet import ToggleClient  # noqa: PLC0415

    def park(src, socks):
        src.wait_for("READY")
        client = ToggleClient(src.proc.pid, path=os.path.join(
            socks, f"grit-tpu-{src.proc.pid}.sock"), timeout=600)
        client.quiesce()
        return src, client

    pool = ThreadPoolExecutor(len(started))
    try:
        futures = {key: pool.submit(park, *v) for key, v in started.items()}
        for f in as_completed(futures.values()):
            f.result()  # the first failure, whichever source it is, raises
        return {key: f.result() for key, f in futures.items()}
    except BaseException:
        # Killed before the pool is let go: the other threads' waits end
        # with their sources, not at their own timeouts.
        for src, _socks in started.values():
            src.kill()
        raise
    finally:
        pool.shutdown(wait=False, cancel_futures=True)


def early_sources(work: str) -> dict:
    """Phases 8, 9 and 10's sources spawned together, so that their four
    process starts overlap (untimed: each phase's measures begin after
    its source has resumed), each parked at its first checkpoint point
    until its phase resumes it: ``{"precopy": (source, client),
    "frozen": (source, client), "wire": {label: (source, client, env)}}``.
    Parked, they hold their device memory and take no host time."""
    spawned = {}
    try:
        spawned["precopy"] = precopy_source(work)
        spawned["frozen"] = frozen_source(work)
        wire = spawn_wire_sources(work, WIRE_RUNS)
        for label, (src, _env, wsocks) in wire.items():
            spawned[f"wire {label}"] = (src, wsocks)
    except BaseException:
        for src, _socks in spawned.values():
            src.kill()
        raise
    parked = park_all(spawned)
    return {"precopy": parked["precopy"], "frozen": parked["frozen"],
            "wire": {label: (*parked[f"wire {label}"], wire[label][1])
                     for label in wire}}


def wire_run(work: str, card: str, label: str, codec: str, *,
             hang_up_check: bool, source: tuple) -> dict:
    """One wire migration of phase 5's flagship (Adam) at
    :data:`WIRE_LAYERS` layers: the source quiesced and dumped with a
    wire spec and a PVC mirror under ``GRIT_SNAPSHOT_CODEC=codec``, the
    rest of the tree staged as the agent ships it, then a destination
    spawned on the landed tree; its losses after the cut against the
    source's own run, resumed after the dump to the same last step. With
    a codec, a second destination restores from the mirror (a container
    on the PVC), spawned once the first has taken its first step.
    ``hang_up_check``: before the source resumes, a second dump of its
    parked state into a receiver that hangs up mid-stream must answer
    ``ok`` with a failed wire block and a committed mirror. ``source``:
    its parked source (:func:`spawn_wire_sources`, :func:`park_all`), the
    source's client and its environment."""
    from grit_tpu_torch.device.snapshot import (  # noqa: PLC0415
        DATA_FILE, INDEX_FILE, MANIFEST_FILE, snapshot_exists, snapshot_nbytes)

    host, pvc, dst_root = (os.path.join(work, f"{n}-wire-{label}")
                           for n in ("host", "pvc", "dst"))
    snap, mirror = os.path.join(host, "hbm"), os.path.join(pvc, "hbm")
    procs: list[Workload] = []
    out: dict = {"codec": codec}
    src, client, env = source
    procs.append(src)
    args = src.args
    recv = Receiver(dst_root)
    try:
        client.resume()
        src.wait_for(rf"STEP {MIGRATE_CUT} ")
        t_quiesce = time.perf_counter()
        cut = client.quiesce()
        t_dump = time.perf_counter()
        resp = client.dump(snap, mirror=mirror, wire={
            "endpoint": recv.endpoint, "prefix": "hbm",
            "streams": WIRE_STREAMS})
        t_dumped = time.perf_counter()
        for name in (INDEX_FILE, MANIFEST_FILE, "COMMIT"):
            recv.stage_file(os.path.join(snap, name), f"hbm/{name}")
        recv.complete()
        # The restored container is created once the tree has landed (the
        # shim injects the restore env only for a committed snapshot).
        dst = Workload(MIGRATE_STEPS, {
            **env, "GRIT_TPU_RESTORE_DIR": os.path.join(dst_root, "hbm")},
            args=args)
        procs.append(dst)
        restored = int(dst.wait_for(r"RESTORED (\d+)").group(1))
        t_restored = time.perf_counter()
        restore_s = float(dst.wait_for(r"RESTORE_SECONDS (\S+)").group(1))
        pipe = json.loads(dst.wait_for(r"RESTORE_PIPELINE (.+)").group(1))
        init_s = float(dst.wait_for(r"INIT_SECONDS (\S+)").group(1))
        dst.wait_for(r"STEP \d+ ")
        t_first = time.perf_counter()
        mdst = None
        if codec != "none":  # the mirror's destination, beside the first
            mdst = Workload(MIGRATE_STEPS, {**env,
                                            "GRIT_TPU_RESTORE_DIR": mirror},
                            args=args)
            procs.append(mdst)
        dst.finish()
        if hang_up_check:
            hang = Receiver(os.path.join(work, f"hang-{label}"),
                            close_after=min(64 << 20, snapshot_nbytes(snap) // 8))
            hang_mirror = os.path.join(work, f"pvc-hang-{label}", "hbm")
            try:
                hung = client.dump(os.path.join(host, "hang", "hbm"),
                                   mirror=hang_mirror, wire={
                                       "endpoint": hang.endpoint,
                                       "prefix": "hbm",
                                       "streams": WIRE_STREAMS})
            finally:
                hang.close()
                shutil.rmtree(hang.dst, ignore_errors=True)
            if not hang.hung_up or hung["wire"].get("ok") is not False \
                    or not snapshot_exists(hang_mirror):
                raise AssertionError(f"a receiver that hung up mid-stream: "
                                     f"response {hung.get('wire')}, mirror "
                                     f"committed {snapshot_exists(hang_mirror)}")
            out["hang_up"] = {"wire": hung["wire"],
                              "received_bytes": hang.wire_bytes}
            shutil.rmtree(os.path.dirname(hang_mirror), ignore_errors=True)
        # The source's own run, resumed after the dump, is the
        # uninterrupted one (its loop only paused).
        src.drain()
        client.resume()
        deadline = time.monotonic() + 300
        while MIGRATE_STEPS not in src.losses():
            if time.monotonic() > deadline or src.proc.poll() is not None:
                raise AssertionError(f"{label}: the resumed source did "
                                     f"not reach step {MIGRATE_STEPS}")
            time.sleep(0.2)
        ref_losses = src.losses()
        client.close()
        src.kill()
        nbytes = snapshot_nbytes(snap)
        mirror_files = os.listdir(mirror)
        if mdst is not None:
            m_restored = int(mdst.wait_for(r"RESTORED (\d+)").group(1))
            m_restore_s = float(mdst.wait_for(r"RESTORE_SECONDS (\S+)").group(1))
            mdst.finish()
            out["mirror_restore"] = {"restored": m_restored,
                                     "restore_s": m_restore_s,
                                     "losses": mdst.losses(),
                                     "launches": mdst.kernels()["launches"]}
    finally:
        for p in procs:
            p.kill()
        recv.close()
        for d in (host, pvc, dst_root):
            shutil.rmtree(d, ignore_errors=True)

    wire = resp.get("wire", {})
    want = {s: x for s, x in ref_losses.items() if cut < s <= MIGRATE_STEPS}
    if recv.error is not None or not wire.get("ok"):
        raise AssertionError(f"{label}: the wire failed: response {wire}, "
                             f"receiver {recv.error}")
    if wire["files"] != {f"hbm/{DATA_FILE}": nbytes} or \
            recv.raw_bytes != nbytes:
        raise AssertionError(f"{label}: streamed {wire['files']}, received "
                             f"{recv.raw_bytes} raw bytes of {nbytes}")
    if not pipe["streamed"]:
        raise AssertionError(f"{label}: the restore did not read the stage "
                             f"journal: {pipe}")
    got = dst.losses()
    if restored != cut or not want or got != want:
        raise AssertionError(f"{label}: restored step {restored} (cut {cut}); "
                             f"losses after the cut {got}, uninterrupted "
                             f"{want}")
    launches = dst.kernels()["launches"]
    if codec == "none":
        if recv.records["compressed"] or recv.wire_bytes != nbytes:
            raise AssertionError(f"{label}: a raw wire carried "
                                 f"{recv.records}, {recv.wire_bytes} bytes")
    else:
        side = DATA_FILE + ".gritc"
        m = out["mirror_restore"]
        if side not in mirror_files or not recv.records["compressed"]:
            raise AssertionError(f"{label}: mirror files {mirror_files}, "
                                 f"records {recv.records}")
        if m["restored"] != cut or m["losses"] != want:
            raise AssertionError(f"{label}: the mirror's destination restored "
                                 f"{m['restored']} (cut {cut}) with losses "
                                 f"{m['losses']}, uninterrupted {want}")
        launches = {n: launches[n] + m["launches"][n] for n in KERNELS}
    if not all(launches[n] > 0 for n in KERNELS):
        raise AssertionError(f"{label}: a kernel never launched: {launches}")
    dump_s = t_dumped - t_dump
    legs = resp["legs"]
    out.update(cut=cut, bytes=nbytes, wire=wire, records=dict(recv.records),
               wire_payload_bytes=recv.wire_bytes, dump_s=dump_s,
               quiesce_s=t_dump - t_quiesce, restore_s=restore_s,
               init_s=init_s, stage_and_spawn_s=dst.started - t_dumped,
               spawn_to_restored_s=t_restored - dst.started,
               first_step_s=t_first - t_restored,
               blackout_s=t_first - t_quiesce, dump_legs=legs,
               restore_legs=pipe, launches=launches)
    log("wire", f"{label}: cut at step {cut}; {nbytes} raw bytes streamed "
                f"over {WIRE_STREAMS} streams as {recv.wire_bytes} payload "
                f"bytes ({sum(recv.records.values())} records: "
                f"{recv.records['compressed']} compressed, "
                f"{recv.records['raw']} raw, {recv.records['zero']} zero); "
                f"sender: sent_bytes {wire['sent_bytes']}, send_s "
                f"{wire['send_s']}, stall_s {wire['stall_s']}, "
                f"dump_overlap_bytes {wire['dump_overlap_bytes']} [{card}]")
    log("wire", f"{label}: dump {dump_s:.3f} s = {nbytes / dump_s / 1e9:.3f} "
                f"GB/s (codec {legs.get('codec')}, mirror "
                f"{legs.get('mirror_bytes')} B, committed "
                f"{legs.get('mirror')}, writer blocked on the codec "
                f"{legs.get('codec_wait', 0.0):.3f} s; legs "
                f"{fmt_legs(legs, DUMP_LEGS)}); blackout (quiesce → first "
                f"post-restore step) {t_first - t_quiesce:.3f} s = quiesce "
                f"{t_dump - t_quiesce:.4f} + dump {dump_s:.3f} + metadata "
                f"staged and spawn {dst.started - t_dumped:.3f} + spawn → "
                f"RESTORED {t_restored - dst.started:.3f} (set-up "
                f"{init_s:.3f}, restore {restore_s:.3f} = "
                f"{nbytes / restore_s / 1e9:.3f} GB/s, legs "
                f"{fmt_legs(pipe, RESTORE_LEGS)}) + first step "
                f"{t_first - t_restored:.3f} [{card}]")
    msg = (f"{label} ({WIRE_LAYERS} layers): losses after the cut bitwise "
           f"equal to the resumed source's uninterrupted run: {got}")
    if "mirror_restore" in out:
        msg += (f"; the mirror ({side} beside the container) restored "
                f"on the card in {out['mirror_restore']['restore_s']:.3f} s, "
                f"losses bitwise equal too")
    if "hang_up" in out:
        msg += (f"; a receiver that hung up after "
                f"{out['hang_up']['received_bytes']} bytes: dump ok, wire "
                f"{out['hang_up']['wire']}, mirror committed")
    log("wire", msg + f" [{card}]")
    return out


def planted_flip(torch, work: str, card: str, dev) -> str:
    """A byte flipped in one frame on its way: the receiver must fail the
    stream loudly (a journal ``failed`` line naming the crc) while the
    dump, of tensors on the card through its pinned ring, commits."""
    from grit_tpu_torch.device.snapshot import write_snapshot  # noqa: PLC0415
    from grit_tpu_torch.wire import WireDumpSink, WireSender  # noqa: PLC0415

    recv = Receiver(os.path.join(work, "flip-dst"), flip_frame=2)
    gen = torch.Generator(device=dev).manual_seed(1)
    state = {"w": torch.randn(6 << 20, device=dev, generator=gen)}  # 24 MiB
    try:
        sender = WireSender(recv.endpoint, streams=WIRE_STREAMS)
        sink = WireDumpSink(sender, "hbm/data-h0000.bin")
        try:
            write_snapshot(os.path.join(work, "flip-src"), state, wire=sink)
        finally:
            sender.close()
    finally:
        recv.close()
    with open(os.path.join(work, "flip-dst", ".grit-stage-journal")) as f:
        journal = f.read()
    if recv.error is None or "crc" not in recv.error \
            or '"failed"' not in journal:
        raise AssertionError(f"a flipped byte was not refused: receiver "
                             f"{recv.error}, journal {journal[-300:]}")
    log("wire", f"planted fault: a byte flipped in frame 2 failed the stream "
                f"({recv.error}); the sender's wire ok {sink.ok} "
                f"({sink.error}) [{card}]")
    return recv.error


def phase_wire(torch, work: str, card: str, sources: dict,
               dev=None) -> dict:
    """Phase 10: the wire migration of phase 5's flagship at
    :data:`WIRE_LAYERS` layers, raw (the default codec) and then
    compressed (zlib, with the receiver that hangs up), and the planted
    faults (``dev``: the card by default; a rehearsal on the CPU passes
    the CPU). ``sources``: :func:`early_sources`' ``"wire"``: both
    sources started together and parked at their first step until their
    run comes."""
    try:
        runs = {"raw": wire_run(work, card, "raw", "none",
                                hang_up_check=False, source=sources["raw"]),
                "zlib": wire_run(work, card, "zlib", "zlib",
                                 hang_up_check=True, source=sources["zlib"])}
    finally:
        for src, _client, _env in sources.values():
            src.kill()
    runs["flip"] = planted_flip(torch, work, card,
                                dev if dev is not None else torch.device("cuda", 0))
    runs["launches"] = {n: runs["raw"]["launches"][n]
                        + runs["zlib"]["launches"][n] for n in KERNELS}
    return runs


# -- phases 11-13 --------------------------------------------------------------

# Phase 11: the JAX package's example workload (examples/workload.py, the
# north star's fine-tune): Llama-2-7B at full width, f32 params and bf16
# activations, LoRA rank 16 on wq and wv, S 2048, batch 8, with remat.
LORA_ARGS = ["--model", "lora", "--remat", "--seq", "2048", "--batch", "8"]
LORA_TOKENS = 8 * 2048
LORA_LAYERS = 32
LORA_STEPS = 6        # the uninterrupted run and the restored run end here
LORA_CUT = 3
NORTH_STAR_BLACKOUT_S = 60.0
# Phase 12: the same trainer cut to 4 layers at batch 2, remat off and on.
REMAT_LAYERS = 4
REMAT_BATCH = 2
# Phase 13: bench.py's MoE model (bench_moe: dim 1024, 12 layers, 8 heads
# of 128, hidden 3584, 8 experts, top-2, bf16) at its batch 16 x seq 512.
MOE_ARGS = ["--model", "moe", "--seq", "512", "--batch", "16"]
MOE_LAYERS = 12
MOE_BATCH, MOE_SEQ = 16, 512
MOE_STEPS = 8
MOE_CUT = 3
MOE_FWD_ITERS = 3     # bench.py's forward throughput iterations


def step_seconds(w: Workload) -> list[float]:
    """Host-clock seconds between consecutive ``STEP`` lines of ``w`` (a
    step prints after its loss's readback, which waits for its work)."""
    t = [w.times[i] for i, line in enumerate(w.lines) if line.startswith("STEP ")]
    return [b - a for a, b in zip(t, t[1:])]


def migrate_model(work: str, card: str, label: str, args: list[str], *,
                  n_steps: int, cut: int, layers: int, tokens: int,
                  want_per_step: dict, beside: bool = False) -> dict:
    """An uninterrupted run of ``n_steps`` of the workload ``args``, then a
    run quiesced after step ``cut`` through its agentlet, dumped, killed,
    and a fresh process restored from the snapshot that continues to
    ``n_steps``: its losses must equal the uninterrupted run's bit for
    bit, and each kernel's launches a step in the uninterrupted run must
    be ``want_per_step``. ``tokens``: a step's tokens. Returns the numbers
    phases 11 and 13 print.

    ``beside`` (a model of which two fit on the card at once): the
    uninterrupted run starts beside the source
    (:func:`start_beside_reference`), and the step times are the
    destination's, which has the card to itself; otherwise they are the
    uninterrupted run's, which runs alone before the source starts."""
    from grit_tpu_torch.device.agentlet import ToggleClient  # noqa: PLC0415
    from grit_tpu_torch.device.snapshot import snapshot_nbytes  # noqa: PLC0415

    socks = os.path.join(work, f"socks-{label}")
    snap = os.path.join(work, f"ckpt-{label}", "hbm")
    os.makedirs(socks)
    env = {"GRIT_TPU_SOCKET_DIR": socks}
    procs: list[Workload] = []
    try:
        if beside:
            ref, src, client = start_beside_reference(n_steps, env, socks,
                                                      procs, args=args)
        else:
            ref = Workload(n_steps, env, args=args)
            procs.append(ref)
            ref.finish()
            src = Workload(1000, env, args=args)
            procs.append(src)
            src.wait_for("READY")
            client = ToggleClient(src.proc.pid, path=os.path.join(
                socks, f"grit-tpu-{src.proc.pid}.sock"))
        ref_losses = ref.losses()
        launches = ref.kernels()["launches"]
        m = ref.find(r"MEMORY (\d+)")  # printed on the card only
        peak = int(m.group(1)) if m else None
        src.wait_for(rf"STEP {cut} ")
        t_quiesce = time.perf_counter()
        got_cut = client.quiesce()
        t_dump = time.perf_counter()
        client.dump(snap)
        t_dumped = time.perf_counter()
        client.close()
        src.kill()
        nbytes = snapshot_nbytes(snap)

        dst = Workload(n_steps, {**env, "GRIT_TPU_RESTORE_DIR": snap}, args=args)
        procs.append(dst)
        restored = int(dst.wait_for(r"RESTORED (\d+)").group(1))
        t_restored = time.perf_counter()
        restore_s = float(dst.wait_for(r"RESTORE_SECONDS (\S+)").group(1))
        base_s = 0.0
        while True:
            line = dst.readline()
            m = re.match(r"(BASE|INIT)_SECONDS (\S+)", line)
            if m and m.group(1) == "BASE":
                base_s = float(m.group(2))
            elif m:
                init_s = float(m.group(2))
                break
        dst.wait_for("READY")
        t_ready = time.perf_counter()
        dst.wait_for(r"STEP \d+ ")
        t_first = time.perf_counter()
        dst.finish()
        steps_s = step_seconds(dst if beside else ref)
    finally:
        for p in procs:
            p.kill()
        shutil.rmtree(os.path.dirname(snap), ignore_errors=True)
    if restored != got_cut:
        raise AssertionError(f"{label}: restored step {restored}, quiesced "
                             f"at {got_cut}")
    want = {s: x for s, x in ref_losses.items() if s > got_cut}
    got = dst.losses()
    if got != want or not want:
        raise AssertionError(f"{label}: losses after the cut differ from the "
                             f"uninterrupted run: {got} vs {want}")
    if not all(math.isfinite(x) for x in ref_losses.values()):
        raise AssertionError(f"{label}: non-finite loss {ref_losses}")
    per_step = {n: launches[n] / n_steps for n in KERNELS}
    if per_step != want_per_step:
        raise AssertionError(f"{label}: launches a step {per_step}, want "
                             f"{want_per_step}")
    steady = median_after_first(steps_s)
    start_s = t_restored - dst.started - init_s - restore_s
    blackout = t_first - t_quiesce
    log(label, f"cut at step {got_cut}; losses after the cut bitwise equal to "
               f"the uninterrupted run: {got}")
    log(label, f"{layers} layers; step seconds "
               f"({'the destination' if beside else 'the uninterrupted run'}"
               f") {[round(x, 4) for x in steps_s]}; median after the "
               f"first {steady:.4f} s = "
               f"{tokens / steady:.0f} tokens/s; max_memory_allocated "
               f"{peak} B; launches a step "
               f"{per_step} [{card}]")
    log(label, f"snapshot {nbytes} bytes; quiesce {t_dump - t_quiesce:.4f} s; "
               f"dump {t_dumped - t_dump:.3f} s; blackout (quiesce → first "
               f"post-restore step) {blackout:.3f} s = kill + spawn "
               f"{dst.started - t_dumped:.3f} + process start (interpreter "
               f"and imports) {start_s:.3f} + base rebuild {base_s:.3f} + "
               f"other set-up {init_s - base_s:.3f} + restore {restore_s:.3f} "
               f"+ RESTORED → READY {t_ready - t_restored:.3f} + first step "
               f"{t_first - t_ready:.3f} [{card}]")
    return {"cut": got_cut, "losses": ref_losses, "step_s": steady,
            "steps_s": steps_s, "tokens_per_s": tokens / steady,
            "max_memory_allocated": peak, "snapshot_bytes": nbytes,
            "launches": launches, "launches_per_step": per_step,
            "quiesce_s": t_dump - t_quiesce, "dump_s": t_dumped - t_dump,
            "blackout_s": blackout, "blackout_split_s": {
                "kill_spawn": dst.started - t_dumped, "process_start": start_s,
                "base_rebuild": base_s, "other_setup": init_s - base_s,
                "restore": restore_s, "restored_to_ready": t_ready - t_restored,
                "first_step": t_first - t_ready}}


def phase_lora(work: str, card: str) -> dict:
    """Phase 11: the north star's fine-tune, migrated; its blackout read
    against the north star's limit."""
    out = migrate_model(work, card, "lora", LORA_ARGS, n_steps=LORA_STEPS,
                        cut=LORA_CUT, layers=LORA_LAYERS,
                        tokens=LORA_TOKENS, want_per_step={
                            "flash_fwd": 2 * LORA_LAYERS,
                            "flash_bwd_dq": LORA_LAYERS,
                            "flash_bwd_dkv": LORA_LAYERS})
    log("lora", f"blackout {out['blackout_s']:.3f} s against the north "
                f"star's {NORTH_STAR_BLACKOUT_S:.0f} s: "
                f"{'within' if out['blackout_s'] < NORTH_STAR_BLACKOUT_S else 'OVER'}"
                f" [{card}]")
    return out


def phase_remat(torch, fa, card: str) -> dict:
    """Phase 12: the LoRA trainer at Llama-2-7B widths cut to
    :data:`REMAT_LAYERS` layers, batch :data:`REMAT_BATCH`: one loss and
    the adapters' gradients with remat off, then on; both bitwise equal,
    the forward launched twice a layer under remat."""
    from dataclasses import replace  # noqa: PLC0415

    from grit_tpu_torch.models import llama, lora  # noqa: PLC0415
    from grit_tpu_torch.tree import flatten_with_names  # noqa: PLC0415
    from grit_tpu_torch.workload import lora_base  # noqa: PLC0415

    cfg = replace(llama.LlamaConfig.llama2_7b(), n_layers=REMAT_LAYERS)
    lcfg = lora.LoraConfig(rank=16)
    gen = torch.Generator(device="cuda").manual_seed(11)
    base = lora_base(cfg, "cuda")
    ad = lora.init_lora(cfg, lcfg, gen, "cuda")
    for name in ("wq_b", "wv_b"):  # non-zero, so A's gradient is too
        ad["layers"]["attn"][name].normal_(generator=gen).mul_(0.01)
    leaves = [x.requires_grad_(True) for _, x in flatten_with_names(ad)]
    toks = torch.randint(0, cfg.vocab_size, (REMAT_BATCH, SEQ + 1),
                         device="cuda", generator=gen)
    runs = {}
    for remat in (False, True):
        rcfg = replace(cfg, remat=remat)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        fa.reset_launch_counts()
        t0 = time.perf_counter()
        loss = lora.lora_loss_fn(rcfg, lcfg, base, ad, toks[:, :-1],
                                 toks[:, 1:])
        grads = torch.autograd.grad(loss, leaves)
        torch.cuda.synchronize()
        runs[remat] = {"loss": loss.detach(), "grads": grads,
                       "seconds": time.perf_counter() - t0,
                       "launches": dict(fa.LAUNCHES),
                       "peak": torch.cuda.max_memory_allocated(),
                       "held": held}
        del loss
    off, on = runs[False], runs[True]
    same = torch.equal(off["loss"], on["loss"]) and all(
        torch.equal(a, b) for a, b in zip(off["grads"], on["grads"]))
    log("remat", f"{REMAT_LAYERS} layers, B {REMAT_BATCH} S {SEQ}, LoRA rank "
                 f"16: loss {off['loss'].item()!r} (off) {on['loss'].item()!r} "
                 f"(on); loss and {len(leaves)} adapter gradients bitwise "
                 f"equal: {same}")
    log("remat", f"max_memory_allocated off {off['peak']} B, on {on['peak']} "
                 f"B; above the base and adapters held ({off['held']} B): off "
                 f"{off['peak'] - off['held']} B, on {on['peak'] - on['held']}"
                 f" B; seconds off {off['seconds']:.4f}, on "
                 f"{on['seconds']:.4f} (first calls); launches off "
                 f"{off['launches']}, on {on['launches']} [{card}]")
    if not same:
        raise AssertionError("remat changed the loss or a gradient")
    want = {"flash_fwd": REMAT_LAYERS, "flash_bwd_dq": REMAT_LAYERS,
            "flash_bwd_dkv": REMAT_LAYERS}
    if off["launches"] != want or on["launches"] != {
            **want, "flash_fwd": 2 * REMAT_LAYERS}:
        raise AssertionError(f"remat launches {off['launches']} (off), "
                             f"{on['launches']} (on)")
    if not on["peak"] < off["peak"]:
        raise AssertionError("remat did not lower the peak memory")
    launches = {n: off["launches"][n] + on["launches"][n] for n in KERNELS}
    del runs
    # Where a LoRA step's device time goes (remat on), by operator; its
    # launches are not counted.
    rcfg = replace(cfg, remat=True)
    prof = profile_ops(torch, lambda: torch.autograd.grad(lora.lora_loss_fn(
        rcfg, lcfg, base, ad, toks[:, :-1], toks[:, 1:]), leaves), 1)
    log("remat", f"profile of one remat step: wall {prof['wall_ms']:.2f} ms, "
                 f"device busy {prof['device_ms']:.2f} ms; top operators "
                 f"(ms) {[(k, round(ms, 3)) for k, ms in prof['top']]} "
                 f"[{card}]")
    del base, ad, leaves
    torch.cuda.empty_cache()
    return {"peak_off": off["peak"], "peak_on": on["peak"],
            "held": off["held"], "launches": launches,
            "loss": off["loss"].item(), "profile": prof}


def moe_forward_throughput(torch, card: str) -> dict:
    """``bench.py``'s MoE measure: forward tokens/s of the model at batch
    16 x seq 512 (no gradient), CUDA events around
    :data:`MOE_FWD_ITERS` forwards after one warm-up."""
    from grit_tpu_torch.models import moe_llama  # noqa: PLC0415
    from grit_tpu_torch.tree import flatten_with_names  # noqa: PLC0415

    cfg = moe_llama.MoeLlamaConfig.bench()
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = moe_llama.init_params(cfg, gen, "cuda")
    n_params = sum(x.numel() for _, x in flatten_with_names(params))
    toks = torch.randint(0, cfg.vocab_size, (MOE_BATCH, MOE_SEQ),
                         device="cuda", generator=gen)
    with torch.no_grad():
        ms = cuda_ms(torch, lambda: moe_llama.forward(cfg, params, toks),
                     iters=MOE_FWD_ITERS, warmup=1)
        logits = moe_llama.forward(cfg, params, toks)
        prof = profile_ops(torch, lambda: moe_llama.forward(cfg, params, toks),
                           1)
    if not bool(torch.isfinite(logits).all()):
        raise AssertionError("non-finite MoE logits")
    tps = MOE_BATCH * MOE_SEQ / (ms / 1e3)
    log("moe", f"{n_params / 1e9:.3f} B params; forward {ms:.3f} ms at B "
               f"{MOE_BATCH} S {MOE_SEQ} = {tps:.0f} tokens/s (bench.py's "
               f"moe_tokens_per_s measure) [{card}]")
    log("moe", f"profile of one forward: wall {prof['wall_ms']:.2f} ms, "
               f"device busy {prof['device_ms']:.2f} ms; top operators (ms) "
               f"{[(k, round(x, 3)) for k, x in prof['top']]} [{card}]")
    del params, logits
    torch.cuda.empty_cache()
    return {"params": n_params, "forward_ms": ms, "forward_tokens_per_s": tps,
            "forward_profile": prof}


def phase_moe(torch, fa, work: str, card: str) -> dict:
    """Phase 13: bench.py's MoE model, its forward throughput, then
    trained and migrated as phase 11 is."""
    fwd = moe_forward_throughput(torch, card)
    out = migrate_model(work, card, "moe", MOE_ARGS, n_steps=MOE_STEPS,
                        cut=MOE_CUT, layers=MOE_LAYERS,
                        tokens=MOE_BATCH * MOE_SEQ,
                        want_per_step={n: MOE_LAYERS for n in KERNELS},
                        beside=True)
    return {**out, **fwd}


# -- phases 14-16 --------------------------------------------------------------

# Phase 14: bench.py's MoE model served by a continuous-batching engine of
# 4 slots of 1024 positions (its max_seq_len), prompts that fit them with
# the rounds the phase decodes, migrated as phase 6 migrates the flagship.
MOE_SERVE_MAX_LEN = 1024
MOE_SERVE_PROMPTS = (700, 500, 230, 40)  # the 1024, 1024, 256 and 64 buckets
MOE_SERVE_SWAP = (12, 3, 300)  # after round 12, slot 3 leaves; 300 join
MOE_PREFILL = (230, 256)  # the masked-prefill check: prompt tokens, bucket
# Phases 15 and 16: four ranks on the one card over LOCAL_GLOO (a hop
# goes between the ranks' device buffers), started once for both phases.
N_RANKS = 4
SP_SEQ = 8192             # phase 15: batch 1 at S 8192, 2048 positions a rank
SP_LAYERS = 4             # phase 15's depth (13 until PR 12)
PP_LAYERS = 12            # phase 16: the flagship widths at 12 layers (13
PP_BATCH = 8              # does not divide by 4 stages), B 8 x S 2048 in
PP_MICRO = 4              # 4 microbatches; the MoE model at its B 16 x S 512
MOE_PP_BATCH, MOE_PP_SEQ = 16, 512
# Bounds of the parallel phases against their dense runs, all in bf16: a
# logit's error against the dense model's largest logit, and each
# gradient leaf's relative L2 error against the dense gradient's.
PAR_LOGIT_BOUND = 2 ** -5
PAR_GRAD_BOUND = 2 ** -4
# Phase 16's pp × ep leg: the MoE model on (pipe 2, expert 2), the four
# ranks; 6 layers a stage and 4 experts a rank at the bench MoE's depth.
PP_EP = (2, 2)


def moe_masked_prefill(torch, card: str, *, seed: int, cfg=None,
                       device: str = "cuda") -> dict:
    """A bucket-padded MoE prefill with its pads masked out of the routing
    (the engine's prefill call) against the unpadded prompt: the next
    token's logits, at non-binding capacity (``capacity_factor`` =
    ``n_experts``: a capacity is a share of the call's rows, pads
    included, so at a tight one the two calls may drop differently). The
    padded prefill at the default capacity, unmasked against masked (the
    pads' competition for capacity alone), is printed beside it."""
    from dataclasses import replace  # noqa: PLC0415

    from grit_tpu_torch.models import moe_llama  # noqa: PLC0415

    cfg = cfg or moe_llama.MoeLlamaConfig.bench()
    loose = replace(cfg, capacity_factor=float(cfg.n_experts))
    dev = torch.device(device)
    n, bucket = MOE_PREFILL
    params = moe_llama.init_params(
        cfg, torch.Generator(device=dev).manual_seed(seed), dev)
    prompt = zipf_tokens(torch, n, cfg.vocab_size,
                         torch.Generator().manual_seed(seed + 2)).to(dev)[None]
    padded = torch.zeros((1, bucket), dtype=torch.int32, device=dev)
    padded[0, :n] = prompt[0]
    mask = torch.arange(bucket, device=dev) < n

    def next_logits(c, toks, token_mask):
        cache = moe_llama.init_kv_cache(c, 1, bucket, device=dev)
        logits, _ = moe_llama.decode(c, params, toks, cache,
                                     token_mask=token_mask)
        return logits[0, n - 1]

    plain = next_logits(loose, prompt, None)
    err, scale = max_err(next_logits(loose, padded, mask), plain)
    unmasked, _ = max_err(next_logits(cfg, padded, None),
                          next_logits(cfg, padded, mask))
    bound = 2 ** -6 * scale
    log("moe_serve", f"masked prefill ({n} tokens in the {bucket} bucket, "
                     f"capacity_factor {loose.capacity_factor}): next-token "
                     f"logits against the unpadded prompt's max |err| {err:.5f}"
                     f", bound {bound:.5f} (2^-6 of their largest "
                     f"{scale:.3f}); at capacity_factor "
                     f"{cfg.capacity_factor} the pads unmasked move them by "
                     f"{unmasked:.5f} [{card}]")
    if not err <= bound:
        raise AssertionError(f"the masked prefill's logits differ from the "
                             f"unpadded prompt's by {err} > {bound}")
    del params
    return {"max_abs_err": err, "bound": bound,
            "unmasked_tight_moves": unmasked}


def phase_moe_serving(torch, fa, work: str, card: str, *, seed: int,
                      cfg=None, device: str = "cuda") -> dict:
    """Phase 14: ``bench.py``'s MoE model served, migrated mid-generation
    and fanned out as phase 6 serves the flagship (both engines dispatch
    on the config), then the masked prefill. Its attention is the plain
    one: no flash kernel launches."""
    from grit_tpu_torch.models import moe_llama  # noqa: PLC0415

    cfg = cfg or moe_llama.MoeLlamaConfig.bench()
    out = phase_serving(torch, fa, work, card, seed=seed, cfg=cfg,
                        device=device, label="moe_serve",
                        max_len=MOE_SERVE_MAX_LEN, prompts=MOE_SERVE_PROMPTS,
                        swap=MOE_SERVE_SWAP, fanout=False)
    out["masked_prefill"] = moe_masked_prefill(torch, card, seed=seed,
                                               cfg=cfg, device=device)
    return out


def _sync(torch, dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize()


def _start(torch, dev) -> float:
    """The clock at a point every rank has reached with its work done, so
    a rank's time is its own and not the wait for the slowest."""
    import torch.distributed as dist  # noqa: PLC0415

    _sync(torch, dev)
    dist.barrier()
    return time.perf_counter()


def _digest(torch, tensors) -> str:
    """sha256 over the bytes of ``tensors``, in order."""
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().reshape(-1).contiguous().view(torch.uint8)
                 .cpu().numpy().tobytes())
    return h.hexdigest()


def _device_digest(torch, tensors) -> str:
    """A digest of ``tensors`` in order, each by :func:`_fingerprint`
    (computed on its device: no copy of the bytes to the host)."""
    return hashlib.sha256("".join(
        _fingerprint(torch, t) for t in tensors).encode()).hexdigest()


def _bits_equal(torch, a, b) -> bool:
    """Byte equality of two tensors of one dtype (a float's -0 and +0
    differ, a NaN equals its own bytes)."""
    ints = {1: torch.uint8, 2: torch.int16, 4: torch.int32, 8: torch.int64}
    view = ints[a.element_size()]
    return a.dtype == b.dtype and a.shape == b.shape and torch.equal(
        a.view(view), b.view(view))


def _rel_l2(got, want) -> float:
    got, want = got.float(), want.float()
    return ((got - want).norm() / want.norm().clamp_min(1e-30)).item()


def _peak(torch, dev) -> int | None:
    return torch.cuda.max_memory_allocated() if dev.type == "cuda" else None


def _reset_peak(torch, dev) -> None:
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()


def sp_rank(torch, fa, dev, spec: dict) -> dict:
    """Phase 15 on this rank: the dense reference (the whole sequence on
    this rank), ``forward_sp`` and the loss's gradients of each scheme on
    this rank's 2048 positions, then one Trainer step of each and, on rank
    0, the snapshot restored into a dense Trainer."""
    from grit_tpu_torch.models import llama, long_context  # noqa: PLC0415
    from grit_tpu_torch.parallel import axis_index, axis_size  # noqa: PLC0415
    from grit_tpu_torch.train.optim import adam  # noqa: PLC0415
    from grit_tpu_torch.train.trainer import Trainer  # noqa: PLC0415
    from grit_tpu_torch.tree import flatten_with_names  # noqa: PLC0415

    rank, n = axis_index(), axis_size()
    cfg, S = spec["lc_cfg"], spec["lc_seq"]
    s = S // n
    sl = slice(rank * s, (rank + 1) * s)
    params = llama.init_params(
        cfg, torch.Generator(device=dev).manual_seed(spec["seed"]), dev)
    toks = zipf_tokens(torch, S + 1, cfg.vocab_size,
                       torch.Generator().manual_seed(spec["seed"]))[None]
    inp, tgt = toks[:, :-1], toks[:, 1:].long()
    named = flatten_with_names(params)
    leaves = [x.requires_grad_(True) for _, x in named]
    with torch.no_grad():
        dense = llama.forward(cfg, params, inp.to(dev))[:, sl].clone()
    dense_loss = llama.loss_fn(cfg, params, inp.to(dev), tgt.to(dev))
    dense_grads = torch.autograd.grad(dense_loss, leaves)
    out = {"dense_loss": dense_loss.item()}
    mine = inp[:, sl].to(dev), tgt[:, sl].to(dev)
    for impl in long_context.ATTN_IMPLS:
        fa.reset_launch_counts()
        t0 = _start(torch, dev)
        with torch.no_grad():
            logits = long_context.forward_sp(cfg, params, mine[0],
                                             attn_impl=impl)
        _sync(torch, dev)
        fwd_s = time.perf_counter() - t0
        fwd_launches = dict(fa.LAUNCHES)
        err, scale = max_err(logits, dense)
        del logits
        fa.reset_launch_counts()
        _reset_peak(torch, dev)
        t0 = _start(torch, dev)
        loss = long_context.loss_fn_sp(cfg, params, *mine, attn_impl=impl)
        grads = torch.autograd.grad(loss, leaves)
        _sync(torch, dev)
        out[impl] = {
            "forward_s": fwd_s, "forward_launches": fwd_launches,
            "logit_err": err, "logit_scale": scale,
            "grad_s": time.perf_counter() - t0,
            "grad_launches": dict(fa.LAUNCHES), "peak": _peak(torch, dev),
            "loss": loss.item(),
            "grad_rel_l2": {name: _rel_l2(g, d) for (name, _), g, d
                            in zip(named, grads, dense_grads)},
            "grad_digest": _digest(torch, grads)}
        del grads, loss
    del dense, dense_grads, dense_loss
    for x in leaves:
        x.requires_grad_(False)

    # One Trainer step of each scheme; rank 0's snapshot into a dense one.
    box = {"impl": "ring"}

    def init(_gen, device):
        return llama.abstract_params(cfg) if device.type == "meta" else params

    def sp_loss(p, b):
        return long_context.loss_fn_sp(cfg, p, *b, attn_impl=box["impl"])

    tr = Trainer(loss_fn=sp_loss, init_params=init,
                 batch_fn=lambda _gen: (inp[:, sl], tgt[:, sl]), device=dev,
                 optimizer=adam(1e-4))
    steps = {}
    for impl in long_context.ATTN_IMPLS:
        box["impl"] = impl
        t0 = _start(torch, dev)
        loss = tr.train_step()["loss"].item()
        _sync(torch, dev)
        steps[impl] = {"loss": loss, "step_s": time.perf_counter() - t0}
    state = flatten_with_names(tr.state)
    out.update(train=steps, state_digest=_digest(torch, (x for _, x in state)),
               state_bytes=sum(x.numel() * x.element_size() for _, x in state))
    if rank == 0:
        snap = os.path.join(spec["work"], "sp-snap")
        tr.snapshot(snap)
        dense_tr = Trainer(
            loss_fn=lambda p, b: llama.loss_fn(cfg, p, *b), init_params=init,
            batch_fn=lambda _gen: (inp, tgt), device=dev, optimizer=adam(1e-4))
        restored_step = dense_tr.restore(snap)
        got = flatten_with_names(dense_tr.state)
        out["restore"] = {
            "step": restored_step,
            "names_equal": [k for k, _ in got] == [k for k, _ in state],
            "bytes_equal": all(_bits_equal(torch, a, b)
                               for (_, a), (_, b) in zip(got, state)),
            "dense_loss_after": dense_tr.train_step()["loss"].item()}
        shutil.rmtree(snap)
        del dense_tr, got
    del tr, state, params, leaves, named
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return out


def pp_rank(torch, fa, dev, spec: dict) -> dict:
    """Phase 16 on this rank (stage): for the dense flagship cut to 12
    layers and for the MoE model, the dense reference's logits and
    cross-entropy gradients (every rank runs it), then the pipelined
    forward and loss gradients of this rank's stage."""
    from grit_tpu_torch.models import llama, moe_llama, pipeline_llama  # noqa: PLC0415
    from grit_tpu_torch.parallel import axis_index, axis_size  # noqa: PLC0415
    from grit_tpu_torch.tree import flatten_with_names, map_with_names, tree_map  # noqa: PLC0415

    rank, n = axis_index(), axis_size()
    out = {}
    for label, cfg, B, S in (("dense", spec["pp_cfg"], *spec["pp_shape"]),
                             ("moe", spec["moe_pp_cfg"], *spec["moe_pp_shape"])):
        moe = label == "moe"
        family = moe_llama if moe else llama
        forward_pp = moe_llama.forward_pp if moe else pipeline_llama.forward_pp
        params = family.init_params(
            cfg, torch.Generator(device=dev).manual_seed(spec["seed"]), dev)
        toks = zipf_tokens(torch, B * (S + 1), cfg.vocab_size,
                           torch.Generator().manual_seed(spec["seed"])
                           ).reshape(B, S + 1).to(dev)
        inp, tgt = toks[:, :-1], toks[:, 1:].long()
        local = tree_map(
            lambda a: a.detach().clone(),
            pipeline_llama.stage_slice(
                pipeline_llama.to_stage_params(cfg, params, n), rank))
        micro = spec["pp_micro"]

        def dense_forward():
            """The dense model's logits: over the whole batch for llama;
            for the MoE model microbatch by microbatch, as the pipeline
            routes them (with nothing dropped the two are the same
            function, but the router's fp32 products round by the
            call's shape, and a near-tie of two experts then goes either
            way: a whole-batch reference differs by a routing flip)."""
            if not moe:
                return family.forward(cfg, params, inp)
            return torch.cat([family.forward(cfg, params, part)
                              for part in inp.chunk(micro)])

        with torch.no_grad():
            dense = dense_forward()
            fa.reset_launch_counts()
            t0 = _start(torch, dev)
            logits = forward_pp(cfg, local, inp, n_microbatches=micro)
            _sync(torch, dev)
            fwd_s = time.perf_counter() - t0
        fwd_launches = dict(fa.LAUNCHES)
        err, scale = max_err(logits, dense)
        del logits
        named = flatten_with_names(params)
        leaves = [x.requires_grad_(True) for _, x in named]
        dense_loss = llama.token_cross_entropy(dense_forward(), tgt)
        grads = dict(zip((k for k, _ in named),
                         torch.autograd.grad(dense_loss, leaves)))
        want = flatten_with_names(pipeline_llama.stage_slice(
            pipeline_llama.to_stage_params(
                cfg, map_with_names(lambda k, _: grads[k], params), n), rank))
        for x in leaves:
            x.requires_grad_(False)
        local_named = flatten_with_names(local)
        local_leaves = [x.requires_grad_(True) for _, x in local_named]
        fa.reset_launch_counts()
        _reset_peak(torch, dev)
        t0 = _start(torch, dev)
        loss = llama.token_cross_entropy(
            forward_pp(cfg, local, inp, n_microbatches=micro), tgt)
        got = torch.autograd.grad(loss, local_leaves)
        _sync(torch, dev)
        replicated = [g for (k, _), g in zip(local_named, got)
                      if not k.startswith("['layers']")]
        out[label] = {
            "forward_s": fwd_s, "ticks": micro + n - 1,
            "forward_launches": fwd_launches, "logit_err": err,
            "logit_scale": scale, "grad_s": time.perf_counter() - t0,
            "grad_launches": dict(fa.LAUNCHES), "peak": _peak(torch, dev),
            "loss": loss.item(), "dense_loss": dense_loss.item(),
            "grad_rel_l2": {k: _rel_l2(g, w) for (k, _), g, (_, w)
                            in zip(local_named, got, want)},
            "replicated_digest": _digest(torch, replicated)}
        del local, got, want, loss, dense_loss, leaves, local_leaves
        if moe:
            # The pp × ep leg, held to this leg's dense reference.
            out["pp_ep"] = pp_ep_leg(torch, fa, dev, spec, cfg, params, inp,
                                     tgt, dense, grads)
        del params, dense, grads
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    return out


def _swap_experts(torch, x, group):
    """``x``, this rank's expert shard, replaced by its peer's over the
    two-rank ``group``: the planted fault of the pp × ep checks."""
    import torch.distributed as dist  # noqa: PLC0415

    parts = [torch.empty_like(x) for _ in range(2)]
    dist.all_gather(parts, x.contiguous(), group=group)
    return parts[1 - dist.get_rank(group)]


def pp_ep_leg(torch, fa, dev, spec: dict, cfg, params, inp, tgt, dense,
              grads) -> dict:
    """Phase 16's pp × ep leg on this rank: the MoE model pipelined over
    :data:`PP_EP`'s stages with each stage's experts split over its
    ``expert`` axis (``build_pipe_mesh(expert=)``, the four ranks;
    ``moe_llama.forward_pp(mesh=)``), its logits and cross-entropy
    gradients held to the ``moe`` leg's dense reference (``dense``,
    ``grads``: computed once, by that leg); the staged shards dumped by
    the four ranks into one manifest by ``pp_stage_shardings``, restored
    by every rank onto the mesh and by rank 0 densely."""
    import torch.distributed as dist  # noqa: PLC0415

    from grit_tpu_torch.device.snapshot import (  # noqa: PLC0415
        SnapshotManifest, data_file, restore_snapshot, write_snapshot)
    from grit_tpu_torch.models import llama, moe_llama, pipeline_llama  # noqa: PLC0415
    from grit_tpu_torch.parallel.mesh import build_pipe_mesh  # noqa: PLC0415
    from grit_tpu_torch.tree import flatten_with_names, map_with_names  # noqa: PLC0415

    rank = dist.get_rank()
    mesh = build_pipe_mesh(dev.type, expert=PP_EP[1])
    n_stages = mesh.size(0)
    staged = pipeline_llama.to_stage_params(cfg, params, n_stages)
    shard_by = dict(flatten_with_names(
        moe_llama.pp_stage_shardings(mesh, staged)))
    local = map_with_names(lambda k, x: shard_by[k].distribute(x.detach()),
                           staged)
    if spec.get("pp_ep_fault") == "swap_expert":
        moe = local["layers"]["moe"]
        moe["w_in"] = _swap_experts(torch, moe["w_in"],
                                    mesh.get_group("expert"))
    micro = spec["pp_micro"]
    with torch.no_grad():
        fa.reset_launch_counts()
        t0 = _start(torch, dev)
        logits = moe_llama.forward_pp(cfg, local, inp, n_microbatches=micro,
                                      mesh=mesh)
        _sync(torch, dev)
        fwd_s = time.perf_counter() - t0
    fwd_launches = dict(fa.LAUNCHES)
    err, scale = max_err(logits, dense)
    del logits
    named = flatten_with_names(local)
    leaves = [x.requires_grad_(True) for _, x in named]
    fa.reset_launch_counts()
    _reset_peak(torch, dev)
    t0 = _start(torch, dev)
    loss = llama.token_cross_entropy(moe_llama.forward_pp(
        cfg, local, inp, n_microbatches=micro, mesh=mesh), tgt)
    got = torch.autograd.grad(loss, leaves)
    _sync(torch, dev)
    grad_s = time.perf_counter() - t0
    grad_launches = dict(fa.LAUNCHES)
    peak = _peak(torch, dev)
    for x in leaves:
        x.requires_grad_(False)
    want = dict(flatten_with_names(pipeline_llama.to_stage_params(
        cfg, map_with_names(lambda k, _: grads[k], params), n_stages)))
    rel = {k: _rel_l2(g, shard_by[k].distribute(want[k]))
           for (k, _), g in zip(named, got)}
    del got, want

    snap = spec["pp_ep_snap"]
    layout = map_with_names(lambda k, _x: shard_by[k], staged)
    dist.barrier()
    t0 = _start(torch, dev)
    write_snapshot(snap, local, meta={"step": 0}, barrier=dist.barrier,
                   process_index=rank, process_count=dist.get_world_size(),
                   shardings=layout)
    dump_s = time.perf_counter() - t0
    dump_bytes = os.path.getsize(os.path.join(snap, data_file(rank)))
    like = map_with_names(lambda k, x: shard_by[k].zeros(
        list(x.shape), x.dtype, "meta"), staged)
    t0 = _start(torch, dev)
    back = restore_snapshot(snap, like=like, device=dev, shardings=layout)
    _sync(torch, dev)
    restore_s = time.perf_counter() - t0
    bitwise = all(_bits_equal(torch, a, b) for (_, a), (_, b) in zip(
        flatten_with_names(back), named))
    del back
    out = {"mesh": dict(zip(mesh.mesh_dim_names, mesh.shape)),
           "stages": n_stages, "ticks": micro + n_stages - 1,
           "forward_s": fwd_s, "forward_launches": fwd_launches,
           "logit_err": err, "logit_scale": scale, "grad_s": grad_s,
           "grad_launches": grad_launches, "peak": peak,
           "loss": loss.item(), "grad_rel_l2": rel, "dump_s": dump_s,
           "dump_bytes": dump_bytes, "restore_s": restore_s,
           "restore_bitwise": bitwise,
           "held_bytes": sum(x.numel() * x.element_size() for _, x in named)}
    if rank == 0:
        t0 = time.perf_counter()
        whole = pipeline_llama.from_stage_params(restore_snapshot(
            snap, like=map_with_names(lambda _k, x: torch.empty(
                x.shape, dtype=x.dtype, device="meta"), staged), device=dev))
        _sync(torch, dev)
        out["dense_restore_s"] = time.perf_counter() - t0
        out["dense_restore_bitwise"] = all(
            _bits_equal(torch, a, b) for (_, a), (_, b) in zip(
                flatten_with_names(whole), flatten_with_names(params)))
        recs = SnapshotManifest.load(snap).arrays
        out["descriptors_ok"] = {r["name"]: r["sharding"] for r in recs} == {
            k: sh.descriptor() for k, sh in shard_by.items()}
        out["chunks"] = sum(len(r["chunks"]) for r in recs)
        del whole
    dist.barrier()
    return out


def parallel_rank(spec: dict) -> dict:
    """Phases 15 and 16 on one rank of the four (``run_ranks`` starts it:
    each rank is a process of its own on the same card)."""
    import torch  # noqa: PLC0415

    from grit_tpu_torch.ops import flash_attention as fa  # noqa: PLC0415

    dev = torch.device(spec["device"])
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
    return {"long_context": sp_rank(torch, fa, dev, spec),
            "pipeline": pp_rank(torch, fa, dev, spec)}


def _worst(d: dict) -> tuple[str, float]:
    name = max(d, key=d.get)
    return name, d[name]


def phase_parallel(torch, work: str, card: str, *, seed: int,
                   device: str = "cuda", lc_cfg=None, lc_seq: int = SP_SEQ,
                   pp_cfg=None, pp_shape=(PP_BATCH, SEQ), moe_pp_cfg=None,
                   moe_pp_shape=(MOE_PP_BATCH, MOE_PP_SEQ),
                   pp_micro: int = PP_MICRO,
                   pp_ep_fault: str | None = None) -> tuple[dict, dict]:
    """Phases 15 and 16: :data:`N_RANKS` ranks over ``LOCAL_GLOO`` on the one card
    (the configs and ``device`` other than the defaults only to rehearse
    at a small size on the CPU; ``pp_ep_fault="swap_expert"`` plants a
    fault the pp × ep leg's checks must catch). Returns the two phases'
    records."""
    from dataclasses import replace  # noqa: PLC0415

    from grit_tpu_torch.models import llama, moe_llama  # noqa: PLC0415
    from grit_tpu_torch.parallel.collectives import LOCAL_GLOO  # noqa: PLC0415
    from grit_tpu_torch.parallel.launch import run_ranks  # noqa: PLC0415

    lc_cfg = lc_cfg or llama.LlamaConfig.flagship(n_layers=SP_LAYERS,
                                                  remat=True)
    pp_cfg = pp_cfg or llama.LlamaConfig.flagship(n_layers=PP_LAYERS,
                                                  remat=True)
    moe_pp_cfg = moe_pp_cfg or moe_llama.MoeLlamaConfig.bench(remat=True)
    # Non-binding capacity: the pipeline routes per microbatch, the dense
    # model per batch, so they agree only when no token is dropped.
    moe_pp_cfg = replace(moe_pp_cfg, capacity_factor=float(moe_pp_cfg.n_experts))
    on_card = device == "cuda"
    if on_card:
        torch.cuda.empty_cache()
    spec = {"device": device, "seed": seed, "work": work, "lc_cfg": lc_cfg,
            "lc_seq": lc_seq, "pp_cfg": pp_cfg, "pp_shape": pp_shape,
            "moe_pp_cfg": moe_pp_cfg, "moe_pp_shape": moe_pp_shape,
            "pp_micro": pp_micro, "pp_ep_fault": pp_ep_fault,
            "pp_ep_snap": os.path.join(work, "pp-ep-snap")}
    t0 = time.perf_counter()
    try:
        ranks = run_ranks(parallel_rank, N_RANKS, spec, backend=LOCAL_GLOO,
                          timeout=900)
    finally:
        shutil.rmtree(spec["pp_ep_snap"], ignore_errors=True)
    wall = time.perf_counter() - t0
    lc = long_context_checks([r["long_context"] for r in ranks], lc_cfg,
                             lc_seq, card, wall, on_card)
    pp = pipeline_checks([r["pipeline"] for r in ranks], pp_cfg, moe_pp_cfg,
                         pp_shape, moe_pp_shape, pp_micro, card, on_card)
    return lc, pp


def long_context_checks(ranks: list[dict], cfg, seq: int, card: str,
                        wall: float, on_card: bool) -> dict:
    """Phase 15's lines and checks over the ranks' records."""
    L = cfg.n_layers
    failures = []
    log("long_context", f"{N_RANKS} ranks on one card over LOCAL_GLOO (every "
                        f"hop between the ranks' device buffers), launched and "
                        f"run in {wall:.1f} s"
                        f" with phase 16; dim {cfg.dim}, {cfg.n_heads} heads "
                        f"of {cfg.head_dim}, {L} layers, remat, B 1 x S {seq}"
                        f", {seq // N_RANKS} positions a rank [{card}]")
    for impl in ("ring", "ulysses"):
        recs = [r[impl] for r in ranks]
        err = max(r["logit_err"] for r in recs)
        bound = PAR_LOGIT_BOUND * max(r["logit_scale"] for r in recs)
        worst = [_worst(r["grad_rel_l2"]) for r in recs]
        grad = max(w[1] for w in worst)
        digests = {r["grad_digest"] for r in recs}
        log("long_context", f"{impl}: logits against the dense flash forward "
                            f"at S {seq}: max |err| {err:.5f}, bound "
                            f"{bound:.5f} ({PAR_LOGIT_BOUND} of the largest "
                            f"dense logit); loss {recs[0]['loss']!r} (dense "
                            f"{ranks[0]['dense_loss']!r}); worst gradient "
                            f"relative L2 {grad:.5f} ({worst[0][0]}), bound "
                            f"{PAR_GRAD_BOUND}; gradients bytewise equal on "
                            f"all ranks: {len(digests) == 1}")
        log("long_context", f"{impl}: per rank forward s "
                            f"{[round(r['forward_s'], 4) for r in recs]}, loss "
                            f"and gradients s "
                            f"{[round(r['grad_s'], 4) for r in recs]}, peak "
                            f"memory {[r['peak'] for r in recs]} B, flash "
                            f"launches (forward; loss and gradients) "
                            f"{recs[0]['forward_launches']}; "
                            f"{recs[0]['grad_launches']} [{card}]")
        if not err <= bound:
            failures.append(f"{impl} logits off by {err} > {bound}")
        if not grad <= PAR_GRAD_BOUND:
            failures.append(f"{impl} gradient relative L2 {grad}")
        if len(digests) != 1:
            failures.append(f"{impl} gradients differ between ranks")
        if len({r["loss"] for r in recs}) != 1:
            failures.append(f"{impl} losses differ between ranks")
        if on_card:
            want_fwd = ({"flash_fwd": L, "flash_bwd_dq": 0, "flash_bwd_dkv": 0}
                        if impl == "ulysses" else dict.fromkeys(KERNELS, 0))
            want_grad = ({"flash_fwd": 2 * L, "flash_bwd_dq": L,
                          "flash_bwd_dkv": L} if impl == "ulysses"
                         else dict.fromkeys(KERNELS, 0))
            for r in recs:
                if r["forward_launches"] != want_fwd or \
                        r["grad_launches"] != want_grad:
                    failures.append(f"{impl} launches {r['forward_launches']},"
                                    f" {r['grad_launches']}")
    train = [r["train"] for r in ranks]
    restore = ranks[0]["restore"]
    log("long_context", f"Trainer (Adam), one ring step then one Ulysses "
                        f"step on every rank: losses {train[0]['ring']['loss']!r}"
                        f", {train[0]['ulysses']['loss']!r}; step s per rank "
                        f"ring {[round(t['ring']['step_s'], 4) for t in train]}"
                        f", ulysses "
                        f"{[round(t['ulysses']['step_s'], 4) for t in train]};"
                        f" state ({ranks[0]['state_bytes']} B) bytewise equal "
                        f"on all ranks: "
                        f"{len({r['state_digest'] for r in ranks}) == 1}; rank "
                        f"0's snapshot restored into a dense Trainer at step "
                        f"{restore['step']}, leaves byte-identical: "
                        f"{restore['bytes_equal']}, its next dense step's "
                        f"loss {restore['dense_loss_after']!r} [{card}]")
    if len({r["state_digest"] for r in ranks}) != 1:
        failures.append("the trained state differs between ranks")
    if len({(t["ring"]["loss"], t["ulysses"]["loss"]) for t in train}) != 1:
        failures.append("the Trainer's losses differ between ranks")
    if not (restore["step"] == 2 and restore["names_equal"]
            and restore["bytes_equal"]
            and math.isfinite(restore["dense_loss_after"])):
        failures.append(f"rank 0's snapshot did not restore into a dense "
                        f"Trainer byte for byte: {restore}")
    if failures:
        raise AssertionError("long context: " + "; ".join(failures))
    return {
        "ranks": N_RANKS, "seq": seq, "layers": L,
        "wall_s_with_pipeline": wall,
        **{impl: {"logit_err": max(r[impl]["logit_err"] for r in ranks),
                  "worst_grad_rel_l2": max(_worst(r[impl]["grad_rel_l2"])[1]
                                           for r in ranks),
                  "forward_s": [r[impl]["forward_s"] for r in ranks],
                  "grad_s": [r[impl]["grad_s"] for r in ranks],
                  "peak": [r[impl]["peak"] for r in ranks],
                  "trainer_step_s": [t[impl]["step_s"] for t in train],
                  "launches_per_rank": [{
                      k: r[impl]["forward_launches"][k]
                      + r[impl]["grad_launches"][k] for k in KERNELS}
                      for r in ranks],
                  "launches": {k: sum(r[impl][f"{part}_launches"][k]
                                      for r in ranks
                                      for part in ("forward", "grad"))
                               for k in KERNELS}}
           for impl in ("ring", "ulysses")},
        "restore": restore}


def pipeline_checks(ranks: list[dict], cfg, moe_cfg, shape, moe_shape,
                    micro: int, card: str, on_card: bool) -> dict:
    """Phase 16's lines and checks over the ranks' records."""
    failures = []
    out = {"ranks": N_RANKS, "microbatches": micro}
    for label, c, (B, S) in (("dense", cfg, shape), ("moe", moe_cfg, moe_shape)):
        recs = [r[label] for r in ranks]
        per = c.n_layers // N_RANKS
        ticks = recs[0]["ticks"]
        err = max(r["logit_err"] for r in recs)
        bound = PAR_LOGIT_BOUND * max(r["logit_scale"] for r in recs)
        worst = [_worst(r["grad_rel_l2"]) for r in recs]
        grad = max(w[1] for w in worst)
        tick_ms = [r["forward_s"] / ticks * 1e3 for r in recs]
        log("pipeline", f"{label}: {type(c).__name__} dim {c.dim}, "
                        f"{c.n_layers} layers in {N_RANKS} stages of {per}, "
                        f"B {B} x S {S} in {micro} microbatches, {ticks} "
                        f"ticks, remat; logits against the dense model"
                        f"{' microbatch by microbatch' if label == 'moe' else ''}"
                        f": max |err| {err:.5f}, bound {bound:.5f}; loss "
                        f"{recs[0]['loss']!r} (dense {recs[0]['dense_loss']!r})"
                        f"; worst gradient relative L2 {grad:.5f} "
                        f"({worst[0][0]} on stage 0), bound {PAR_GRAD_BOUND}")
        log("pipeline", f"{label}: per rank tick ms (forward / ticks) "
                        f"{[round(x, 3) for x in tick_ms]}, loss and "
                        f"gradients s {[round(r['grad_s'], 4) for r in recs]}"
                        f", peak memory {[r['peak'] for r in recs]} B, flash "
                        f"launches per rank (forward; loss and gradients) "
                        f"{recs[0]['forward_launches']}; "
                        f"{recs[0]['grad_launches']} [{card}]")
        if not err <= bound:
            failures.append(f"{label} logits off by {err} > {bound}")
        if not grad <= PAR_GRAD_BOUND:
            failures.append(f"{label} gradient relative L2 {grad}")
        if len({r["replicated_digest"] for r in recs}) != 1 or \
                len({r["loss"] for r in recs}) != 1:
            failures.append(f"{label}: the replicated leaves' gradients or "
                            f"the loss differ between ranks")
        if on_card:
            fwd = {"flash_fwd": ticks * per, "flash_bwd_dq": 0,
                   "flash_bwd_dkv": 0}
            grads = {"flash_fwd": 2 * ticks * per,
                     "flash_bwd_dq": ticks * per, "flash_bwd_dkv": ticks * per}
            for r in recs:
                if r["forward_launches"] != fwd or r["grad_launches"] != grads:
                    failures.append(f"{label} launches {r['forward_launches']}"
                                    f", {r['grad_launches']}")
        out[label] = {"logit_err": err, "worst_grad_rel_l2": grad,
                      "tick_ms": tick_ms, "ticks": ticks,
                      "grad_s": [r["grad_s"] for r in recs],
                      "peak": [r["peak"] for r in recs],
                      "launches_per_rank": [{
                          k: r["forward_launches"][k] + r["grad_launches"][k]
                          for k in KERNELS} for r in recs]}
    out["pp_ep"] = pp_ep_checks([r["pp_ep"] for r in ranks], moe_cfg,
                                moe_shape, micro, card, on_card, failures)
    out["launches"] = {k: sum(r[label][f"{part}_launches"][k] for r in ranks
                              for label in ("dense", "moe")
                              for part in ("forward", "grad"))
                       + sum(r["pp_ep"][f"{part}_launches"][k]
                             for r in ranks for part in ("forward", "grad"))
                       for k in KERNELS}
    if failures:
        raise AssertionError("pipeline: " + "; ".join(failures))
    return out


def pp_ep_checks(recs: list[dict], cfg, shape, micro: int, card: str,
                 on_card: bool, failures: list[str]) -> dict:
    """Phase 16's pp × ep lines and checks (misses appended to
    ``failures``, each naming ``pp_ep``) over the ranks' records."""
    stages, experts = PP_EP
    per = cfg.n_layers // stages
    ticks = recs[0]["ticks"]
    err = max(r["logit_err"] for r in recs)
    bound = PAR_LOGIT_BOUND * max(r["logit_scale"] for r in recs)
    worst = [_worst(r["grad_rel_l2"]) for r in recs]
    grad = max(w[1] for w in worst)
    B, S = shape
    log("pipeline", f"pp_ep: {type(cfg).__name__} dim {cfg.dim}, "
                    f"{cfg.n_layers} layers in {stages} stages of {per}, "
                    f"{cfg.n_experts} experts in {experts} shards of "
                    f"{cfg.n_experts // experts} a stage (mesh "
                    f"{recs[0]['mesh']}), B {B} x S {S} in {micro} "
                    f"microbatches, {ticks} ticks; logits against the moe "
                    f"leg's dense reference: max |err| {err:.5f}, bound "
                    f"{bound:.5f}; loss {recs[0]['loss']!r}; worst gradient "
                    f"relative L2 {grad:.5f} ({worst[0][0]} on rank 0), "
                    f"bound {PAR_GRAD_BOUND} [{card}]")
    log("pipeline", f"pp_ep: forward s {[round(r['forward_s'], 4) for r in recs]}"
                    f", loss and gradients s "
                    f"{[round(r['grad_s'], 4) for r in recs]}, peak "
                    f"{[r['peak'] for r in recs]} B, held bytes a rank "
                    f"{[r['held_bytes'] for r in recs]}; flash launches a rank "
                    f"(forward; loss and gradients) "
                    f"{recs[0]['forward_launches']}; "
                    f"{recs[0]['grad_launches']} [{card}]")
    log("pipeline", f"pp_ep snapshot: one manifest of {recs[0]['chunks']} "
                    f"chunks by pp_stage_shardings (descriptors as the "
                    f"layout's: {recs[0]['descriptors_ok']}); dump s "
                    f"{[round(r['dump_s'], 3) for r in recs]}, bytes a rank "
                    f"{[r['dump_bytes'] for r in recs]}; restore onto the "
                    f"mesh s {[round(r['restore_s'], 3) for r in recs]}, "
                    f"bitwise {[r['restore_bitwise'] for r in recs]}; rank 0's "
                    f"dense restore {recs[0]['dense_restore_s']:.3f} s, the "
                    f"MoE's parameters byte for byte: "
                    f"{recs[0]['dense_restore_bitwise']} [{card}]")
    if not err <= bound:
        failures.append(f"pp_ep logits off by {err} > {bound}")
    if not grad <= PAR_GRAD_BOUND:
        failures.append(f"pp_ep gradient relative L2 {grad}")
    if len({r["loss"] for r in recs}) != 1:
        failures.append("pp_ep: the loss differs between ranks")
    if not all(r["restore_bitwise"] for r in recs):
        failures.append("pp_ep: a rank's restore onto the mesh is not "
                        "bitwise its shards")
    if not (recs[0]["dense_restore_bitwise"] and recs[0]["descriptors_ok"]):
        failures.append("pp_ep: the dense restore or the descriptors differ")
    if on_card:
        fwd = {"flash_fwd": ticks * per, "flash_bwd_dq": 0,
               "flash_bwd_dkv": 0}
        grads = {"flash_fwd": 2 * ticks * per, "flash_bwd_dq": ticks * per,
                 "flash_bwd_dkv": ticks * per}
        for r in recs:
            if r["forward_launches"] != fwd or r["grad_launches"] != grads:
                failures.append(f"pp_ep launches {r['forward_launches']}, "
                                f"{r['grad_launches']}")
    return {"mesh": recs[0]["mesh"], "logit_err": err, "logit_bound": bound,
            "worst_grad_rel_l2": grad,
            "forward_s": [r["forward_s"] for r in recs],
            "grad_s": [r["grad_s"] for r in recs],
            "peak": [r["peak"] for r in recs],
            "dump_s": [r["dump_s"] for r in recs],
            "dump_bytes": [r["dump_bytes"] for r in recs],
            "restore_s": [r["restore_s"] for r in recs],
            "restore_bitwise": all(r["restore_bitwise"] for r in recs),
            "dense_restore_s": recs[0]["dense_restore_s"],
            "dense_restore_bitwise": recs[0]["dense_restore_bitwise"],
            "launches_per_rank": [{
                k: r["forward_launches"][k] + r["grad_launches"][k]
                for k in KERNELS} for r in recs]}


# -- phase 17 ------------------------------------------------------------------

# Phase 17: phase 16's flagship pipeline (four stages of 3 layers, remat,
# B 8 x S 2048 in 4 microbatches, Adam 1e-4) as a training gang: each
# rank's agentlet carries a slice gate over a file rendezvous with the
# lockstep collective, and four hooks' dumps land about a step apart.
GANG_READY_STEP = 2   # every rank has taken this many steps before the dumps
GANG_AFTER = 3        # sources and restored ranks run to cut + this
GANG_LR = 1e-4
GANG_LAYERS = 4       # one layer a stage (phase 16's 12 until PR 12)


def gang_trainer(torch, cfg, rank: int, n: int, *, batch: int, seq: int,
                 micro: int, seed: int, dev):
    """Rank ``rank``'s stage Trainer: its stage of the dense params (built
    from ``seed`` on every rank, then sliced), ``loss_fn_pp``, Adam, Zipf
    batches the same on every rank."""
    from grit_tpu_torch.models import llama, pipeline_llama  # noqa: PLC0415
    from grit_tpu_torch.train.optim import adam  # noqa: PLC0415
    from grit_tpu_torch.train.trainer import Trainer, TrainerConfig  # noqa: PLC0415
    from grit_tpu_torch.tree import tree_map  # noqa: PLC0415
    from grit_tpu_torch.workload import zipf_batches  # noqa: PLC0415

    def init(gen, device):
        meta = torch.device(device).type == "meta"
        full = (llama.abstract_params(cfg) if meta
                else llama.init_params(cfg, gen, device))
        local = pipeline_llama.stage_slice(
            pipeline_llama.to_stage_params(cfg, full, n), rank)
        return local if meta else tree_map(lambda a: a.clone(), local)

    return Trainer(
        loss_fn=lambda p, b: pipeline_llama.loss_fn_pp(
            cfg, p, b[0], b[1], n_microbatches=micro),
        init_params=init, batch_fn=zipf_batches(cfg.vocab_size, batch, seq),
        cfg=TrainerConfig(learning_rate=GANG_LR, seed=seed), device=dev,
        optimizer=adam(GANG_LR))


def gang_rank(spec: dict) -> dict:
    """Phase 17 on one rank (stage). ``"source"``: train with an agentlet
    whose gate runs the cut over a ``FileRendezvous`` with the lockstep
    collective, publish the pid, step until the phase's ``stop`` file
    names a step reached. ``"restore"``: a fresh stage restores
    ``host-<rank>/hbm`` and steps to ``spec["stop"]``. Returns the losses,
    the state's digest, the kernels' launches and the steps they span,
    the modules of JAX or of the JAX package the rank loaded (none), and
    the gate's and the dump's numbers."""
    import torch  # noqa: PLC0415

    from grit_tpu_torch.device.agentlet import Agentlet  # noqa: PLC0415
    from grit_tpu_torch.device.snapshot import last_write  # noqa: PLC0415
    from grit_tpu_torch.ops import flash_attention as fa  # noqa: PLC0415
    from grit_tpu_torch.parallel import axis_index, axis_size  # noqa: PLC0415
    from grit_tpu_torch.parallel.coordination import (  # noqa: PLC0415
        FileRendezvous,
        SliceCoordinator,
        SliceQuiesceGate,
        group_any,
    )
    from grit_tpu_torch.tree import flatten_with_names  # noqa: PLC0415

    dev = torch.device(spec["device"])
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
    rank, n = axis_index(), axis_size()
    work = spec["work"]
    tr = gang_trainer(torch, spec["cfg"], rank, n, batch=spec["batch"],
                      seq=spec["seq"], micro=spec["micro"], seed=spec["seed"],
                      dev=dev)
    out: dict = {"losses": {}}

    def finish(**kw) -> dict:
        out.update(kw, launches=dict(fa.LAUNCHES), digest=_digest(
            torch, (x for _, x in flatten_with_names(tr.state))),
            foreign=sorted(m for m in sys.modules
                           if m.split(".")[0] in ("jax", "jaxlib", "grit_tpu")))
        return out

    if spec["mode"] == "restore":
        t0 = time.perf_counter()
        out["restored"] = tr.restore(os.path.join(work, f"host-{rank}", "hbm"))
        _sync(torch, dev)
        out["restore_s"] = time.perf_counter() - t0
        first = tr.step
        fa.reset_launch_counts()
        while tr.step < spec["stop"]:
            loss = tr.train_step()["loss"].item()
            out["losses"][tr.step] = loss
        res = finish(steps=tr.step - first)
        # Phase 20's pipe axis, on the restored stages (their record is
        # taken: its steps update these tensors in place).
        res["pipe"] = pipe_axis_round(torch, fa, spec, tr, rank, n, dev)
        return res
    os.environ["GRIT_TPU_SOCKET_DIR"] = spec["sockdir"]
    gate = SliceQuiesceGate(
        SliceCoordinator(FileRendezvous(os.path.join(work, "rdv"), rank, n),
                         process_index=rank, process_count=n),
        lockstep=group_any())
    agentlet = Agentlet(lambda: tr.state, step_fn=lambda: tr.step,
                        slice_gate=gate).start()
    state = flatten_with_names(tr.state)
    out["state_bytes"] = sum(x.numel() * x.element_size() for _, x in state)
    del state
    _write_atomic(os.path.join(work, f"pid-{rank}"), str(os.getpid()))
    stop_file = os.path.join(work, "stop")
    fa.reset_launch_counts()
    try:
        while True:
            loss = tr.train_step()["loss"].item()
            out["losses"][tr.step] = loss
            agentlet.checkpoint_point()
            try:
                with open(stop_file) as f:
                    stop = int(f.read())
            except (OSError, ValueError):
                stop = None
            if stop is not None and tr.step >= stop:
                break
    finally:
        agentlet.stop()
    return finish(steps=tr.step, request_step=gate.request_step,
                  wait_s=gate.wait_s, failed=gate.failed, dump=last_write(),
                  peak=_peak(torch, dev))


def pipe_axis_round(torch, fa, spec: dict, tr, rank: int, n: int,
                    dev) -> dict:
    """Phase 20's pipe axis in phase 17's restore launch: a pipelined
    Trainer on a pipe mesh (``STAGE_RULES``) takes over the restored
    stage ``tr``'s state (a rank's stage is its shard of the staged
    tree) and writes one manifest; a fresh one restores it; each takes a
    step, which must be bitwise the other's; rank 0 restores the staged
    arrays into a dense model (``from_stage_params``), whose loss on
    that step's batch must be the pipeline's within 1e-3."""
    import torch.distributed as dist  # noqa: PLC0415

    from grit_tpu_torch.device.snapshot import (  # noqa: PLC0415
        SnapshotManifest,
        last_write,
        restore_snapshot,
    )
    from grit_tpu_torch.models import llama, pipeline_llama  # noqa: PLC0415
    from grit_tpu_torch.parallel.mesh import build_pipe_mesh  # noqa: PLC0415
    from grit_tpu_torch.train.optim import adam  # noqa: PLC0415
    from grit_tpu_torch.train.trainer import Trainer, TrainerConfig  # noqa: PLC0415
    from grit_tpu_torch.workload import zipf_batches  # noqa: PLC0415

    t_round = time.perf_counter()
    cfg = spec["cfg"]
    mesh = build_pipe_mesh(dev.type)

    def staged(gen, device):
        full = (llama.abstract_params(cfg)
                if torch.device(device).type == "meta"
                else llama.init_params(cfg, gen, device))
        return pipeline_llama.to_stage_params(cfg, full, n)

    def make():
        return Trainer(
            loss_fn=lambda p, b: pipeline_llama.loss_fn_pp(
                cfg, p, b[0], b[1], n_microbatches=spec["micro"]),
            init_params=staged,
            batch_fn=zipf_batches(cfg.vocab_size, spec["batch"], spec["seq"]),
            cfg=TrainerConfig(learning_rate=GANG_LR, seed=spec["seed"]),
            device=dev, optimizer=adam(GANG_LR), mesh=mesh,
            rules=pipeline_llama.STAGE_RULES)

    snap = os.path.join(spec["work"], "pipe-snap")
    src = make()
    src.state = tr.state
    t0 = _start(torch, dev)
    src.snapshot(snap)
    out = {"dump_s": time.perf_counter() - t0, "dump": last_write(),
           "cut": src.step}
    if rank == 0:
        m = SnapshotManifest.load(snap)
        layers = [r for r in m.arrays if "['layers']" in r["name"]]
        out["manifest"] = {
            "process_count": m.process_count, "arrays": len(m.arrays),
            "staged": all(r["shape"][0] == n and sorted(
                c["index"][0] for c in r["chunks"]) == [[s, s + 1] for s in
                                                       range(n)]
                for r in layers),
            "once": all(len(r["chunks"]) == 1 for r in m.arrays
                        if r not in layers),
            "layer_leaves": len(layers),
            "spec": next(r["sharding"] for r in layers)}
    dst = make()
    t0 = _start(torch, dev)
    out["restored"] = dst.restore(snap)
    _sync(torch, dev)
    out["restore_s"] = time.perf_counter() - t0
    out["same_state"] = (_device_digest(torch, _locals(dst))
                         == _device_digest(torch, _locals(src)))
    batch = src.batch(src.step)
    fa.reset_launch_counts()
    out["loss"] = src.train_step()["loss"].item()
    out["restored_loss"] = dst.train_step()["loss"].item()
    out["launches"] = dict(fa.LAUNCHES)
    out["after_equal"] = (_device_digest(torch, _locals(dst))
                          == _device_digest(torch, _locals(src)))
    del dst
    if rank == 0:
        like = {"params": pipeline_llama.to_stage_params(
            cfg, llama.abstract_params(cfg), n)}
        dense = pipeline_llama.from_stage_params(
            restore_snapshot(snap, like=like, device=dev)["params"])
        with torch.no_grad():
            out["dense_loss"] = llama.loss_fn(cfg, dense, *batch).item()
        del dense
    _release(torch, dev)
    dist.barrier()
    out["wall_s"] = time.perf_counter() - t_round
    return out


def _write_atomic(path: str, text: str) -> None:
    with open(path + ".tmp", "w") as f:
        f.write(text)
    os.replace(path + ".tmp", path)


def gang_spec(gwork: str, cfg, *, batch: int, seq: int, micro: int,
              seed: int, device: str) -> dict:
    """A source rank's spec: its files under ``gwork``, its agentlet's
    socket under ``<gwork>/s`` (short: a socket path holds 107 bytes)."""
    sockdir = os.path.join(gwork, "s")
    os.makedirs(sockdir, exist_ok=True)
    return {"mode": "source", "work": gwork, "sockdir": sockdir, "cfg": cfg,
            "batch": batch, "seq": seq, "micro": micro, "seed": seed,
            "device": device}


class GangSources:
    """A gang's source ranks: ``fn`` (phase 17's :func:`gang_rank`, phase
    20's :func:`mesh_rank`) on ``N_RANKS`` ``LOCAL_GLOO`` ranks, launched
    from a thread; their pids, their agentlets' status, when every rank
    had first reached each step (``t_step``), and the stop file (the pid
    and stop files under ``spec["work"]``, the sockets under
    ``spec["sockdir"]``)."""

    def __init__(self, spec: dict, timeout: float = 900.0, fn=None) -> None:
        import threading  # noqa: PLC0415

        self.fn = fn or gang_rank
        self.spec = spec
        self.box: dict = {}
        self.t_step: dict[int, float] = {}
        self._pids: list[int] = []
        self.started = time.perf_counter()
        self.thread = threading.Thread(target=self._run, args=(timeout,),
                                       daemon=True)
        self.thread.start()

    def _run(self, timeout: float) -> None:
        from grit_tpu_torch.parallel.collectives import LOCAL_GLOO  # noqa: PLC0415
        from grit_tpu_torch.parallel.launch import run_ranks  # noqa: PLC0415

        try:
            self.box["sources"] = run_ranks(self.fn, N_RANKS, self.spec,
                                            backend=LOCAL_GLOO,
                                            timeout=timeout)
        except BaseException as exc:  # noqa: BLE001 — raised in check()
            self.box["error"] = exc

    def check(self) -> None:
        if "error" in self.box:
            raise AssertionError(f"gang: a source rank failed: "
                                 f"{self.box['error']}")

    def pids(self, timeout: float = 600.0) -> list[int]:
        files = [os.path.join(self.spec["work"], f"pid-{k}")
                 for k in range(N_RANKS)]
        deadline = time.monotonic() + timeout
        while not all(os.path.exists(f) for f in files):
            self.check()
            if time.monotonic() > deadline:
                raise AssertionError("gang: the source ranks did not start")
            time.sleep(0.1)
        self._pids = [int(open(f).read()) for f in files]
        return self._pids

    def client(self, pid: int):
        from grit_tpu_torch.device.agentlet import ToggleClient  # noqa: PLC0415

        return ToggleClient(pid, path=os.path.join(
            self.spec["sockdir"], f"grit-tpu-{pid}.sock"), timeout=60)

    def status(self, pid: int) -> dict:
        with self.client(pid) as c:
            return c.status()

    def wait_steps(self, step: int, timeout: float = 600.0) -> list[int]:
        """Every rank's step once all have reached ``step``."""
        deadline = time.monotonic() + timeout
        while True:
            self.check()
            steps = [self.status(p)["step"] for p in self._pids]
            for s in range(1, min(steps) + 1):
                self.t_step.setdefault(s, time.perf_counter())
            if min(steps) >= step:
                return steps
            if time.monotonic() > deadline:
                raise AssertionError(f"gang: sources at steps {steps}, "
                                     f"want {step}")
            time.sleep(0.05)

    def stop_at(self, step: int) -> None:
        _write_atomic(os.path.join(self.spec["work"], "stop"), str(step))

    def join(self, timeout: float = 600.0) -> list[dict]:
        self.thread.join(timeout)
        self.check()
        if self.thread.is_alive():
            raise AssertionError("gang: the sources did not finish")
        return self.box["sources"]

    def close(self) -> None:
        """Stop sources still running (a failed phase): unpark and stop
        them at the next step."""
        if not self.thread.is_alive():
            return
        self.stop_at(0)
        for p in self._pids:
            try:
                with self.client(p) as c:
                    c.resume()
            except Exception:  # noqa: BLE001, S110 — not parked, or gone
                pass
        self.thread.join(timeout=60)


def gang_dumps(hook, pids: list[int], gwork: str, order, stagger_s: float,
               prefix: str = "host") -> dict:
    """The per-host hooks' dumps of ``pids[k]`` into
    ``<gwork>/<prefix>-<k>``, from one thread each, started in ``order``
    ``stagger_s`` apart: ``{k: (start, end, error or None)}``."""
    import threading  # noqa: PLC0415

    order = list(order)
    times: dict = {}

    def dump(k):
        time.sleep(stagger_s * order.index(k))
        t0 = time.perf_counter()
        try:
            hook.dump(pids[k], os.path.join(gwork, f"{prefix}-{k}"))
            times[k] = (t0, time.perf_counter(), None)
        except Exception as exc:  # noqa: BLE001 — the caller judges it
            times[k] = (t0, time.perf_counter(), exc)

    threads = [threading.Thread(target=dump, args=(k,)) for k in order]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    return times


def phase_gang(torch, work: str, card: str, *, seed: int,
               device: str = "cuda", cfg=None, batch: int = PP_BATCH,
               seq: int = SEQ, micro: int = PP_MICRO,
               stagger_s: float | None = None) -> dict:
    """Phase 17: four pipeline stages sharing the card over ``LOCAL_GLOO``, cut by
    four port hooks' gang dumps that land staggered (about a step apart
    by default), into ``host-<k>``; every manifest must carry one step.
    The sources resume to cut + 3 (the reference); four fresh ranks
    restore and must continue bit for bit. ``device`` and the shape other
    than the defaults rehearse it on the CPU (``tests/test_torch_gang.py``)."""
    from grit_tpu_torch.device.hook import HBM_SUBDIR, TpuDeviceCheckpointHook  # noqa: PLC0415
    from grit_tpu_torch.device.snapshot import SnapshotManifest  # noqa: PLC0415
    from grit_tpu_torch.models import llama  # noqa: PLC0415
    from grit_tpu_torch.parallel.collectives import LOCAL_GLOO  # noqa: PLC0415
    from grit_tpu_torch.parallel.launch import run_ranks  # noqa: PLC0415

    cfg = cfg or llama.LlamaConfig.flagship(n_layers=GANG_LAYERS, remat=True)
    on_card = device == "cuda"
    if on_card:
        torch.cuda.empty_cache()
    gwork = os.path.join(work, "gang")
    os.makedirs(gwork)
    spec = gang_spec(gwork, cfg, batch=batch, seq=seq, micro=micro,
                     seed=seed, device=device)
    saved = {k: os.environ.get(k) for k in (
        "GRIT_TPU_SOCKET_DIR", "GRIT_SLICE_HOSTS", "GRIT_SLICE_NONCE")}
    os.environ.update(GRIT_TPU_SOCKET_DIR=spec["sockdir"],
                      GRIT_SLICE_HOSTS=str(N_RANKS), GRIT_SLICE_NONCE="17")
    src = GangSources(spec)
    try:
        pids = src.pids()
        src.wait_steps(GANG_READY_STEP)
        step_s = (src.t_step[GANG_READY_STEP] - src.t_step[1]) / max(
            1, GANG_READY_STEP - 1)
        if stagger_s is None:
            stagger_s = step_s
        hook = TpuDeviceCheckpointHook(timeout=600)
        times = gang_dumps(hook, pids, gwork, range(N_RANKS), stagger_s)
        bad = {k: v[2] for k, v in times.items() if v[2] is not None}
        if bad or len(times) != N_RANKS:
            raise AssertionError(f"gang: dumps failed: {bad}")
        manifests = [SnapshotManifest.load(os.path.join(
            gwork, f"host-{k}", HBM_SUBDIR)) for k in range(N_RANKS)]
        cuts = [m.meta["step"] for m in manifests]
        if len(set(cuts)) != 1:
            raise AssertionError(f"gang: the manifests' steps differ: {cuts}")
        if any(m.process_count != 1 for m in manifests):
            raise AssertionError("gang: a host's tree is not its own "
                                 "single-process snapshot")
        cut = cuts[0]
        parked = [src.status(p) for p in pids]
        if not all(s["paused"] and s["slice"]["cut"] == cut for s in parked):
            raise AssertionError(f"gang: not every rank parked at {cut}: "
                                 f"{parked}")
        blackout = max(v[1] for v in times.values()) - min(
            v[0] for v in times.values())
        src.stop_at(cut + GANG_AFTER)
        for p in pids:
            hook.resume(p)
        sources = src.join()
        source_wall = time.perf_counter() - src.started
        t0 = time.perf_counter()
        restored = run_ranks(gang_rank, N_RANKS,
                             dict(spec, mode="restore", stop=cut + GANG_AFTER),
                             backend=LOCAL_GLOO, timeout=900)
        restore_wall = time.perf_counter() - t0
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        src.close()
        shutil.rmtree(gwork, ignore_errors=True)
    return gang_checks(sources, restored, times, cut, blackout, stagger_s,
                       step_s, cfg, (batch, seq), micro, card, on_card,
                       source_wall, restore_wall)


def gang_checks(sources: list[dict], restored: list[dict], times: dict,
                cut: int, blackout: float, stagger_s: float, step_s: float,
                cfg, shape, micro: int, card: str, on_card: bool,
                source_wall: float, restore_wall: float) -> dict:
    """Phase 17's lines and checks over the ranks' records."""
    failures = []
    B, S = shape
    want = list(range(cut + 1, cut + GANG_AFTER + 1))
    for k, (s, r) in enumerate(zip(sources, restored)):
        ref = {t: s["losses"][t] for t in want if t in s["losses"]}
        if r["restored"] != cut or sorted(r["losses"]) != want \
                or r["losses"] != ref:
            failures.append(f"rank {k}: restored {r['restored']} (cut {cut}),"
                            f" losses {r['losses']} against the source's "
                            f"{ref}")
        if r["digest"] != s["digest"]:
            failures.append(f"rank {k}: the restored final state differs "
                            f"from the source's")
        if s["failed"] is not None:
            failures.append(f"rank {k}: the gate failed: {s['failed']}")
        if s["request_step"] is None or s["wait_s"] is None:
            failures.append(f"rank {k}: its gate saw no request or no "
                            f"barrier: {s['request_step']}, {s['wait_s']}")
        if s["foreign"] or r["foreign"]:
            failures.append(f"rank {k} loaded {s['foreign'] + r['foreign']}")
    if any(s["losses"] != sources[0]["losses"] for s in sources):
        failures.append("the pipelined loss differs between ranks")
    per_step = []
    for recs in (sources, restored):
        per_step.append([{n: r["launches"][n] / max(1, r["steps"])
                          for n in KERNELS} for r in recs])
    if on_card:
        # A step of 3 layers a stage over M + N - 1 ticks, remat: the
        # forward twice a layer a tick, each backward kernel once.
        ticks = micro + N_RANKS - 1
        per = cfg.n_layers // N_RANKS
        step = {"flash_fwd": 2 * ticks * per, "flash_bwd_dq": ticks * per,
                "flash_bwd_dkv": ticks * per}
        for label, rows in zip(("source", "restored"), per_step):
            for k, row in enumerate(rows):
                if row != step:
                    failures.append(f"{label} rank {k}: launches a step "
                                    f"{row}, want {step}")
    pipes = [r["pipe"] for r in restored]
    p0 = pipes[0]
    man = p0["manifest"]
    if man["process_count"] != N_RANKS or not man["staged"] \
            or not man["once"]:
        failures.append(f"pipe axis: the manifest is not one of staged "
                        f"layer leaves, each stage once: {man}")
    for k, p in enumerate(pipes):
        if p["restored"] != p["cut"] or not p["same_state"] or \
                p["restored_loss"] != p["loss"] or not p["after_equal"]:
            failures.append(
                f"pipe axis, rank {k}: restored at {p['restored']} (cut "
                f"{p['cut']}), state equal {p['same_state']}, step losses "
                f"{p['loss']} / {p['restored_loss']}, after "
                f"{p['after_equal']}")
    if any(p["loss"] != p0["loss"] for p in pipes):
        failures.append("pipe axis: the pipelined loss differs between ranks")
    dense_gap = _rel_gap(p0["dense_loss"], p0["loss"])
    if dense_gap >= MESH_LOSS_BOUND:
        failures.append(f"pipe axis: the dense model's loss "
                        f"{p0['dense_loss']} is {dense_gap:.2e} from the "
                        f"pipeline's {p0['loss']}")
    if on_card:
        two = {n: 2 * v for n, v in step.items()}
        bad = [p["launches"] for p in pipes if p["launches"] != two]
        if bad:
            failures.append(f"pipe axis: launches {bad[:2]}, want {two}")
    dumps = [s["dump"] for s in sources]
    log("gang", f"{N_RANKS} pipeline stages on one card over LOCAL_GLOO: dim "
                f"{cfg.dim}, {cfg.n_layers} layers in stages of "
                f"{cfg.n_layers // N_RANKS}, remat, B {B} x S {S} in {micro} "
                f"microbatches, Adam {GANG_LR}; state a rank "
                f"{[s['state_bytes'] for s in sources]} B (sum "
                f"{sum(s['state_bytes'] for s in sources)}); a step "
                f"{step_s:.3f} s; four port hooks' gang dumps started "
                f"{stagger_s:.3f} s apart [{card}]")
    log("gang", f"cut at step {cut}, the same in all {N_RANKS} manifests; "
                f"request arrived at step "
                f"{[s['request_step'] for s in sources]}, barrier wait s "
                f"{[s['wait_s'] and round(s['wait_s'], 4) for s in sources]} [{card}]")
    log("gang", f"dump s a rank {[round(d['wall'], 3) for d in dumps]}, "
                f"bytes written {[d['bytes'] for d in dumps]} of "
                f"{[d['total_bytes'] for d in dumps]} (the rest referenced "
                f"from the -spec pass); hook dump s (request to commit) "
                f"{[round(times[k][1] - times[k][0], 3) for k in range(N_RANKS)]};"
                f" gang blackout (first request to the last rank's commit) "
                f"{blackout:.3f} s; peak {[s['peak'] for s in sources]} B "
                f"[{card}]")
    log("gang", f"restore s a rank {[round(r['restore_s'], 3) for r in restored]}"
                f"; every rank's losses after the cut {want} and final state "
                f"bitwise equal to its source's resumed run: "
                f"{not failures}; launches a rank a step (sources; restored) "
                f"{per_step[0][0]}; {per_step[1][0]}; source launch "
                f"{source_wall:.1f} s, restore launch {restore_wall:.1f} s "
                f"[{card}]")
    log("gang", f"pipe axis (phase 20): the restored stages' pipelined "
                f"Trainer on a pipe mesh wrote one manifest at step "
                f"{p0['cut']} ({man['arrays']} arrays; {man['layer_leaves']} "
                f"layer leaves staged ({N_RANKS}, ...), {man['spec']}, a "
                f"stage's chunk from each rank; embedding, norm, lm_head "
                f"once: {man['once']}); dump s "
                f"{[round(p['dump_s'], 3) for p in pipes]}, bytes a rank "
                f"{[p['dump']['bytes'] for p in pipes]}; a fresh pipelined "
                f"Trainer's restore s {[round(p['restore_s'], 3) for p in pipes]}"
                f", its state and next step bitwise: "
                f"{all(p['same_state'] and p['after_equal'] for p in pipes)}; "
                f"the dense model from the staged arrays: loss "
                f"{p0['dense_loss']} against the pipeline's {p0['loss']} "
                f"(gap {dense_gap:.2e}, bound {MESH_LOSS_BOUND}); the round"
                f" took {p0['wall_s']:.1f} s [{card}]")
    if failures:
        raise AssertionError("gang: " + "; ".join(failures))
    return {"cut": cut, "request_steps": [s["request_step"] for s in sources],
            "barrier_wait_s": [s["wait_s"] for s in sources],
            "dump_s": [d["wall"] for d in dumps],
            "dump_bytes": [d["bytes"] for d in dumps],
            "total_bytes": [d["total_bytes"] for d in dumps],
            "hook_dump_s": [times[k][1] - times[k][0] for k in range(N_RANKS)],
            "blackout_s": blackout, "stagger_s": stagger_s, "step_s": step_s,
            "restore_s": [r["restore_s"] for r in restored],
            "state_bytes": [s["state_bytes"] for s in sources],
            "peak": [s["peak"] for s in sources],
            "launches_per_step": per_step,
            "pipe": {"cut": p0["cut"], "manifest": man,
                     "dump_s": [p["dump_s"] for p in pipes],
                     "dump_bytes": [p["dump"]["bytes"] for p in pipes],
                     "restore_s": [p["restore_s"] for p in pipes],
                     "loss": p0["loss"], "dense_loss": p0["dense_loss"],
                     "dense_gap": dense_gap,
                     "launches": {n: sum(p["launches"][n] for p in pipes)
                                  for n in KERNELS}},
            "launches": {n: sum(r["launches"][n] for r in sources + restored)
                         + sum(p["launches"][n] for p in pipes)
                         for n in KERNELS}}


# -- phase 18 ------------------------------------------------------------------

MESH_SOURCE = (1, 2, 2)   # (data, fsdp, model): the source's mesh
MESH_OTHER = (2, 1, 2)    # the re-layout a fresh launch restores onto
MESH_LAYERS = 2           # the flagship's widths at phase 8's depth
MESH_STEPS = 3            # sharded steps before the snapshot
MESH_AFTER = 2            # steps after it: the source's and each restore's
MESH_LR = 1e-4
MESH_LOSS_BOUND = 1e-3      # sharded against dense, bf16 (__graft_entry__.py:171-179)
MESH_RELAYOUT_BOUND = 1e-2  # another layout (the JAX package's tests/test_trainer.py:80-96)
GANG_MESH_READY = MESH_STEPS + MESH_AFTER + 1  # phase 20: the sources' step
GANG_MESH_AFTER = 3  # before the hooks; sources and restores run to cut + 3


def mesh_collectives(tr) -> dict:
    """The local gloo group's own counts over the Trainer's mesh groups
    and the world: ``{"<collective> <device type>": [calls, input
    bytes]}`` (:class:`~grit_tpu_torch.parallel.collectives.LocalGloo`)."""
    import torch.distributed as dist  # noqa: PLC0415

    from grit_tpu_torch.parallel.collectives import local_gloo_counts  # noqa: PLC0415

    return local_gloo_counts([dist.group.WORLD] + [
        tr.mesh.get_group(name) for name in tr.mesh.mesh_dim_names])


def mesh_trainer(torch, spec: dict, mesh_shape, moe: bool = False):
    """The flagship at phase 18's depth on Zipf batches with Adam,
    sharded by ``LLAMA_RULES`` on a (data, fsdp, model) mesh of
    ``mesh_shape`` (None: one dense Trainer on this rank); with ``moe``,
    phase 19's bench MoE by ``MOE_LLAMA_RULES``, its loss closing over
    the mesh."""
    from grit_tpu_torch.models import llama, moe_llama  # noqa: PLC0415
    from grit_tpu_torch.parallel.mesh import MeshSpec, build_mesh  # noqa: PLC0415
    from grit_tpu_torch.train.optim import adam  # noqa: PLC0415
    from grit_tpu_torch.train.trainer import Trainer, TrainerConfig  # noqa: PLC0415
    from grit_tpu_torch.workload import zipf_batches  # noqa: PLC0415

    cfg, shape = ((spec["ep"]["cfg"], spec["ep"]["shape"]) if moe
                  else (spec["cfg"], spec["shape"]))
    fam, rules = ((moe_llama, moe_llama.MOE_LLAMA_RULES) if moe
                  else (llama, llama.LLAMA_RULES))
    dev = torch.device(spec["device"])
    mesh = (None if mesh_shape is None
            else build_mesh(MeshSpec(*mesh_shape), dev.type))
    kw = {"mesh": mesh} if moe else {}
    return Trainer(
        loss_fn=lambda p, b: fam.loss_fn(cfg, p, b[0], b[1], **kw),
        init_params=lambda gen, device: fam.init_params(cfg, gen, device),
        batch_fn=zipf_batches(cfg.vocab_size, *shape),
        cfg=TrainerConfig(learning_rate=MESH_LR, seed=spec["seed"],
                          batch_spec=llama.BATCH_SPEC),
        device=dev, optimizer=adam(MESH_LR), mesh=mesh,
        rules=None if mesh is None else rules)


def _locals(tr) -> list:
    """This rank's tensors of the Trainer's state (a DTensor's shard)."""
    from grit_tpu_torch.parallel.sharding import local_shard  # noqa: PLC0415
    from grit_tpu_torch.tree import flatten_with_names  # noqa: PLC0415

    return [local_shard(x) for _, x in flatten_with_names(tr.state)]


def _run_steps(torch, fa, tr, dev, n: int, alone: bool = False) -> dict:
    """``n`` steps of ``tr``: losses, seconds and launches of each. Each
    starts at a barrier of the ranks unless this rank steps ``alone``."""
    out = {"losses": [], "step_s": [], "launches": []}
    for _ in range(n):
        fa.reset_launch_counts()
        _sync(torch, dev)
        t0 = time.perf_counter() if alone else _start(torch, dev)
        out["losses"].append(tr.train_step()["loss"].item())
        _sync(torch, dev)
        out["step_s"].append(time.perf_counter() - t0)
        out["launches"].append(dict(fa.LAUNCHES))
    return out


def reduce_checks(torch, dev) -> list[str]:
    """One all-reduce over the world on ``dev`` (on the card, through the
    ranks' device buffers) of each kind whose exact result an fp32
    accumulator would lose or change: an int64 sum past 2^24, an fp64
    sum below fp32's precision, a bf16 sum and an fp32 maximum, each
    against its exact value. The failures, as lines."""
    import torch.distributed as dist  # noqa: PLC0415

    n, r = dist.get_world_size(), dist.get_rank()
    tri = n * (n - 1) // 2
    cases = {
        "int64 sum": ([2 ** 40 + r, -(2 ** 33) * r], torch.int64,
                      dist.ReduceOp.SUM, [n * 2 ** 40 + tri, -(2 ** 33) * tri]),
        "float64 sum": ([1 + r * 2.0 ** -40], torch.float64,
                        dist.ReduceOp.SUM, [n + tri * 2.0 ** -40]),
        "bfloat16 sum": ([r + 1.0], torch.bfloat16, dist.ReduceOp.SUM,
                         [n * (n + 1) / 2]),
        "float32 max": ([float(r), -float(r)], torch.float32,
                        dist.ReduceOp.MAX, [n - 1.0, 0.0]),
    }
    failures = []
    for name, (mine, dtype, op, want) in cases.items():
        x = torch.tensor(mine, dtype=dtype, device=dev)
        dist.all_reduce(x, op=op)
        got = x.cpu()
        if not torch.equal(got, torch.tensor(want, dtype=dtype)):
            failures.append(f"all_reduce {name} on {dev.type}: "
                            f"{got.tolist()}, want {want}")
    return failures


def _fingerprint(torch, x) -> str:
    """A digest of ``x``'s bytes computed on its device: the sums of each
    block of 4096 32-bit words, each word weighted by its place in the
    block (exact in int64), then sha256 over those sums, the dtype and
    the shape on the host. A changed word, two words swapped and a block
    moved each change it."""
    b = x.detach().reshape(-1).contiguous().view(torch.uint8)
    if b.numel() % 4:
        b = torch.cat([b, b.new_zeros((-b.numel()) % 4)])
    words = b.view(torch.int32).long()
    if words.numel() % 4096:
        words = torch.cat([words, words.new_zeros((-words.numel()) % 4096)])
    sums = (words.view(-1, 4096) * torch.arange(
        1, 4097, dtype=torch.int64, device=words.device)).sum(dim=1)
    h = hashlib.sha256(f"{x.dtype} {tuple(x.shape)}".encode())
    h.update(sums.cpu().numpy().tobytes())
    return h.hexdigest()


def _state_digests(torch, tr) -> dict:
    """:func:`_fingerprint` of each leaf of the Trainer's whole state, by
    name: of a DTensor's gathered ``full_tensor()`` (every rank gathers
    every leaf; rank ``r`` of ``n`` digests leaves ``r``, ``r + n``, ...),
    of a plain tensor itself (a dense Trainer's rank digests them all).
    The ranks' dicts merged are the state's."""
    import torch.distributed as dist  # noqa: PLC0415

    from grit_tpu_torch.parallel.sharding import is_dtensor  # noqa: PLC0415
    from grit_tpu_torch.tree import flatten_with_names  # noqa: PLC0415

    rank, n = ((0, 1) if tr.mesh is None
               else (dist.get_rank(), dist.get_world_size()))
    out = {}
    for k, (name, x) in enumerate(flatten_with_names(tr.state)):
        full = x.full_tensor() if is_dtensor(x) else x
        if k % n == rank:
            out[name] = _fingerprint(torch, full)
    return out


def train_source(torch, fa, spec: dict, dev, rank: int,
                 moe: bool = False) -> dict:
    """A source rank's training half of phase 18 (``moe``: of phase 19):
    :data:`MESH_STEPS` sharded steps on :data:`MESH_SOURCE` (the first's
    routed and kept expert slots counted, the collectives of those after
    it), the sharded snapshot, :data:`MESH_AFTER` more steps; rank 0 then
    runs the dense Trainer's steps."""
    import torch.distributed as dist  # noqa: PLC0415

    from grit_tpu_torch.device.snapshot import last_write  # noqa: PLC0415

    out: dict = {}
    tr = mesh_trainer(torch, spec, MESH_SOURCE, moe)
    out["coord"] = list(tr.mesh.get_coordinate())
    _reset_peak(torch, dev)
    with RouteCounts() as routes:
        out.update(_run_steps(torch, fa, tr, dev, 1))
    out["routes"] = routes.totals()
    before = mesh_collectives(tr)
    more = _run_steps(torch, fa, tr, dev, MESH_STEPS - 1)
    for k in ("losses", "step_s", "launches"):
        out[k] += more[k]
    out["collectives"] = {  # a step's, the mean of those after the first
        k: [(c - before.get(k, [0, 0])[0]) / (MESH_STEPS - 1),
            (b - before.get(k, [0, 0])[1]) / (MESH_STEPS - 1)]
        for k, (c, b) in mesh_collectives(tr).items()}
    out["peak"] = _peak(torch, dev)
    out["state_bytes"] = sum(x.numel() * x.element_size()
                             for x in _locals(tr))
    t0 = _start(torch, dev)
    tr.snapshot(spec["ep_snap" if moe else "snap"])
    out["dump_s"] = time.perf_counter() - t0
    out["dump"] = last_write()
    out["cut"] = _state_digests(torch, tr)
    out["after"] = _run_steps(torch, fa, tr, dev, MESH_AFTER)
    out["digest"] = _digest(torch, _locals(tr))
    if spec.get("gang") and not moe:
        out["gang"] = gang_mesh_source(torch, fa, spec, dev, rank, tr)
    del tr
    _release(torch, dev)
    if rank == 0:
        dense = mesh_trainer(torch, spec, None, moe)
        _reset_peak(torch, dev)
        with RouteCounts() as routes:
            out["dense"] = _run_steps(torch, fa, dense, dev, 1, alone=True)
        out["dense"]["routes"] = routes.totals()
        more = _run_steps(torch, fa, dense, dev, MESH_STEPS - 1, alone=True)
        for k in ("losses", "step_s", "launches"):
            out["dense"][k] += more[k]
        out["dense"]["peak"] = _peak(torch, dev)
        out["dense_state_bytes"] = sum(
            x.numel() * x.element_size() for x in _locals(dense))
        del dense
        _release(torch, dev)
    dist.barrier()
    return out


def train_restore(torch, fa, spec: dict, dev, rank: int,
                  moe: bool = False) -> dict:
    """A fresh rank's training half of phase 18 (``moe``: of phase 19):
    the snapshot restored onto :data:`MESH_SOURCE` and onto
    :data:`MESH_OTHER`, and on rank 0 into a dense Trainer, each one's
    state at the cut digested and :data:`MESH_AFTER` steps taken."""
    import torch.distributed as dist  # noqa: PLC0415

    snap = spec["ep_snap" if moe else "snap"]
    out: dict = {}
    for key, shape in (("same", MESH_SOURCE), ("other", MESH_OTHER),
                       ("dense", None)):
        if shape is None and rank != 0:
            continue
        tr = mesh_trainer(torch, spec, shape, moe)
        t0 = time.perf_counter() if shape is None else _start(torch, dev)
        step = tr.restore(snap)
        _sync(torch, dev)
        out[key] = {"step": step, "restore_s": time.perf_counter() - t0,
                    "cut": _state_digests(torch, tr),
                    **_run_steps(torch, fa, tr, dev, MESH_AFTER,
                                 alone=shape is None)}
        if shape is not None:
            out[key]["digest"] = _digest(torch, _locals(tr))
        del tr
        _release(torch, dev)
    if spec.get("gang") and not moe:
        out["gang"] = gang_mesh_restore(torch, fa, spec, dev, rank)
    dist.barrier()
    return out


def gang_mesh_source(torch, fa, spec: dict, dev, rank: int, tr) -> dict:
    """Phase 20 on a source rank, in phase 18's launch: the sharded
    flagship ``tr`` trains on behind an ``Agentlet(lambda: tr.state)``
    whose slice gate meets the other ranks over a file rendezvous, with
    the lockstep collective; the pid is published for the port's hooks,
    and the loop steps until the stop file names a step reached. Its
    losses, the gate's numbers, its leg's dump and final shards'
    digest."""
    import torch.distributed as dist  # noqa: PLC0415

    from grit_tpu_torch.device.agentlet import Agentlet  # noqa: PLC0415
    from grit_tpu_torch.device.snapshot import last_write  # noqa: PLC0415
    from grit_tpu_torch.parallel.coordination import (  # noqa: PLC0415
        FileRendezvous,
        SliceCoordinator,
        SliceQuiesceGate,
        group_any,
    )

    t_gang = time.perf_counter()
    g = spec["gang"]
    n = dist.get_world_size()
    os.environ["GRIT_TPU_SOCKET_DIR"] = g["sockdir"]
    gate = SliceQuiesceGate(
        SliceCoordinator(FileRendezvous(os.path.join(g["work"], "rdv"), rank,
                                        n), process_index=rank,
                         process_count=n),
        lockstep=group_any())
    agentlet = Agentlet(lambda: tr.state, step_fn=lambda: tr.step,
                        slice_gate=gate).start()
    _write_atomic(os.path.join(g["work"], f"pid-{rank}"), str(os.getpid()))
    stop_file = os.path.join(g["work"], "stop")
    out: dict = {"losses": {}, "step_s": []}
    first = tr.step
    fa.reset_launch_counts()
    try:
        while True:
            t0 = time.perf_counter()
            loss = tr.train_step()["loss"].item()
            out["step_s"].append(time.perf_counter() - t0)
            out["losses"][tr.step] = loss
            agentlet.checkpoint_point()
            try:
                with open(stop_file) as f:
                    stop = int(f.read())
            except (OSError, ValueError):
                stop = None
            if stop is not None and tr.step >= stop:
                break
    finally:
        agentlet.stop()
    out.update(steps=tr.step - first, launches=dict(fa.LAUNCHES),
               request_step=gate.request_step, wait_s=gate.wait_s,
               failed=gate.failed, dump=last_write(),
               digest=_device_digest(torch, _locals(tr)),
               wall_s=time.perf_counter() - t_gang)
    return out


def gang_mesh_restore(torch, fa, spec: dict, dev, rank: int) -> dict:
    """Phase 20 on a fresh rank: its own leg restored onto
    :data:`MESH_SOURCE` by post-copy (``GRIT_RESTORE_POSTCOPY``: the hot
    set, then the tail joined by the first step), and the legs' merged
    view onto :data:`MESH_OTHER` blocking; each steps to the sources'
    stop."""
    t_gang = time.perf_counter()
    g = spec["gang"]
    out: dict = {}
    for key, shape in (("same", MESH_SOURCE), ("other", MESH_OTHER)):
        postcopy = key == "same"
        tr = mesh_trainer(torch, spec, shape)
        if postcopy:
            os.environ["GRIT_RESTORE_POSTCOPY"] = "1"
        try:
            t0 = _start(torch, dev)
            step = tr.restore(os.path.join(g["work"], f"host-{rank}", "hbm")
                              if postcopy else g["merged"])
            _sync(torch, dev)
            res = {"step": step, "restore_s": time.perf_counter() - t0}
        finally:
            os.environ.pop("GRIT_RESTORE_POSTCOPY", None)
        handle = tr.postcopy
        res["pending"] = handle is not None
        res["losses"], res["step_s"] = {}, []
        fa.reset_launch_counts()
        while tr.step < g["stop"]:
            t0 = time.perf_counter()
            loss = tr.train_step()["loss"].item()
            res["step_s"].append(time.perf_counter() - t0)
            res["losses"][tr.step] = loss
        res["launches"] = dict(fa.LAUNCHES)
        res["steps"] = len(res["losses"])
        if handle is not None:
            res["hot_s"], res["tail_s"] = handle.hot_s, handle.tail_s
        res["digest"] = _device_digest(torch, _locals(tr))
        out[key] = res
        del tr
        _release(torch, dev)
    out["wall_s"] = time.perf_counter() - t_gang
    return out


def mesh_rank(spec: dict) -> dict:
    """Phases 18 and 19 on one rank. ``"source"``: the exact all-reduces,
    then :func:`train_source` of the flagship; ``"restore"``:
    :func:`train_restore` of it. With ``spec["ep"]`` (phase 19's models)
    each mode then runs the same for the bench MoE and the serving grids'
    half (:func:`grid_source`, :func:`grid_restore`)."""
    import torch  # noqa: PLC0415
    import torch.distributed as dist  # noqa: PLC0415

    from grit_tpu_torch.ops import flash_attention as fa  # noqa: PLC0415

    dev = torch.device(spec["device"])
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
    rank = dist.get_rank()
    out: dict = {"foreign": sorted(
        m for m in sys.modules
        if m.split(".")[0] in ("jax", "jaxlib", "grit_tpu"))}
    source = spec["mode"] == "source"
    if source:
        out["reduce_failures"] = reduce_checks(torch, dev)
    train, grid = ((train_source, grid_source) if source
                   else (train_restore, grid_restore))
    out.update(train(torch, fa, spec, dev, rank))
    if spec.get("ep"):
        out["ep"] = train(torch, fa, spec, dev, rank, moe=True)
        out["grid"] = grid(torch, fa, spec, dev, rank)
    return out


def mesh_manifest_checks(snap: str, dense_state_bytes: int) -> dict:
    """The committed sharded snapshot: one manifest of :data:`N_RANKS`
    processes whose arrays all carry the ``named`` descriptor of
    :data:`MESH_SOURCE`, each array covered exactly once by its chunks
    (disjoint boxes whose volumes sum to its size), the chunks' bytes
    summing to the dense state's."""
    with open(os.path.join(snap, "MANIFEST.json")) as f:
        manifest = json.load(f)
    failures = []
    if manifest["process_count"] != N_RANKS:
        failures.append(f"process_count {manifest['process_count']}")
    total = 0
    for rec in manifest["arrays"]:
        desc = rec["sharding"]
        if desc.get("type") != "named" or desc["mesh_shape"] != list(
                MESH_SOURCE):
            failures.append(f"{rec['name']}: descriptor {desc}")
        boxes = [c["index"] for c in rec["chunks"]]
        volume = sum(math.prod(b - a for a, b in box) for box in boxes)
        overlap = any(all(max(a0, a1) < min(b0, b1) for (a0, b0), (a1, b1)
                          in zip(p, q))
                      for i, p in enumerate(boxes) for q in boxes[i + 1:])
        if volume != math.prod(rec["shape"]) or overlap:
            failures.append(f"{rec['name']}: chunks {boxes} do not cover "
                            f"{rec['shape']} exactly once")
        total += sum(c["nbytes"] for c in rec["chunks"])
    if total != dense_state_bytes:
        failures.append(f"chunk bytes {total} != the state's "
                        f"{dense_state_bytes}")
    return {"failures": failures, "arrays": len(manifest["arrays"]),
            "chunks": sum(len(r["chunks"]) for r in manifest["arrays"]),
            "bytes": total,
            "wq": next(r["sharding"] for r in manifest["arrays"]
                       if r["name"] == "['params']['layers']['attn']['wq']")}


def phase_mesh(torch, work: str, card: str, *, seed: int,
               device: str = "cuda", cfg=None,
               shape: tuple = (BATCH, SEQ), ep: dict | None = None,
               gang: bool = False) -> dict:
    """Phase 18: the flagship at :data:`MESH_LAYERS` layers sharded over a
    (1,2,2) mesh of four ranks sharing the card over ``LOCAL_GLOO``, its sharded
    snapshot, and a fresh launch that restores it onto (1,2,2) (bitwise),
    onto (2,1,2) and into a dense Trainer (within 1e-2). ``device`` and a
    ``cfg`` other than the defaults rehearse it on the CPU.

    ``ep`` (:func:`ep_config`): phase 19 in the same two launches, the bench
    MoE expert-parallel and both serving grids sharded, its record under
    ``"ep"``; with it, phase 20's post-copy restore of each grid.

    ``gang``: phase 20 in the same two launches: the sharded flagship
    trains on behind each rank's agentlet and slice gate, four port hooks
    under ``GRIT_SLICE_HOSTS`` cut it at one step into ``host-<k>`` legs,
    and the fresh launch restores each rank's leg onto (1,2,2) by
    post-copy (bitwise) and the legs' merged view onto (2,1,2) (within
    1e-2); its record under ``"gang"``."""
    from grit_tpu_torch.models import llama  # noqa: PLC0415
    from grit_tpu_torch.parallel.collectives import LOCAL_GLOO  # noqa: PLC0415
    from grit_tpu_torch.parallel.launch import run_ranks  # noqa: PLC0415

    cfg = cfg or llama.LlamaConfig.flagship(n_layers=MESH_LAYERS)
    on_card = device == "cuda"
    if on_card:
        torch.cuda.empty_cache()
    mwork = os.path.join(work, "mesh")
    os.makedirs(mwork)
    spec = {"device": device, "seed": seed, "cfg": cfg, "shape": shape,
            "snap": os.path.join(mwork, "snap"), "ep": ep,
            "ep_snap": os.path.join(mwork, "ep-snap"),
            "grid_snap": os.path.join(mwork, "grids")}
    cut_rec = None
    try:
        t0 = time.perf_counter()
        if gang:
            sources, cut_rec = gang_mesh_cut(spec, mwork)
        else:
            sources = run_ranks(mesh_rank, N_RANKS, dict(spec, mode="source"),
                                backend=LOCAL_GLOO, timeout=900)
        source_wall = time.perf_counter() - t0
        manifest = mesh_manifest_checks(spec["snap"],
                                        sources[0]["dense_state_bytes"])
        if ep:
            ep_manifest = ep_manifest_checks(
                spec["ep_snap"], sources[0]["ep"]["dense_state_bytes"])
        t0 = time.perf_counter()
        restored = run_ranks(mesh_rank, N_RANKS, dict(spec, mode="restore"),
                             backend=LOCAL_GLOO, timeout=900)
        restore_wall = time.perf_counter() - t0
    finally:
        shutil.rmtree(mwork, ignore_errors=True)
    out = mesh_checks(sources, restored, manifest, cfg, shape, card,
                      on_card, source_wall, restore_wall)
    if ep:
        out["ep"] = ep_checks(sources, restored, ep_manifest, ep, card,
                              on_card)
    if gang:
        out["gang"] = gang_mesh_checks(sources, restored, cut_rec, cfg,
                                       card, on_card)
    return out


def gang_mesh_cut(spec: dict, mwork: str) -> tuple[list[dict], dict]:
    """Phase 20's cut, around phase 18's source launch (run from a
    thread): once every rank is past :data:`GANG_MESH_READY`, four port
    hooks under ``GRIT_SLICE_HOSTS`` dump one rank each into
    ``host-<k>`` from four threads started a step apart; every leg must
    record one step and every rank be parked there. The sources then
    resume to the cut + :data:`GANG_MESH_AFTER`, and the legs are merged
    for the restore launch (``spec["gang"]`` gains ``stop`` and
    ``merged``). Returns the source ranks' records and the cut's."""
    from grit_tpu_torch.device.hook import HBM_SUBDIR, TpuDeviceCheckpointHook  # noqa: PLC0415
    from grit_tpu_torch.device.snapshot import SnapshotManifest, merge_legs  # noqa: PLC0415

    gwork = os.path.join(mwork, "gang")
    sockdir = os.path.join(gwork, "s")
    os.makedirs(sockdir)
    spec["gang"] = {"work": gwork, "sockdir": sockdir}
    saved = {k: os.environ.get(k) for k in (
        "GRIT_TPU_SOCKET_DIR", "GRIT_SLICE_HOSTS", "GRIT_SLICE_NONCE")}
    os.environ.update(GRIT_TPU_SOCKET_DIR=sockdir,
                      GRIT_SLICE_HOSTS=str(N_RANKS), GRIT_SLICE_NONCE="20")
    src = GangSources(dict(spec, mode="source", work=gwork, sockdir=sockdir),
                      fn=mesh_rank)
    try:
        pids = src.pids()
        src.wait_steps(GANG_MESH_READY + 1)
        step_s = src.t_step[GANG_MESH_READY + 1] - src.t_step[GANG_MESH_READY]
        hook = TpuDeviceCheckpointHook(timeout=600)
        times = gang_dumps(hook, pids, gwork, range(N_RANKS), step_s)
        bad = {k: v[2] for k, v in times.items() if v[2] is not None}
        if bad or len(times) != N_RANKS:
            raise AssertionError(f"gang_mesh: dumps failed: {bad}")
        legs = [os.path.join(gwork, f"host-{k}", HBM_SUBDIR)
                for k in range(N_RANKS)]
        manifests = [SnapshotManifest.load(d) for d in legs]
        cuts = [m.meta["step"] for m in manifests]
        if len(set(cuts)) != 1:
            raise AssertionError(f"gang_mesh: the legs' steps differ: {cuts}")
        cut = cuts[0]
        parked = [src.status(p) for p in pids]
        if not all(st["paused"] and st["slice"]["cut"] == cut
                   for st in parked):
            raise AssertionError(f"gang_mesh: not every rank parked at "
                                 f"{cut}: {parked}")
        blackout = max(v[1] for v in times.values()) - min(
            v[0] for v in times.values())
        src.stop_at(cut + GANG_MESH_AFTER)
        for p in pids:
            hook.resume(p)
        sources = src.join()
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        src.close()
    legs_info = [{"process_count": m.process_count,
                  "files": sorted({c["file"] for r in m.arrays
                                   for c in r["chunks"]}),
                  "named": all(r["sharding"].get("type") == "named"
                               for r in m.arrays)} for m in manifests]
    t0 = time.perf_counter()
    merged = merge_legs(os.path.join(gwork, "merged"), legs)
    spec["gang"].update(stop=cut + GANG_MESH_AFTER, merged=merged)
    return sources, {"cut": cut, "times": times, "blackout": blackout,
                     "step_s": step_s, "legs": legs_info,
                     "merge_s": time.perf_counter() - t0}


def gang_mesh_checks(sources: list[dict], restored: list[dict], rec: dict,
                     cfg, card: str, on_card: bool) -> dict:
    """Phase 20's lines and checks over the ranks' records."""
    failures = []
    cut, times = rec["cut"], rec["times"]
    stop = cut + GANG_MESH_AFTER
    want = list(range(cut + 1, stop + 1))
    src = [s["gang"] for s in sources]
    dst = [r["gang"] for r in restored]
    for k, leg in enumerate(rec["legs"]):
        if leg["process_count"] != N_RANKS or not leg["named"] or \
                leg["files"] != [f"data-h{k:04d}.bin"]:
            failures.append(f"leg {k}: {leg}, want rank {k}'s own shards, "
                            "named, as process k of the world")
    for k, (s, r) in enumerate(zip(src, dst)):
        if s["failed"] is not None or s["request_step"] is None \
                or s["wait_s"] is None:
            failures.append(f"rank {k}: the gate failed, or saw no request "
                            f"or barrier: {s['failed']}, "
                            f"{s['request_step']}, {s['wait_s']}")
        ref = {t: s["losses"][t] for t in want if t in s["losses"]}
        same = r["same"]
        if same["step"] != cut or not same["pending"] or \
                sorted(same["losses"]) != want or same["losses"] != ref:
            failures.append(f"rank {k}: the post-copy (1,2,2) restore at "
                            f"{same['step']} (cut {cut}, tail pending "
                            f"{same['pending']}) gave {same['losses']}, the "
                            f"source {ref}")
        if same["digest"] != s["digest"]:
            failures.append(f"rank {k}: the post-copy (1,2,2) restore's "
                            "final shards differ from the source's")
        other = r["other"]
        gaps = [_rel_gap(other["losses"].get(t, math.inf), ref.get(t, 0.0))
                for t in want]
        if other["step"] != cut or max(gaps) >= MESH_RELAYOUT_BOUND:
            failures.append(f"rank {k}: the (2,1,2) restore of the merged "
                            f"legs at {other['step']} gave {other['losses']},"
                            f" gaps {gaps} from the source {ref}")
    if any(s["losses"] != src[0]["losses"] for s in src):
        failures.append("the ranks' losses differ")
    per_step = [{n: x["launches"][n] / max(1, x["steps"]) for n in KERNELS}
                for x in src + [r[key] for r in dst
                                for key in ("same", "other")]]
    if on_card:
        step = {n: float(cfg.n_layers) for n in KERNELS}
        bad = [row for row in per_step if row != step]
        if bad:
            failures.append(f"launches a rank a step {bad[:3]}, want {step}")
    dumps = [s["dump"] for s in src]
    hook_s = [times[k][1] - times[k][0] for k in range(N_RANKS)]
    log("gang_mesh", f"the sharded flagship ({cfg.n_layers} layers, "
                     f"{MESH_SOURCE}) behind each rank's agentlet and slice "
                     f"gate: four port hooks under GRIT_SLICE_HOSTS={N_RANKS}"
                     f" started {rec['step_s']:.3f} s apart (a step) cut it "
                     f"at step {cut} in every leg; requests at steps "
                     f"{[s['request_step'] for s in src]}, barrier wait s "
                     f"{[s['wait_s'] and round(s['wait_s'], 4) for s in src]}"
                     f" [{card}]")
    log("gang_mesh", f"leg dump s a rank {[round(d['wall'], 3) for d in dumps]}"
                     f", bytes written {[d['bytes'] for d in dumps]} of "
                     f"{[d['total_bytes'] for d in dumps]} (the rest from "
                     f"the -spec pass); hook dump s (request to commit) "
                     f"{[round(x, 3) for x in hook_s]}; gang blackout "
                     f"(first request to the last leg's commit) "
                     f"{rec['blackout']:.3f} s; legs merged in "
                     f"{rec['merge_s']:.3f} s [{card}]")
    log("gang_mesh", f"fresh ranks: own leg onto {MESH_SOURCE} by post-copy: "
                     f"hot s {[round(r['same']['hot_s'], 4) for r in dst]}, "
                     f"tail s {[round(r['same']['tail_s'], 4) for r in dst]}"
                     f" (joined by the first step), restore call s "
                     f"{[round(r['same']['restore_s'], 4) for r in dst]}; "
                     f"losses {want} and final shards bitwise the source's: "
                     f"{not any('post-copy' in f for f in failures)}; the "
                     f"merged legs onto {MESH_OTHER}: restore s "
                     f"{[round(r['other']['restore_s'], 3) for r in dst]}, "
                     f"within {MESH_RELAYOUT_BOUND}: "
                     f"{not any('merged' in f for f in failures)}; launches"
                     f" a rank a step {per_step[0]}; the sources' gang "
                     f"section {src[0]['wall_s']:.1f} s, the restores' "
                     f"{dst[0]['wall_s']:.1f} s [{card}]")
    if failures:
        raise AssertionError("gang_mesh: " + "; ".join(failures))
    return {"cut": cut, "blackout_s": rec["blackout"],
            "hook_dump_s": hook_s, "step_s": rec["step_s"],
            "request_steps": [s["request_step"] for s in src],
            "barrier_wait_s": [s["wait_s"] for s in src],
            "dump_s": [d["wall"] for d in dumps],
            "dump_bytes": [d["bytes"] for d in dumps],
            "total_bytes": [d["total_bytes"] for d in dumps],
            "merge_s": rec["merge_s"],
            "postcopy": {k: [r["same"][k] for r in dst]
                         for k in ("restore_s", "hot_s", "tail_s")},
            "other_restore_s": [r["other"]["restore_s"] for r in dst],
            "other_gaps": [[_rel_gap(r["other"]["losses"][t],
                                     s["losses"][t]) for t in want]
                           for s, r in zip(src, dst)],
            "launches_per_step": per_step[0],
            "launches": {n: sum(x["launches"][n] for x in src
                                + [r[key] for r in dst
                                   for key in ("same", "other")])
                         for n in KERNELS}}


def _rel_gap(got: float, want: float) -> float:
    return abs(got - want) / max(1.0, abs(want))


def mesh_checks(sources: list[dict], restored: list[dict], manifest: dict,
                cfg, shape, card: str, on_card: bool, source_wall: float,
                restore_wall: float) -> dict:
    """Phase 18's lines and checks over the ranks' records."""
    failures = list(manifest["failures"])
    B, S = shape
    src0 = sources[0]
    dense = src0["dense"]["losses"]
    gaps = [_rel_gap(a, b) for a, b in zip(src0["losses"], dense)]
    if max(gaps) >= MESH_LOSS_BOUND:
        failures.append(f"sharded losses {src0['losses']} against dense "
                        f"{dense}: gaps {gaps}")
    for k, (s, r) in enumerate(zip(sources, restored)):
        if s["losses"] != src0["losses"] or s["after"]["losses"] != \
                src0["after"]["losses"]:
            failures.append(f"rank {k}: its loss differs from rank 0's")
        if r["same"]["step"] != MESH_STEPS or \
                r["same"]["losses"] != s["after"]["losses"]:
            failures.append(f"rank {k}: the (1,2,2) restore at step "
                            f"{r['same']['step']} gave {r['same']['losses']}, "
                            f"the source {s['after']['losses']}")
        if r["same"]["digest"] != s["digest"]:
            failures.append(f"rank {k}: the (1,2,2) restore's final shards "
                            "differ from the source's")
        if s["foreign"] or r["foreign"]:
            failures.append(f"rank {k} loaded {s['foreign'] + r['foreign']}")
    want = src0["after"]["losses"]
    relayout = {"other": [_rel_gap(a, b) for a, b in
                          zip(restored[0]["other"]["losses"], want)],
                "dense": [_rel_gap(a, b) for a, b in
                          zip(restored[0]["dense"]["losses"], want)]}
    for key, g in relayout.items():
        if max(g) >= MESH_RELAYOUT_BOUND:
            failures.append(f"the {key} restore's losses are {g} from the "
                            f"source's {want}")
    cut = {k: v for s in sources for k, v in s["cut"].items()}
    restored_cut = {
        "(1,2,2)": {k: v for r in restored for k, v in r["same"]["cut"].items()},
        "(2,1,2)": {k: v for r in restored
                    for k, v in r["other"]["cut"].items()},
        "dense": restored[0]["dense"]["cut"]}
    for key, got in restored_cut.items():
        if got != cut:
            bad = sorted(k for k in cut.keys() | got.keys()
                         if got.get(k) != cut.get(k))
            failures.append(f"the {key} restore's state differs from the "
                            f"source's at the cut in {bad[:4]} "
                            f"({len(bad)} leaves)")
    for k, s in enumerate(sources):
        failures += [f"rank {k}: {f}" for f in s["reduce_failures"]]
    colls = src0["collectives"]
    if not colls:
        failures.append("the sharded step issued no collective")
    device_type = "cuda" if on_card else "cpu"
    off_device = [k for k in colls if not k.endswith(" " + device_type)]
    if off_device:
        failures.append(f"collectives off the device: {off_device}")
    per_step = [{n: row[n] for n in KERNELS}
                for r in sources for row in r["launches"] + r["after"]["launches"]]
    per_step += [{n: row[n] for n in KERNELS} for r in restored
                 for key in ("same", "other") for row in r[key]["launches"]]
    per_step += [{n: row[n] for n in KERNELS}
                 for row in src0["dense"]["launches"]
                 + restored[0]["dense"]["launches"]]
    if on_card:
        step = {n: cfg.n_layers for n in KERNELS}
        bad = [row for row in per_step if row != step]
        if bad:
            failures.append(f"launches a rank a step {bad[:3]}, want {step}")
    step_s = [round(median_after_first(s["step_s"]), 4) for s in sources]
    log("mesh", f"{N_RANKS} ranks on one card over LOCAL_GLOO, mesh (data, "
                f"fsdp, model) {MESH_SOURCE}: dim {cfg.dim}, {cfg.n_layers} layers, "
                f"B {B} x S {S}, Adam {MESH_LR}; state a rank "
                f"{[s['state_bytes'] for s in sources]} B of the dense "
                f"{src0['dense_state_bytes']}; a sharded step "
                f"{step_s} s a rank (dense {median_after_first(src0['dense']['step_s']):.4f}"
                f" s); peak {[s['peak'] for s in sources]} B [{card}]")
    log("mesh", f"losses sharded {src0['losses']}, dense {dense}: relative "
                f"gaps {[f'{g:.2e}' for g in gaps]} (bound {MESH_LOSS_BOUND}) "
                f"[{card}]")
    log("mesh", "collectives a sharded step on rank 0, through LOCAL_GLOO "
                "(LocalGloo's count; kind device: calls, input bytes): "
                f"{colls}; every one on the ranks' device: {not off_device} "
                f"[{card}]")
    log("mesh", f"restored state against the source's at the cut, leaf by "
                f"leaf (a digest of each whole tensor, {len(cut)} leaves): "
                + ", ".join(f"{key} bitwise: {got == cut}"
                            for key, got in restored_cut.items())
                + f"; all-reduces int64, fp64, bf16 sums and an fp32 maximum "
                f"exact on every rank: "
                f"{not any(s['reduce_failures'] for s in sources)} [{card}]")
    log("mesh", f"launches a rank a step {per_step[0]} (every sharded and "
                f"dense step, source and restored, alike: "
                f"{len({str(r) for r in per_step}) == 1}) [{card}]")
    log("mesh", f"snapshot: {manifest['arrays']} arrays in "
                f"{manifest['chunks']} named chunks, {manifest['bytes']} B, "
                f"each array covered once; wq {manifest['wq']}; dump s "
                f"{[round(s['dump_s'], 3) for s in sources]}, bytes a rank "
                f"{[s['dump']['bytes'] for s in sources]} [{card}]")
    log("mesh", f"restore s (1,2,2) "
                f"{[round(r['same']['restore_s'], 3) for r in restored]}, "
                f"(2,1,2) {[round(r['other']['restore_s'], 3) for r in restored]}"
                f", dense {restored[0]['dense']['restore_s']:.3f}; (1,2,2) "
                f"losses {restored[0]['same']['losses']} bitwise the source's:"
                f" {not any('(1,2,2)' in f for f in failures)}; (2,1,2) and "
                f"dense relative gaps {relayout} (bound {MESH_RELAYOUT_BOUND});"
                f" step s after the restores (1,2,2) "
                f"{[round(x, 3) for x in restored[0]['same']['step_s']]}, "
                f"(2,1,2) {[round(x, 3) for x in restored[0]['other']['step_s']]};"
                f" source launch {source_wall:.1f} s, restore launch "
                f"{restore_wall:.1f} s [{card}]")
    if failures:
        raise AssertionError("mesh: " + "; ".join(failures))
    return {"mesh": list(MESH_SOURCE), "other": list(MESH_OTHER),
            "losses": src0["losses"], "dense_losses": dense,
            "loss_gaps": gaps, "relayout_gaps": relayout,
            "step_s": [s["step_s"] for s in sources],
            "dense_step_s": src0["dense"]["step_s"],
            "state_bytes": [s["state_bytes"] for s in sources],
            "dense_state_bytes": src0["dense_state_bytes"],
            "peak": [s["peak"] for s in sources],
            "collectives": colls,
            "dump_s": [s["dump_s"] for s in sources],
            "dump_bytes": [s["dump"]["bytes"] for s in sources],
            "restore_s": {k: [r[k]["restore_s"] for r in restored]
                          for k in ("same", "other")},
            "restored_step_s": {k: restored[0][k]["step_s"]
                                for k in ("same", "other")},
            "dense_restore_s": restored[0]["dense"]["restore_s"],
            "launches_per_step": per_step[0],
            "source_wall_s": source_wall, "restore_wall_s": restore_wall,
            "launches": {n: sum(row[n] for row in per_step) for n in KERNELS}}


# -- phase 19 ------------------------------------------------------------------

EP_LAYERS = 12           # the bench MoE at its full depth (MESH_LAYERS if cut)
EP_SHAPE = (16, 512)     # B x S, phase 13's
GRID_OTHER = (1, 1, 4)   # the grids' re-layout: it cuts across the heads
GRID_ROUNDS = 8          # decode rounds each grid's source runs
GRID_CUT = 4             # rounds before its snapshot


def ep_config(torch, *, moe_cfg=None, shape: tuple = EP_SHAPE,
              flagship=None, moe_grid=None) -> dict:
    """Phase 19's models: the bench MoE trained on the mesh, and the two
    serving grids (phase 6's flagship grid at :data:`MESH_LAYERS`, phase
    14's MoE grid), each ``{"cfg", "slots", "max_len", "temperature",
    "prompts", "buckets"}``. The defaults are the card's; the CPU
    rehearsal passes tiny ones."""
    from grit_tpu_torch.models import llama, moe_llama  # noqa: PLC0415

    moe_cfg = moe_cfg or moe_llama.MoeLlamaConfig.bench(n_layers=EP_LAYERS)
    return {
        "cfg": moe_cfg, "shape": tuple(shape),
        "grids": {
            "flagship": flagship or {
                "cfg": llama.LlamaConfig.flagship(n_layers=MESH_LAYERS),
                "slots": SERVE_SLOTS, "max_len": SERVE_MAX_LEN,
                "temperature": 1.0, "prompts": SERVE_PROMPTS,
                "buckets": (16, 64, 256, 1024)},
            "moe": moe_grid or {
                "cfg": moe_cfg, "slots": SERVE_SLOTS,
                "max_len": MOE_SERVE_MAX_LEN, "temperature": 0.0,
                "prompts": MOE_SERVE_PROMPTS,
                "buckets": (16, 64, 256, 1024)}}}


class RouteCounts:
    """Counts the routed and the kept slots of every expert layer while it
    is entered (the route's dispatch one-hot summed on the device; read
    after the step): the dropped share of routed slots."""

    def __init__(self) -> None:
        self.parts: list = []

    def __enter__(self):
        from grit_tpu_torch.ops import moe  # noqa: PLC0415

        self._route = route = moe.route

        def counting(topk_idx, gates, mask_f, *args, **kw):
            out = route(topk_idx, gates, mask_f, *args, **kw)
            self.parts.append((out[0].sum(dtype=mask_f.dtype),
                               mask_f.sum() * topk_idx.shape[1]))
            return out

        moe.route = counting
        return self

    def __exit__(self, *exc) -> None:
        from grit_tpu_torch.ops import moe  # noqa: PLC0415

        moe.route = self._route

    def totals(self) -> tuple[int, int]:
        """(kept, routed) over every layer entered."""
        return (sum(int(k) for k, _ in self.parts),
                sum(int(r) for _, r in self.parts))


_GRID_PARAMS: dict = {}


def grid_engine(torch, spec: dict, name: str, mesh_shape):
    """Grid ``name``'s continuous-batching engine on a (data, fsdp, model)
    mesh of ``mesh_shape`` (None: one device), on weights drawn from the
    phase's seed (made once a process, alike on every rank)."""
    from grit_tpu_torch.models import llama, moe_llama, serving  # noqa: PLC0415
    from grit_tpu_torch.parallel.mesh import MeshSpec, build_mesh  # noqa: PLC0415

    g = spec["ep"]["grids"][name]
    dev = torch.device(spec["device"])
    if name not in _GRID_PARAMS:
        fam = moe_llama if isinstance(g["cfg"], moe_llama.MoeLlamaConfig) \
            else llama
        _GRID_PARAMS[name] = fam.init_params(
            g["cfg"], torch.Generator(device=dev).manual_seed(spec["seed"]),
            dev)
    mesh = (None if mesh_shape is None
            else build_mesh(MeshSpec(*mesh_shape), dev.type))
    return serving.ContinuousBatchingEngine(
        g["cfg"], _GRID_PARAMS[name], serving.BatchingConfig(
            n_slots=g["slots"], max_seq_len=g["max_len"],
            temperature=g["temperature"], seed=spec["seed"],
            prefill_buckets=tuple(g["buckets"])),
        device=dev, mesh=mesh)


def _written_digest(torch, eng) -> str:
    """:func:`_fingerprint` of this rank's cache shard (``k`` then ``v``)
    with every page no step has written zeroed: positions at or past each
    active slot's length, and inactive slots' rows."""
    from grit_tpu_torch.parallel.sharding import dtensor_index, local_shard  # noqa: PLC0415

    st = eng.state
    parts = []
    for name in ("k", "v"):
        x = st["cache"][name]
        local = local_shard(x)
        b0, b1 = (dtensor_index(x)[1] if local is not x
                  else (0, local.shape[1]))
        dev = local.device
        lengths = st["lengths"][b0:b1].to(dev)[None, :, None, None, None]
        active = st["active"][b0:b1].to(dev)[None, :, None, None, None]
        pos = torch.arange(local.shape[2], device=dev)[None, None, :, None,
                                                       None]
        parts.append(_fingerprint(torch, torch.where(
            active & (pos < lengths), local,
            torch.zeros((), dtype=local.dtype, device=dev))))
    return hashlib.sha256("".join(parts).encode()).hexdigest()


def _margins(torch, eng, sink: list) -> None:
    """Record each round's top-2 logit margin of this rank's slots (the
    engine's ragged step wrapped)."""
    fn = eng._ragged_fn

    def wrapped(*args, **kw):
        logits, cache = fn(*args, **kw)
        top = torch.topk(logits[:, -1, :].float(), 2, dim=-1).values
        sink.append((top[:, 0] - top[:, 1]).tolist())
        return logits, cache

    eng._ragged_fn = wrapped


def _rounds(torch, eng, dev, n: int, alone: bool = False) -> tuple:
    """``n`` decode rounds: each round's tokens and seconds (each from a
    barrier of the ranks unless ``alone``)."""
    toks, secs = [], []
    for _ in range(n):
        t0 = time.perf_counter() if alone else _start(torch, dev)
        toks.append(eng.step())
        _sync(torch, dev)
        secs.append(time.perf_counter() - t0)
    return toks, secs


def grid_source(torch, fa, spec: dict, dev, rank: int) -> dict:
    """Phase 19's serving half on a source rank, for each grid: its
    prompts admitted on :data:`MESH_SOURCE`, :data:`GRID_CUT` rounds, the
    sharded snapshot, the rounds up to :data:`GRID_ROUNDS` (each round's
    top-2 logit margins recorded), the written cache's digest; rank 0
    then runs the single-device engine's rounds. No kernel may launch."""
    import torch.distributed as dist  # noqa: PLC0415

    from grit_tpu_torch.parallel.sharding import local_shard  # noqa: PLC0415

    out: dict = {}
    fa.reset_launch_counts()
    for name, g in spec["ep"]["grids"].items():
        gen = torch.Generator().manual_seed(spec["seed"] + 7)
        prompts = [zipf_tokens(torch, n, g["cfg"].vocab_size, gen)
                   for n in g["prompts"]]
        eng = grid_engine(torch, spec, name, MESH_SOURCE)
        margins: list = []
        _margins(torch, eng, margins)
        t0 = _start(torch, dev)
        for p in prompts:
            eng.submit(p)
        _sync(torch, dev)
        res = {"slots": [eng._slots.start, eng._slots.stop],
               "prefill_s": time.perf_counter() - t0}
        res["tokens"], res["round_s"] = _rounds(torch, eng, dev, GRID_CUT)
        t0 = _start(torch, dev)
        eng.snapshot(os.path.join(spec["grid_snap"], name))
        res["dump_s"] = time.perf_counter() - t0
        after, secs = _rounds(torch, eng, dev, GRID_ROUNDS - GRID_CUT)
        res["tokens"] += after
        res["round_s"] += secs
        res["margins"] = margins
        res["written"] = _written_digest(torch, eng)
        res["cache_bytes"] = sum(  # this rank's shards
            local_shard(x).numel() * x.element_size()
            for x in (eng.state["cache"]["k"], eng.state["cache"]["v"]))
        del eng
        if rank == 0:
            solo = grid_engine(torch, spec, name, None)
            for p in prompts:
                solo.submit(p)
            res["solo_tokens"], res["solo_round_s"] = _rounds(
                torch, solo, dev, GRID_ROUNDS, alone=True)
            del solo
        _release(torch, dev)
        dist.barrier()
        out[name] = res
    out["launches"] = dict(fa.LAUNCHES)
    return out


def grid_restore(torch, fa, spec: dict, dev, rank: int) -> dict:
    """Phase 19's serving half on a fresh rank, for each grid: the
    snapshot restored onto :data:`MESH_SOURCE` (the rounds after the cut,
    the written cache's digest), onto :data:`GRID_OTHER`, and on rank 0
    onto one device, each decoding the rounds after the cut."""
    import torch.distributed as dist  # noqa: PLC0415

    out: dict = {}
    fa.reset_launch_counts()
    for name in spec["ep"]["grids"]:
        snap = os.path.join(spec["grid_snap"], name)
        res: dict = {}
        for key, shape in (("same", MESH_SOURCE), ("other", GRID_OTHER),
                           ("dense", None)):
            if shape is None and rank != 0:
                continue
            eng = grid_engine(torch, spec, name, shape)
            t0 = time.perf_counter() if shape is None else _start(torch, dev)
            eng.restore(snap)
            _sync(torch, dev)
            res[key] = {"restore_s": time.perf_counter() - t0}
            res[key]["tokens"], res[key]["round_s"] = _rounds(
                torch, eng, dev, GRID_ROUNDS - GRID_CUT, alone=shape is None)
            if key == "same":
                res[key]["written"] = _written_digest(torch, eng)
            del eng
            _release(torch, dev)
        # Phase 20: the same snapshot onto (1,2,2) by post-copy (the
        # hot bookkeeping, then the cache's shards through the tail).
        eng = grid_engine(torch, spec, name, MESH_SOURCE)
        t0 = _start(torch, dev)
        handle = eng.restore_postcopy(snap)
        res["postcopy"] = {"restore_s": time.perf_counter() - t0,
                           "parked": not eng.resumed_all}
        eng.absorb_restored()
        _sync(torch, dev)
        res["postcopy"].update(hot_s=handle.hot_s, tail_s=handle.tail_s)
        res["postcopy"]["tokens"], _ = _rounds(torch, eng, dev,
                                               GRID_ROUNDS - GRID_CUT)
        res["postcopy"]["written"] = _written_digest(torch, eng)
        del eng
        _release(torch, dev)
        dist.barrier()
        out[name] = res
    out["launches"] = dict(fa.LAUNCHES)
    return out


def _release(torch, dev) -> None:
    if dev.type == "cuda":
        torch.cuda.empty_cache()


def _first_mismatch(got: list, want: list) -> int | None:
    return next((i for i, (a, b) in enumerate(zip(got, want)) if a != b),
                None if len(got) == len(want) else min(len(got), len(want)))


def ep_checks(sources: list[dict], restored: list[dict], manifest: dict,
              ep: dict, card: str, on_card: bool) -> dict:
    """Phase 19's lines and checks over the ranks' records."""
    failures = list(manifest["failures"])
    cfg = ep["cfg"]
    B, S = ep["shape"]
    src = [s["ep"] for s in sources]
    dst = [r["ep"] for r in restored]
    s0 = src[0]
    dense = s0["dense"]["losses"]
    gaps = [_rel_gap(a, b) for a, b in zip(s0["losses"], dense)]
    if max(gaps) >= MESH_LOSS_BOUND:
        failures.append(f"sharded MoE losses {s0['losses']} against dense "
                        f"{dense}: gaps {gaps}")
    for k, (s, r) in enumerate(zip(src, dst)):
        if s["losses"] != s0["losses"] or \
                s["after"]["losses"] != s0["after"]["losses"]:
            failures.append(f"rank {k}: its MoE loss differs from rank 0's")
        if r["same"]["step"] != MESH_STEPS or \
                r["same"]["losses"] != s["after"]["losses"]:
            failures.append(f"rank {k}: the MoE (1,2,2) restore at step "
                            f"{r['same']['step']} gave {r['same']['losses']},"
                            f" the source {s['after']['losses']}")
        if r["same"]["digest"] != s["digest"]:
            failures.append(f"rank {k}: the MoE (1,2,2) restore's final "
                            "shards differ from the source's")
    want = s0["after"]["losses"]
    relayout = {key: [_rel_gap(a, b) for a, b in
                      zip(dst[0][key]["losses"], want)]
                for key in ("other", "dense")}
    for key, g in relayout.items():
        if max(g) >= MESH_RELAYOUT_BOUND:
            failures.append(f"the MoE {key} restore's losses are {g} from "
                            f"the source's {want}")
    cut = {k: v for s in src for k, v in s["cut"].items()}
    restored_cut = {
        "(1,2,2)": {k: v for r in dst for k, v in r["same"]["cut"].items()},
        "(2,1,2)": {k: v for r in dst for k, v in r["other"]["cut"].items()},
        "dense": dst[0]["dense"]["cut"]}
    for key, got in restored_cut.items():
        if got != cut:
            bad = sorted(k for k in cut.keys() | got.keys()
                         if got.get(k) != cut.get(k))
            failures.append(f"the MoE {key} restore's state differs from "
                            f"the source's at the cut in {bad[:4]} "
                            f"({len(bad)} leaves)")
    colls = s0["collectives"]
    device_type = "cuda" if on_card else "cpu"
    off_device = [k for k in colls if not k.endswith(" " + device_type)]
    if not colls or off_device:
        failures.append(f"the sharded MoE step's collectives {colls}: off "
                        f"the device {off_device}")
    per_step = [{n: row[n] for n in KERNELS}
                for s in src for row in s["launches"] + s["after"]["launches"]]
    per_step += [{n: row[n] for n in KERNELS} for r in dst
                 for key in ("same", "other") for row in r[key]["launches"]]
    per_step += [{n: row[n] for n in KERNELS} for row in
                 s0["dense"]["launches"] + dst[0]["dense"]["launches"]]
    if on_card:
        step = {n: cfg.n_layers for n in KERNELS}
        bad = [row for row in per_step if row != step]
        if bad:
            failures.append(f"MoE launches a rank a step {bad[:3]}, want "
                            f"{step}")
    # The drops over the whole batch: the ranks of model coordinate 0
    # hold every batch shard once.
    kept = sum(s["routes"][0] for s in src if s["coord"][-1] == 0)
    routed = sum(s["routes"][1] for s in src if s["coord"][-1] == 0)
    dkept, drouted = s0["dense"]["routes"]
    drops = {"sharded": 1 - kept / routed, "dense": 1 - dkept / drouted}

    grids = {}
    gsrc = [s["grid"] for s in sources]
    gdst = [r["grid"] for r in restored]
    for name, g in ep["grids"].items():
        s = gsrc[0][name]
        if s["tokens"] != s["solo_tokens"]:
            i = _first_mismatch(s["tokens"], s["solo_tokens"])
            failures.append(f"grid {name}: round {i + 1} gave "
                            f"{s['tokens'][i]} on the mesh, "
                            f"{s['solo_tokens'][i]} on one device")
        if any(x[name]["tokens"] != s["tokens"] for x in gsrc):
            failures.append(f"grid {name}: the ranks' tokens differ")
        want_after = s["tokens"][GRID_CUT:]
        for key in ("same", "other", "dense"):
            got = gdst[0][name][key]["tokens"]
            if got != want_after:
                i = _first_mismatch(got, want_after)
                margin = [m for x in gsrc for m in x[name]["margins"][
                    GRID_CUT + i]] if i is not None and \
                    GRID_CUT + i < len(s["margins"]) else None
                failures.append(
                    f"grid {name}: the {key} restore's round {GRID_CUT + i + 1}"
                    f" gave {got[i]}, the source {want_after[i]}; the "
                    f"source's top-2 logit margins there {margin}")
        for k, (a, b) in enumerate(zip(gsrc, gdst)):
            if a[name]["written"] != b[name]["same"]["written"]:
                failures.append(f"grid {name}, rank {k}: the (1,2,2) "
                                "restore's written cache differs from the "
                                "source's")
            pc = b[name]["postcopy"]
            if pc["tokens"] != b[name]["same"]["tokens"] or \
                    pc["written"] != b[name]["same"]["written"] or \
                    not pc["parked"]:
                failures.append(
                    f"grid {name}, rank {k}: the (1,2,2) post-copy restore "
                    f"(parked {pc['parked']}) gave {pc['tokens']}, the "
                    f"blocking one {b[name]['same']['tokens']}, written "
                    f"cache equal {pc['written'] == b[name]['same']['written']}")
        postcopy = {key: [x[name]["postcopy"][key] for x in gdst]
                    for key in ("restore_s", "hot_s", "tail_s")}
        log("gang_mesh", f"grid {name} (phase 20): restored onto "
                         f"{MESH_SOURCE} by post-copy, the source's slots "
                         f"parked until the cache landed, then rounds "
                         f"equal to the blocking restore's and the written "
                         f"cache bitwise on every rank: "
                         f"{all(x[name]['postcopy']['tokens'] == x[name]['same']['tokens'] for x in gdst)}"
                         f"; restore_postcopy s "
                         f"{[round(x, 4) for x in postcopy['restore_s']]}, "
                         f"hot s {[round(x, 4) for x in postcopy['hot_s']]}, "
                         f"tail s {[round(x, 4) for x in postcopy['tail_s']]}"
                         f" [{card}]")
        round_ms = median_after_first(s["round_s"]) * 1e3
        solo_ms = median_after_first(s["solo_round_s"]) * 1e3
        grids[name] = {
            "tokens": sum(len(t) for t in s["tokens"]),
            "round_ms": round_ms, "solo_round_ms": solo_ms,
            "prefill_s": [x[name]["prefill_s"] for x in gsrc],
            "dump_s": [x[name]["dump_s"] for x in gsrc],
            "cache_bytes": [x[name]["cache_bytes"] for x in gsrc],
            "restore_s": {key: [x[name][key]["restore_s"] for x in gdst
                                if key in x[name]]
                          for key in ("same", "other", "dense")},
            "min_margin": min(m for x in gsrc for r in x[name]["margins"]
                              for m in r),
            "postcopy": postcopy}
        log("ep", f"grid {name}: dim {g['cfg'].dim}, {g['cfg'].n_layers} "
                  f"layers, {g['slots']} slots x {g['max_len']}, temperature "
                  f"{g['temperature']}, prompts {tuple(g['prompts'])}; on "
                  f"{MESH_SOURCE} slots a rank "
                  f"{[x[name]['slots'] for x in gsrc]}; {GRID_ROUNDS} rounds"
                  f" ({grids[name]['tokens']} tokens) equal to one device's:"
                  f" {s['tokens'] == s['solo_tokens']}; decode round "
                  f"{round_ms:.3f} ms sharded, {solo_ms:.3f} ms on one "
                  f"device; smallest top-2 logit margin "
                  f"{grids[name]['min_margin']:.4f} [{card}]")
        log("ep", f"grid {name}: snapshot after round {GRID_CUT} (cache "
                  f"{sum(grids[name]['cache_bytes'])} B over the ranks), dump"
                  f" s {[round(x, 3) for x in grids[name]['dump_s']]}; "
                  f"restore s "
                  + ", ".join(f"{k} {[round(x, 3) for x in v]}" for k, v in
                              grids[name]['restore_s'].items())
                  + f"; the (1,2,2), (1,1,4) and dense restores' rounds "
                  f"equal the source's: "
                  f"{[gdst[0][name][k]['tokens'] == want_after for k in ('same', 'other', 'dense')]}"
                  f" [{card}]")
    serve_launches = {n: sum(x["launches"].get(n, 0) for x in gsrc + gdst)
                      for n in KERNELS}
    if any(serve_launches.values()):
        failures.append(f"the grids launched kernels: {serve_launches}")

    step_s = [round(median_after_first(s["step_s"]), 4) for s in src]
    dense_s = median_after_first(s0["dense"]["step_s"])
    log("ep", f"bench MoE (dim {cfg.dim}, {cfg.n_heads} heads of "
              f"{cfg.head_dim}, hidden {cfg.hidden_dim}, {cfg.n_experts} "
              f"experts, top-{cfg.top_k}, capacity {cfg.capacity_factor}, "
              f"{cfg.n_layers} layers) by MOE_LLAMA_RULES on {MESH_SOURCE}, "
              f"B {B} x S {S}, Adam {MESH_LR}: a sharded step {step_s} s a "
              f"rank, dense {dense_s:.4f} s; state a rank "
              f"{[s['state_bytes'] for s in src]} B of the dense "
              f"{s0['dense_state_bytes']}; peak "
              f"{[s['peak'] for s in src]} B (dense {s0['dense']['peak']}) "
              f"[{card}]")
    log("ep", f"MoE losses sharded {s0['losses']}, dense {dense}: relative "
              f"gaps {[f'{x:.2e}' for x in gaps]} (bound {MESH_LOSS_BOUND});"
              f" dropped share of routed slots in the first step: sharded "
              f"{drops['sharded']:.4f}, dense {drops['dense']:.4f} [{card}]")
    log("ep", f"collectives a sharded MoE step on rank 0 (LocalGloo's count;"
              f" kind device: calls, input bytes): {colls} [{card}]")
    log("ep", f"MoE snapshot: {manifest['arrays']} arrays in "
              f"{manifest['chunks']} named chunks, {manifest['bytes']} B; "
              f"w_in {manifest['w_in']}; dump s "
              f"{[round(s['dump_s'], 3) for s in src]}; restore s (1,2,2) "
              f"{[round(r['same']['restore_s'], 3) for r in dst]}, (2,1,2) "
              f"{[round(r['other']['restore_s'], 3) for r in dst]}, dense "
              f"{dst[0]['dense']['restore_s']:.3f}; (1,2,2) bitwise: "
              f"{not any('(1,2,2) restore' in f and 'MoE' in f for f in failures)}"
              f"; (2,1,2) and dense gaps {relayout}; restored state at the "
              f"cut, leaf by leaf: "
              + ", ".join(f"{k} {got == cut}" for k, got in restored_cut.items())
              + f"; launches a rank a step {per_step[0]} [{card}]")
    if failures:
        raise AssertionError("ep: " + "; ".join(failures))
    return {"mesh": list(MESH_SOURCE), "other": list(MESH_OTHER),
            "grid_other": list(GRID_OTHER), "shape": [B, S],
            "losses": s0["losses"], "dense_losses": dense, "loss_gaps": gaps,
            "relayout_gaps": relayout, "drops": drops,
            "step_s": [s["step_s"] for s in src],
            "dense_step_s": s0["dense"]["step_s"],
            "state_bytes": [s["state_bytes"] for s in src],
            "dense_state_bytes": s0["dense_state_bytes"],
            "peak": [s["peak"] for s in src], "dense_peak": s0["dense"]["peak"],
            "collectives": colls,
            "dump_s": [s["dump_s"] for s in src],
            "dump_bytes": [s["dump"]["bytes"] for s in src],
            "restore_s": {k: [r[k]["restore_s"] for r in dst]
                          for k in ("same", "other")},
            "dense_restore_s": dst[0]["dense"]["restore_s"],
            "launches_per_step": per_step[0], "grids": grids,
            "launches": {n: sum(row[n] for row in per_step) for n in KERNELS}}


def ep_manifest_checks(snap: str, dense_state_bytes: int) -> dict:
    """The MoE snapshot, as :func:`mesh_manifest_checks` holds phase 18's,
    and ``w_in``'s descriptor."""
    out = mesh_manifest_checks(snap, dense_state_bytes)
    with open(os.path.join(snap, "MANIFEST.json")) as f:
        arrays = json.load(f)["arrays"]
    out["w_in"] = next(r["sharding"] for r in arrays if r["name"] ==
                       "['params']['layers']['moe']['w_in']")
    if out["w_in"]["spec"] != [None, "model", "fsdp", None]:
        out["failures"].append(f"w_in's descriptor {out['w_in']}")
    return out


# -- main ----------------------------------------------------------------------


# -- phase 21 ------------------------------------------------------------------

N8 = 8                  # phase 21: eight ranks sharing the card
MESH8 = (2, 2, 2)       # (data, fsdp, model), dryrun_multichip(8)'s factoring
MESH8_SHAPE = (4, SEQ)  # B 4 x S 2048: a row a rank of the data x fsdp split
MESH8_STEPS = 2         # sharded steps before the snapshot, each against dense
MESH8_AFTER = 1         # steps after it: the source's and the restore's


@contextlib.contextmanager
def _planted_pp_fault(torch, fault: str | None):
    """With ``fault="swap_expert"``, the dryrun's pp × ep phase places
    each rank's experts of ``w_in`` from its expert peer's half, while its
    dense reference keeps the true weights: the fault phase 21's checks
    must catch."""
    from grit_tpu_torch import entry  # noqa: PLC0415

    if fault != "swap_expert":
        yield
        return
    real = entry.moe_stage_shardings

    class Swapped:
        def __init__(self, sharding):
            self.sharding = sharding

        def distribute(self, x):
            return self.sharding.distribute(
                torch.cat(x.chunk(2, dim=1)[::-1], dim=1))

    def swapped(mesh):
        out = real(mesh)
        out["w_in"] = Swapped(out["w_in"])
        return out

    entry.moe_stage_shardings = swapped
    try:
        yield
    finally:
        entry.moe_stage_shardings = real


def mesh8_rank(spec: dict) -> dict:
    """Phase 21 on one rank of the eight: ``dryrun_multichip``'s three
    phases (``entry.dryrun_phases``), then the flagship at
    :data:`MESH_LAYERS` layers on the (2,2,2) mesh: :data:`MESH8_STEPS`
    sharded steps, its sharded snapshot, :data:`MESH8_AFTER` more; a fresh
    Trainer on the same mesh restores the snapshot and takes the same
    steps; rank 0 then takes the dense Trainer's steps."""
    import torch  # noqa: PLC0415
    import torch.distributed as dist  # noqa: PLC0415

    from grit_tpu_torch import entry  # noqa: PLC0415
    from grit_tpu_torch.ops import flash_attention as fa  # noqa: PLC0415

    dev = torch.device(spec["device"])
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
    rank = dist.get_rank()
    out: dict = {"foreign": sorted(
        m for m in sys.modules
        if m.split(".")[0] in ("jax", "jaxlib", "grit_tpu"))}
    fa.reset_launch_counts()
    t0 = _start(torch, dev)
    with _planted_pp_fault(torch, spec.get("fault")):
        out["dryrun"] = entry.dryrun_phases(dev)
    _sync(torch, dev)
    out["dryrun_s"] = time.perf_counter() - t0
    out["dryrun_launches"] = dict(fa.LAUNCHES)

    tr = mesh_trainer(torch, spec, MESH8)
    out["coord"] = list(tr.mesh.get_coordinate())
    _reset_peak(torch, dev)
    out.update(_run_steps(torch, fa, tr, dev, 1))
    before = mesh_collectives(tr)
    more = _run_steps(torch, fa, tr, dev, MESH8_STEPS - 1)
    for k in ("losses", "step_s", "launches"):
        out[k] += more[k]
    n = MESH8_STEPS - 1
    out["collectives"] = {
        k: [(c - before.get(k, [0, 0])[0]) / n, (b - before.get(k, [0, 0])[1]) / n]
        for k, (c, b) in mesh_collectives(tr).items()}
    out["peak"] = _peak(torch, dev)
    out["state_bytes"] = sum(x.numel() * x.element_size() for x in _locals(tr))
    t0 = _start(torch, dev)
    tr.snapshot(spec["snap"])
    out["dump_s"] = time.perf_counter() - t0
    out["after"] = _run_steps(torch, fa, tr, dev, MESH8_AFTER)
    out["digest"] = _digest(torch, _locals(tr))
    del tr
    _release(torch, dev)
    fresh = mesh_trainer(torch, spec, MESH8)
    t0 = _start(torch, dev)
    out["restored_step"] = fresh.restore(spec["snap"])
    _sync(torch, dev)
    out["restore_s"] = time.perf_counter() - t0
    out["restored"] = _run_steps(torch, fa, fresh, dev, MESH8_AFTER)
    out["restored"]["digest"] = _digest(torch, _locals(fresh))
    del fresh
    _release(torch, dev)
    if rank == 0:
        dense = mesh_trainer(torch, spec, None)
        out["dense"] = _run_steps(torch, fa, dense, dev, MESH8_STEPS,
                                  alone=True)
        del dense
        _release(torch, dev)
    dist.barrier()
    return out


def phase_mesh8(torch, work: str, card: str, *, seed: int,
                device: str = "cuda", cfg=None, shape: tuple = MESH8_SHAPE,
                fault: str | None = None) -> dict:
    """Phase 21: one launch of :data:`N8` ranks sharing the card over
    ``LOCAL_GLOO`` (:func:`mesh8_rank`): ``dryrun_multichip(8)``'s three
    phases and the flagship on (2,2,2), its step within
    :data:`MESH_LOSS_BOUND` of dense and its snapshot restored bitwise in
    the same launch; then ``entry()`` in this process on the card, its
    logits finite. ``device``, ``cfg`` and ``shape`` other than the
    defaults rehearse it on the CPU; ``fault="swap_expert"`` plants a
    fault the checks must catch."""
    from grit_tpu_torch import entry  # noqa: PLC0415
    from grit_tpu_torch.models import llama  # noqa: PLC0415
    from grit_tpu_torch.parallel.collectives import LOCAL_GLOO  # noqa: PLC0415
    from grit_tpu_torch.parallel.launch import run_ranks  # noqa: PLC0415

    cfg = cfg or llama.LlamaConfig.flagship(n_layers=MESH_LAYERS)
    on_card = device == "cuda"
    if on_card:
        torch.cuda.empty_cache()
    mwork = os.path.join(work, "mesh8")
    os.makedirs(mwork)
    spec = {"device": device, "seed": seed, "cfg": cfg, "shape": shape,
            "snap": os.path.join(mwork, "snap"), "fault": fault}
    t0 = time.perf_counter()
    try:
        ranks = run_ranks(mesh8_rank, N8, spec, backend=LOCAL_GLOO,
                          timeout=900)
    finally:
        shutil.rmtree(mwork, ignore_errors=True)
    wall = time.perf_counter() - t0
    failures = [f"rank {k} loaded {r['foreign']}" for k, r in enumerate(ranks)
                if r["foreign"]]
    dry = ranks[0]["dryrun"]
    failures += entry.dryrun_misses(dry)
    if len({json.dumps([r["dryrun"]["step"], r["dryrun"]["sp"],
                        r["dryrun"]["pp"]["loss"]]) for r in ranks}) != 1:
        failures.append("the dryrun's numbers differ between ranks")
    log("mesh8", entry.dryrun_summary(dry, N8, card) + f"; the three phases "
                 f"took {[round(r['dryrun_s'], 2) for r in ranks]} s a rank "
                 f"[{card}]")
    src0 = ranks[0]
    dense = src0["dense"]["losses"]
    gaps = [_rel_gap(a, b) for a, b in zip(src0["losses"], dense)]
    if not max(gaps) <= MESH_LOSS_BOUND:
        failures.append(f"(2,2,2) losses {src0['losses']} against dense "
                        f"{dense}: gaps {gaps}")
    for k, r in enumerate(ranks):
        if r["restored_step"] != MESH8_STEPS or \
                r["restored"]["losses"] != r["after"]["losses"] or \
                r["restored"]["digest"] != r["digest"]:
            failures.append(f"rank {k}: the restore onto (2,2,2) is not "
                            f"bitwise: step {r['restored_step']}, losses "
                            f"{r['restored']['losses']} vs "
                            f"{r['after']['losses']}")
    per_step = [{n: row[n] for n in KERNELS} for r in ranks
                for row in r["launches"] + r["after"]["launches"]
                + r["restored"]["launches"]]
    per_step += [{n: row[n] for n in KERNELS}
                 for row in src0["dense"]["launches"]]
    if on_card:
        step = {n: cfg.n_layers for n in KERNELS}
        bad = [row for row in per_step if row != step]
        if bad:
            failures.append(f"launches a rank a step {bad[:3]}, want {step}")
    t0 = time.perf_counter()
    fn, args = entry.entry(device=device)
    logits = fn(*args)
    entry_s = time.perf_counter() - t0
    if not bool(torch.isfinite(logits).all()):
        failures.append("entry()'s logits are not finite")
    colls = {k: [round(c, 2), int(b)] for k, (c, b) in
             sorted(src0["collectives"].items())}
    B, S = shape
    step_s = [round(median_after_first(r["step_s"]), 4) for r in ranks]
    log("mesh8", f"{N8} ranks on one card over LOCAL_GLOO, mesh (data, fsdp, "
                 f"model) {MESH8}: dim {cfg.dim}, {cfg.n_layers} layers, B {B} "
                 f"x S {S}, Adam {MESH_LR}; losses sharded {src0['losses']}, "
                 f"dense {dense} (relative gaps "
                 f"{[f'{g:.2e}' for g in gaps]}, bound {MESH_LOSS_BOUND}); a "
                 f"sharded step {step_s} s a rank (dense "
                 f"{median_after_first(src0['dense']['step_s']):.4f} s); "
                 f"state a rank {[r['state_bytes'] for r in ranks]} B; peak "
                 f"{[r['peak'] for r in ranks]} B [{card}]")
    log("mesh8", f"collectives a sharded step on rank 0 (kind device: calls, "
                 f"input bytes): {colls}; launches a rank a step "
                 f"{per_step[0]} (all alike: {len({str(r) for r in per_step}) == 1})"
                 f" [{card}]")
    log("mesh8", f"snapshot on (2,2,2): dump s "
                 f"{[round(r['dump_s'], 3) for r in ranks]}; restored in the "
                 f"same launch onto (2,2,2) at step {src0['restored_step']} "
                 f"in {[round(r['restore_s'], 3) for r in ranks]} s, next "
                 f"step's loss and every rank's shards bitwise: "
                 f"{not any('bitwise' in f for f in failures)}; launched and "
                 f"run in {wall:.1f} s; entry() on {device}: logits "
                 f"{tuple(logits.shape)} finite in {entry_s:.2f} s [{card}]")
    if failures:
        raise AssertionError("mesh8: " + "; ".join(failures))
    return {"dryrun": dry, "wall_s": wall, "mesh": list(MESH8),
            "flagship": {"losses": src0["losses"], "dense": dense,
                         "gaps": gaps, "step_s": step_s,
                         "dense_step_s": median_after_first(
                             src0["dense"]["step_s"]),
                         "peak": [r["peak"] for r in ranks],
                         "state_bytes": [r["state_bytes"] for r in ranks],
                         "collectives": colls,
                         "dump_s": [r["dump_s"] for r in ranks],
                         "restore_s": [r["restore_s"] for r in ranks],
                         "restore_bitwise": True},
            "launches_per_step": per_step[0],
            "launches": {n: sum(row[n] for row in per_step)
                         + sum(r["dryrun_launches"][n] for r in ranks)
                         for n in KERNELS},
            "entry": {"shape": list(logits.shape), "s": entry_s}}


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
                 f"into {os.path.relpath(build.build_dir(), REPO)}")
    ptxas_report(build)
    kern = phase_kernels(torch, fa, device["smi"])
    train = phase_train(torch, fa)
    work = tempfile.mkdtemp(prefix="chip-smoke-")
    try:
        migrate = phase_migrate(work, device["smi"])
        serve = phase_serving(torch, fa, work, device["smi"], seed=args.seed)
        torch.cuda.empty_cache()
        io = phase_io(torch, work, device["smi"])
        early = early_sources(work)
        try:
            precopy = phase_precopy(work, device["smi"],
                                    source=early["precopy"])
            frozen = phase_frozen(work, device["smi"], train=train,
                                  source=early["frozen"])
            wire = phase_wire(torch, work, device["smi"], early["wire"])
        finally:
            for src, *_rest in (early["precopy"], early["frozen"],
                                *early["wire"].values()):
                src.kill()
        torch.cuda.empty_cache()
        lora = phase_lora(work, device["smi"])
        remat = phase_remat(torch, fa, device["smi"])
        moe = phase_moe(torch, fa, work, device["smi"])
        moe_serve = phase_moe_serving(torch, fa, work, device["smi"],
                                      seed=args.seed)
        long_context, pipeline = phase_parallel(torch, work, device["smi"],
                                                seed=args.seed)
        gang = phase_gang(torch, work, device["smi"], seed=args.seed)
        mesh = phase_mesh(torch, work, device["smi"], seed=args.seed,
                          ep=ep_config(torch), gang=True)
        ep = mesh.pop("ep")
        gang_mesh = mesh.pop("gang")
        mesh8 = phase_mesh8(torch, work, device["smi"], seed=args.seed)
    finally:
        shutil.rmtree(work, ignore_errors=True)

    main_shape = kern[f"B{BATCH} S{SEQ} H20 KVH20"]
    record = {"kernels": [{
        "name": name,
        "route": "cuda",
        "source": src,
        "replaces": replaces,
        # Phase 4's steps, phase 9's frozen-trunk runs (the uninterrupted
        # one and the restored ones), phase 10's wire destinations, the
        # uninterrupted run of phase 11, phase 13's destination, phase
        # 12's two steps,
        # every rank's Ulysses (15) and pipeline (16) runs, every source
        # and restored rank's steps of the gang (17, with phase 20's pipe
        # axis steps), every sharded and dense step of the mesh phase (18)
        # and of the expert-parallel MoE (19), sources and restores,
        # phase 20's gang steps, sources and both restores, and phase 21's
        # eight ranks (the dryrun's phases and the (2,2,2) flagship's
        # steps, source and restored).
        "launches": (train["launches"][name] + frozen["launches_all"][name]
                     + wire["launches"][name] + lora["launches"][name]
                     + remat["launches"][name] + moe["launches"][name]
                     + long_context["ring"]["launches"][name]
                     + long_context["ulysses"]["launches"][name]
                     + pipeline["launches"][name]
                     + gang["launches"][name] + mesh["launches"][name]
                     + ep["launches"][name] + gang_mesh["launches"][name]
                     + mesh8["launches"][name]),
        "launches_by_path": {"adam": train["launches"][name],
                             "frozen_trunk": frozen["launches_all"][name],
                             "wire": wire["launches"][name],
                             "lora_7b": lora["launches"][name],
                             "remat": remat["launches"][name],
                             "moe": moe["launches"][name],
                             "moe_serving": moe_serve["flash_launches"][name],
                             "ring": long_context["ring"]["launches"][name],
                             "ulysses": long_context["ulysses"]["launches"][name],
                             "pipeline": pipeline["launches"][name],
                             "gang": gang["launches"][name],
                             "mesh": mesh["launches"][name],
                             "ep": ep["launches"][name],
                             "gang_mesh": gang_mesh["launches"][name],
                             "pp_ep": sum(r[name] for r in pipeline["pp_ep"][
                                 "launches_per_rank"]),
                             "mesh8": mesh8["launches"][name]},
        "launches_per_step": {"lora_7b": lora["launches_per_step"][name],
                              "moe": moe["launches_per_step"][name],
                              "gang": gang["launches_per_step"][0][0][name],
                              "mesh": mesh["launches_per_step"][name],
                              "ep": ep["launches_per_step"][name],
                              "gang_mesh":
                                  gang_mesh["launches_per_step"][name],
                              "mesh8": mesh8["launches_per_step"][name]},
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
        "serving": serve,
        # The pre-copy migration (phase 8) runs the training step's three.
        "precopy": precopy,
        # The frozen-trunk pre-copy (phase 9) runs the forward only.
        "frozen_trunk": frozen,
        # The wire migrations (phase 10) run all three; phase 7's crc32c
        # and codec rates.
        "wire": {k: v for k, v in wire.items() if k != "launches"},
        "io": io,
        # Phases 11-13: the LoRA-7B fine-tune, remat, the MoE model.
        "lora_7b": {k: v for k, v in lora.items() if k != "launches"},
        "remat": {k: v for k, v in remat.items() if k != "launches"},
        "moe": {k: v for k, v in moe.items() if k != "launches"},
        # Phases 14-16: MoE serving, long context, the pipeline.
        "moe_serving": moe_serve,
        "long_context": long_context,
        "pipeline": {k: v for k, v in pipeline.items() if k != "launches"},
        # Phase 17: the pipeline's gang cut and restore.
        "gang": {k: v for k, v in gang.items() if k != "launches"},
        # Phase 18: the sharded flagship, its snapshot and restores.
        "mesh": {k: v for k, v in mesh.items() if k != "launches"},
        # Phase 19: the expert-parallel MoE and the sharded serving grids.
        "ep": {k: v for k, v in ep.items() if k != "launches"},
        # Phase 20: the sharded flagship's gang cut through the hooks, its
        # post-copy restore on a mesh (the grids' under "ep"), the pipe
        # axis (under "gang", phase 17's launch).
        "gang_mesh": {k: v for k, v in gang_mesh.items() if k != "launches"},
        # Phase 21: dryrun_multichip(8)'s phases and the (2,2,2) flagship.
        "mesh8": {k: v for k, v in mesh8.items() if k != "launches"}}
    log("total", f"chip_smoke.py took {time.perf_counter() - _T0:.1f} s")
    # Phase 5's blackout split by the migration's flight log.
    print(json.dumps({"obs": migrate["obs"]}), flush=True)
    print(json.dumps(record), flush=True)
    print(device["smi"], flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": device["name"], "count": device["count"]}}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
