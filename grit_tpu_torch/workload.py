"""The migratable training workload: ``python -m grit_tpu_torch.workload``.

Counterpart of the JAX package's harness and bench workloads: the llama
flagship (``bench.py``'s, with ``--optimizer adam``, the default, or
``--optimizer frozen-trunk``, the fine-tune the bench migrates); with
``--model lora``, the JAX package's example workload
(``examples/workload.py``: Llama-2-7B with LoRA adapters of rank 16 on
``wq`` and ``wv``, Adam at 1e-3, the frozen base rebuilt on the device
from a fixed seed before any restore; a restoring process prints
``BASE_SECONDS <s>``, the rebuild's share of ``INIT_SECONDS``);
with ``--model moe``, ``bench.py``'s MoE model trained with Adam; and,
with ``--model mnist``, the harness's MNIST trainer (``grit_tpu/harness.py``
``WORKLOAD``: hidden 16, batch 16, Adam). ``--remat`` turns on llama's
per-layer rematerialization for the llama-based models. It builds a
:class:`~grit_tpu_torch.train.trainer.Trainer`; when the shim injected
``GRIT_TPU_RESTORE_DIR``, it first, run as a program and before it
imports torch, starts
:func:`~grit_tpu_torch.prefetch.start_restore_prefetch` (the flight log's
``restart.start``, the workload's ``/metrics`` and its sampler, the
snapshot's files warmed on a thread), then restores (printing
``RESTORE_BEGIN`` just before the restore, then ``RESTORED <step>``,
``RESTORE_SECONDS <s>``, ``RESTORE_PIPELINE <json>`` with the restore's
legs and ``seeded``, the kernel libraries seeded from the snapshot, and
``INIT_SECONDS <s>``, the set-up before the restore). With ``GRIT_RESTORE_POSTCOPY=1`` the restore
places only the hot set (``RESTORE_SECONDS`` is its time, and
``RESTORE_PIPELINE`` carries ``"postcopy": true`` and ``hot_s``), ``READY``
follows it, the first step joins the cold tail, and
``RESTORE_POSTCOPY {"hot_s", "tail_s"}`` follows that step's line. It serves
the toggle protocol through an
:class:`~grit_tpu_torch.device.agentlet.Agentlet` (printing ``READY``),
then trains, printing ``STEP <n> <loss!r>`` and offering a checkpoint
point after every step, until ``N_STEPS`` (env, default 10), then
``KERNELS <json>`` (this process's launches of each kernel, the
libraries it compiled and those it loaded), on the card ``MEMORY <bytes>``
(``torch.cuda.max_memory_allocated``), and ``DONE``.

Run on a tiny config on the CPU (what the tests do)::

    N_STEPS=8 python -m grit_tpu_torch.workload --config tiny --device cpu

or at the flagship widths on the card (the default)::

    python -m grit_tpu_torch.workload --layers 13 --seq 2048 --batch 2

The LoRA fine-tune at the example's shape, and the bench's MoE model::

    python -m grit_tpu_torch.workload --model lora --remat --batch 8
    python -m grit_tpu_torch.workload --model moe --seq 512 --batch 16

``--mesh DATA,FSDP,MODEL`` is the JAX example's sharded Trainer: this
process starts one process a rank (``DATA × FSDP × MODEL`` of them,
:func:`~grit_tpu_torch.parallel.launch.run_ranks`; on the card over
``LOCAL_GLOO``, the kernels built first), and each rank trains its
shards of a ``Trainer(mesh=, rules=)`` under the model's rule table
(:data:`MESH_RULES`) and serves its own agentlet, whose slice gate (a
file rendezvous of the ranks, the lockstep collective) lets the node
hooks of a gang (``GRIT_SLICE_HOSTS``) cut every rank at one step; each
hook's dump is its rank's own leg. Every rank prints ``PID <rank>
<pid>`` before ``READY``; rank 0 alone prints the lines above. A
``GRIT_TPU_RESTORE_DIR`` holding ``{rank}`` names each rank's leg (its
rank substituted: the same mesh; the parent's prefetch finds no such
directory and the spawned ranks run none); otherwise every rank restores
the one snapshot there (any layout: a ``Trainer.snapshot``, or
:func:`~grit_tpu_torch.device.snapshot.merge_legs` of a gang's legs)::

    N_STEPS=8 python -m grit_tpu_torch.workload --config tiny \\
        --device cpu --seq 128 --mesh 1,2,2
"""

from __future__ import annotations

import argparse
import json
import math
import os
import shutil
import sys
import tempfile
import time
from dataclasses import replace

if __name__ == "__main__":
    # The restored process's first statement: open the flight log's
    # restart window, start /metrics and warm the snapshot's files while
    # torch imports (the module and its imports are stdlib-only).
    from grit_tpu_torch.prefetch import start_restore_prefetch

    start_restore_prefetch()

import torch  # noqa: E402

from grit_tpu_torch.device.placement import resolve_device
from grit_tpu_torch.models import llama, lora, mnist, moe_llama
from grit_tpu_torch.train import optim
from grit_tpu_torch.train.trainer import Trainer, TrainerConfig, enable_determinism

# Adam without warmup moves every weight by about the learning rate on its
# first steps; at 1e-3 that is ~5% of a flagship weight (std 2560^-0.5)
# and the loss diverges, at 1e-4 it trains.
LEARNING_RATE = 1e-4
# The frozen-trunk fine-tune's rate on its trainable slice (bench.py's).
FROZEN_TRUNK_LR = 0.5
# The harness's MNIST workload (grit_tpu/harness.py): MnistConfig(hidden_dim
# =16), batches of 16, the Trainer's default Adam.
MNIST = mnist.MnistConfig(hidden_dim=16)
MNIST_BATCH = 16
# The LoRA example's Trainer runs at the JAX TrainerConfig's default rate;
# its frozen base comes from a generator of its own, seeded apart from the
# Trainer's (which draws the adapters).
LORA_LR = 1e-3
LORA_BASE_SEED = 1

_TINY = dict(dim=256, n_heads=2, n_kv_heads=2, param_dtype=torch.float32,
             dtype=torch.float32)
CONFIGS = {  # model family -> {config name: factory}
    "llama": {"flagship": llama.LlamaConfig.flagship,
              "llama2_7b": llama.LlamaConfig.llama2_7b,
              "tiny": lambda **kw: llama.LlamaConfig.tiny(**_TINY, **kw)},
    "moe": {"moe": moe_llama.MoeLlamaConfig.bench,
            "tiny": lambda **kw: moe_llama.MoeLlamaConfig.tiny(
                **_TINY, top_k=2, **kw)},
}
CONFIGS["lora"] = CONFIGS["llama"]
DEFAULT_CONFIG = {"llama": "flagship", "lora": "llama2_7b", "moe": "moe"}
# --mesh: each model's rule table, the JAX package's.
MESH_RULES = {"llama": llama.LLAMA_RULES, "lora": lora.LORA_RULES,
              "moe": moe_llama.MOE_LLAMA_RULES, "mnist": mnist.MNIST_RULES}


def parse_args(argv: list[str] | None = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(prog="python -m grit_tpu_torch.workload",
                                description=__doc__.splitlines()[0])
    p.add_argument("--model", choices=("llama", "lora", "moe", "mnist"),
                   default="llama")
    p.add_argument("--config", default=None,
                   choices=sorted({n for c in CONFIGS.values() for n in c}),
                   help="the model's config (default: flagship for llama, "
                        "llama2_7b for lora, moe for moe)")
    p.add_argument("--optimizer", choices=("adam", "frozen-trunk"),
                   default="adam",
                   help="llama only: Adam on every leaf, or bench.py's "
                        "fine-tune (sgd 0.5 on final_norm and lm_head, the "
                        "rest frozen)")
    p.add_argument("--layers", type=int, default=None,
                   help="cut the depth (widths stay the config's)")
    p.add_argument("--seq", type=int, default=2048)
    p.add_argument("--batch", type=int, default=2)
    p.add_argument("--lora-rank", type=int, default=16,
                   help="lora only: the adapters' rank")
    p.add_argument("--remat", action="store_true",
                   help="llama, lora, moe: recompute each layer in the "
                        "backward instead of keeping its activations")
    p.add_argument("--device", default=None,
                   help="torch device (default: the current CUDA device)")
    p.add_argument("--mesh", default=None, metavar="DATA,FSDP,MODEL",
                   help="shard over a (data, fsdp, model) mesh, one "
                        "process a rank started here, by the model's rules")
    args = p.parse_args(argv)
    if args.mesh is not None:
        try:
            args.mesh = tuple(int(k) for k in args.mesh.split(","))
        except ValueError:
            args.mesh = ()
        if len(args.mesh) != 3 or min(args.mesh) < 1:
            p.error("--mesh takes three positive sizes: DATA,FSDP,MODEL")
    if args.model != "llama" and args.optimizer != "adam":
        p.error("--optimizer frozen-trunk is llama's fine-tune")
    if args.model == "mnist":
        if args.remat or args.config is not None:
            p.error("--model mnist takes no --config and no --remat")
        return args
    args.config = args.config or DEFAULT_CONFIG[args.model]
    if args.config not in CONFIGS[args.model]:
        p.error(f"--model {args.model} takes --config "
                f"{' or '.join(sorted(CONFIGS[args.model]))}")
    return args


def model_config(args: argparse.Namespace):
    """The llama-family config the flags name (not for ``mnist``)."""
    cfg = CONFIGS[args.model][args.config]()
    if args.layers is not None:
        cfg = replace(cfg, n_layers=args.layers)
    return replace(cfg, remat=args.remat)


def build_trainer(args: argparse.Namespace, base: dict | None = None,
                  mesh=None) -> Trainer:
    """The Trainer the flags name; ``base`` is the LoRA fine-tune's frozen
    base, built here when not given. ``mesh``: shard it by the model's
    :data:`MESH_RULES` (every rank of the mesh builds it)."""
    if args.model == "mnist":
        return mnist_trainer(device=args.device, mesh=mesh)
    cfg = model_config(args)
    if args.model == "lora":
        return lora_trainer(cfg, lora.LoraConfig(rank=args.lora_rank),
                            batch=args.batch, seq=args.seq, base=base,
                            device=args.device, mesh=mesh)
    if args.model == "moe":
        return moe_trainer(cfg, batch=args.batch, seq=args.seq,
                           device=args.device, mesh=mesh)
    optimizer = (optim.frozen_trunk(FROZEN_TRUNK_LR)
                 if args.optimizer == "frozen-trunk" else None)
    return llama_trainer(cfg, batch=args.batch, seq=args.seq,
                         optimizer=optimizer, device=args.device, mesh=mesh)


def _sharded(model: str, mesh, tcfg: TrainerConfig) -> dict:
    """The Trainer's sharding arguments on ``mesh`` (none without one):
    the model's rule table, the batch split over the data axes."""
    if mesh is None:
        return {"cfg": tcfg}
    return {"cfg": replace(tcfg, batch_spec=llama.BATCH_SPEC), "mesh": mesh,
            "rules": MESH_RULES[model]}


def mnist_trainer(device: torch.device | str | None = None,
                  mesh=None) -> Trainer:
    """The harness's MNIST trainer."""
    return Trainer(
        loss_fn=lambda params, b: mnist.loss_fn(MNIST, params, b),
        init_params=lambda gen, dev: mnist.init_params(MNIST, gen, dev),
        batch_fn=lambda gen: mnist.synthetic_batch(MNIST, gen, MNIST_BATCH),
        device=device, **_sharded("mnist", mesh, TrainerConfig()))


def zipf_batches(vocab_size: int, batch: int, seq: int):
    """A ``batch_fn`` of synthetic next-token batches ``(batch, seq)``
    whose token ids follow a Zipf law over the vocabulary, as words in
    text do: a distribution a randomly initialised model learns within a
    few steps, so a falling loss shows the step trains."""
    zipf = 1.0 / torch.arange(1, vocab_size + 1, dtype=torch.float64)

    def batch_fn(gen: torch.Generator):
        tokens = torch.multinomial(zipf, batch * (seq + 1), replacement=True,
                                   generator=gen).reshape(batch, seq + 1)
        return tokens[:, :-1].contiguous(), tokens[:, 1:].contiguous()

    return batch_fn


def llama_trainer(cfg: llama.LlamaConfig, *, batch: int, seq: int,
                  tcfg: TrainerConfig | None = None,
                  optimizer: optim.GradientTransformation | None = None,
                  device: torch.device | str | None = None,
                  mesh=None) -> Trainer:
    """A Trainer of ``cfg`` on Zipf batches (:func:`zipf_batches`)."""
    return Trainer(
        loss_fn=lambda params, b: llama.loss_fn(cfg, params, *b),
        init_params=lambda gen, dev: llama.init_params(cfg, gen, dev),
        batch_fn=zipf_batches(cfg.vocab_size, batch, seq),
        device=device, optimizer=optimizer,
        **_sharded("llama", mesh,
                   tcfg or TrainerConfig(learning_rate=LEARNING_RATE)))


def lora_base(cfg: llama.LlamaConfig,
              device: torch.device | str | None = None) -> dict:
    """The LoRA fine-tune's frozen base, built on ``device`` from a
    generator seeded with :data:`LORA_BASE_SEED`: every process, a
    restoring one included, rebuilds the same bytes."""
    device = resolve_device(device)
    gen = torch.Generator(device=device).manual_seed(LORA_BASE_SEED)
    return llama.init_params(cfg, gen, device)


def lora_trainer(cfg: llama.LlamaConfig, lcfg: lora.LoraConfig, *,
                 batch: int, seq: int, base: dict | None = None,
                 tcfg: TrainerConfig | None = None,
                 device: torch.device | str | None = None,
                 mesh=None) -> Trainer:
    """The JAX example's LoRA Trainer: the state is the adapter tree and
    its Adam state; ``base`` (default :func:`lora_base`) is a constant of
    the loss, never part of the state. On a ``mesh`` the base is
    replicated there, whole on every rank (no communication)."""
    device = resolve_device(device)
    if base is None:
        base = lora_base(cfg, device)
    if mesh is not None:
        from grit_tpu_torch.parallel.sharding import NamedSharding  # noqa: PLC0415
        from grit_tpu_torch.tree import tree_map  # noqa: PLC0415

        base = tree_map(NamedSharding(mesh, ()).distribute, base)
    return Trainer(
        loss_fn=lambda lp, b: lora.lora_loss_fn(cfg, lcfg, base, lp, *b),
        init_params=lambda gen, dev: lora.init_lora(cfg, lcfg, gen, dev),
        batch_fn=zipf_batches(cfg.vocab_size, batch, seq), device=device,
        **_sharded("lora", mesh, tcfg or TrainerConfig(learning_rate=LORA_LR)))


def moe_trainer(cfg: moe_llama.MoeLlamaConfig, *, batch: int, seq: int,
                tcfg: TrainerConfig | None = None,
                device: torch.device | str | None = None,
                mesh=None) -> Trainer:
    """A Trainer of the MoE model on Zipf batches, Adam at the flagship's
    rate (bf16 parameters, no warmup); on a ``mesh`` the loss closes over
    it (the expert layer runs expert-parallel)."""
    return Trainer(
        loss_fn=lambda params, b: moe_llama.loss_fn(cfg, params, *b,
                                                    mesh=mesh),
        init_params=lambda gen, dev: moe_llama.init_params(cfg, gen, dev),
        batch_fn=zipf_batches(cfg.vocab_size, batch, seq), device=device,
        **_sharded("moe", mesh,
                   tcfg or TrainerConfig(learning_rate=LEARNING_RATE)))


def main(argv: list[str] | None = None) -> None:
    t_main = time.perf_counter()
    enable_determinism()
    args = parse_args(argv)
    if args.mesh is not None:
        _launch_mesh(args)
        return
    _train(args, t_main)


def _launch_mesh(args: argparse.Namespace) -> None:
    """``--mesh``: one process a rank of the mesh, each running
    :func:`_mesh_rank`, until every rank is done."""
    from grit_tpu_torch.parallel.collectives import LOCAL_GLOO  # noqa: PLC0415
    from grit_tpu_torch.parallel.launch import run_ranks  # noqa: PLC0415

    on_card = resolve_device(args.device).type == "cuda"
    if on_card:
        from grit_tpu_torch.ops import build  # noqa: PLC0415

        build.build_all()  # the ranks load the libraries, never race to build
    rdv = tempfile.mkdtemp(prefix="grit-mesh-rdv-")
    try:
        run_ranks(_mesh_rank, math.prod(args.mesh), args, rdv,
                  backend=LOCAL_GLOO if on_card else "gloo",
                  timeout=float("inf"))
    finally:
        shutil.rmtree(rdv, ignore_errors=True)


def _mesh_rank(args: argparse.Namespace, rdv: str) -> None:
    """One rank of ``--mesh``: its shards of the sharded Trainer and its
    own agentlet, whose slice gate meets the other ranks' in ``rdv``."""
    import torch.distributed as dist  # noqa: PLC0415

    from grit_tpu_torch.parallel.coordination import (  # noqa: PLC0415
        FileRendezvous,
        SliceCoordinator,
        SliceQuiesceGate,
        group_any,
    )
    from grit_tpu_torch.parallel.mesh import MeshSpec, build_mesh  # noqa: PLC0415

    t_main = time.perf_counter()
    rank, n = dist.get_rank(), dist.get_world_size()
    if args.device is None:
        torch.cuda.set_device(0)
    mesh = build_mesh(MeshSpec(*args.mesh), args.device)
    gate = SliceQuiesceGate(
        SliceCoordinator(FileRendezvous(rdv, rank, n), process_index=rank,
                         process_count=n),
        lockstep=group_any())
    _train(args, t_main, mesh=mesh, rank=rank, gate=gate)


def emit(line: str) -> None:
    """Print one protocol line in one write. ``--mesh`` ranks share the
    parent's stdout, and ``print`` writes the text and its newline apart
    when stdout is unbuffered (``PYTHONUNBUFFERED``), so two ranks' lines
    could interleave into one (``PID 0 …PID 2 …``) and a reader would miss
    both; a single write of a line shorter than the pipe's atomic size
    cannot be split."""
    sys.stdout.write(line + "\n")
    sys.stdout.flush()


def _train(args: argparse.Namespace, t_main: float, *, mesh=None,
           rank: int = 0, gate=None) -> None:
    """Build, restore, serve the agentlet and train, printing the
    protocol lines (on a mesh, rank 0's; every rank its ``PID``)."""
    from grit_tpu_torch.device.agentlet import Agentlet  # noqa: PLC0415
    from grit_tpu_torch.device.hook import restore_dir_from_env  # noqa: PLC0415
    from grit_tpu_torch.device.snapshot import last_restore_pipeline  # noqa: PLC0415
    from grit_tpu_torch.ops import build  # noqa: PLC0415
    from grit_tpu_torch.ops import flash_attention as fa  # noqa: PLC0415

    def say(line: str) -> None:
        if rank == 0:
            emit(line)

    base = None
    if args.model == "lora":
        t_base = time.perf_counter()
        base = lora_base(model_config(args), args.device)
        if base["tok_emb"].is_cuda:
            torch.cuda.synchronize(base["tok_emb"].device)
        base_s = time.perf_counter() - t_base
    tr = build_trainer(args, base=base, mesh=mesh)
    if "jax" in sys.modules:
        raise RuntimeError("the PyTorch workload imported jax")
    restore_dir = restore_dir_from_env(rank)
    if restore_dir is not None:
        # A streamed stage may still be writing the data: the line lets
        # a stager (or a test) act at the moment the restore starts.
        say("RESTORE_BEGIN")
        t0 = time.perf_counter()
        restored = tr.restore(restore_dir)
        say(f"RESTORED {restored}")
        say(f"RESTORE_SECONDS {time.perf_counter() - t0!r}")
        pipeline = last_restore_pipeline()
        if tr.postcopy is not None:
            pipeline.update(postcopy=True, hot_s=tr.postcopy.hot_s)
        say(f"RESTORE_PIPELINE {json.dumps(pipeline)}")
        if args.model == "lora":
            # The frozen base's rebuild alone, inside the set-up before.
            say(f"BASE_SECONDS {base_s!r}")
        say(f"INIT_SECONDS {t0 - t_main!r}")
    postcopy = tr.postcopy
    if postcopy is None:
        # Materialize the state here, on the loop thread: the agentlet's
        # dispatch thread reads it (status, dump) and must never be the
        # one that initializes it. A post-copy restore is left to land:
        # the first step joins it, and no dump can come before that step.
        tr.state  # noqa: B018
    agentlet = Agentlet(lambda: tr.state, step_fn=lambda: tr.step,
                        reload_fn=tr.restore, slice_gate=gate).start()
    if mesh is not None:
        emit(f"PID {rank} {os.getpid()}")
    say("READY")
    n_steps = int(os.environ.get("N_STEPS", "10"))
    try:
        while tr.step < n_steps:
            loss = float(tr.train_step()["loss"])
            say(f"STEP {tr.step} {loss!r}")
            if postcopy is not None:
                say("RESTORE_POSTCOPY " + json.dumps(
                    {"hot_s": postcopy.hot_s, "tail_s": postcopy.tail_s}))
                postcopy = None
            agentlet.checkpoint_point()
    finally:
        agentlet.stop()
    say("KERNELS " + json.dumps({"launches": fa.LAUNCHES,
                                 "built": build.BUILT,
                                 "loaded": build.LOADED}))
    if tr.device.type == "cuda":
        say(f"MEMORY {torch.cuda.max_memory_allocated(tr.device)}")
    say("DONE")


if __name__ == "__main__":
    main()
