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
``GRIT_TPU_RESTORE_DIR``, it restores (printing ``RESTORE_BEGIN`` just
before the restore, then ``RESTORED <step>``, ``RESTORE_SECONDS <s>``,
``RESTORE_PIPELINE <json>`` with the restore's legs and ``seeded``, the
kernel libraries seeded from the snapshot, and ``INIT_SECONDS <s>``, the
set-up before the restore). With ``GRIT_RESTORE_POSTCOPY=1`` the restore
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
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from dataclasses import replace

import torch

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
    args = p.parse_args(argv)
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


def build_trainer(args: argparse.Namespace, base: dict | None = None
                  ) -> Trainer:
    """The Trainer the flags name; ``base`` is the LoRA fine-tune's frozen
    base, built here when not given."""
    if args.model == "mnist":
        return mnist_trainer(device=args.device)
    cfg = model_config(args)
    if args.model == "lora":
        return lora_trainer(cfg, lora.LoraConfig(rank=args.lora_rank),
                            batch=args.batch, seq=args.seq, base=base,
                            device=args.device)
    if args.model == "moe":
        return moe_trainer(cfg, batch=args.batch, seq=args.seq,
                           device=args.device)
    optimizer = (optim.frozen_trunk(FROZEN_TRUNK_LR)
                 if args.optimizer == "frozen-trunk" else None)
    return llama_trainer(cfg, batch=args.batch, seq=args.seq,
                         optimizer=optimizer, device=args.device)


def mnist_trainer(device: torch.device | str | None = None) -> Trainer:
    """The harness's MNIST trainer."""
    return Trainer(
        loss_fn=lambda params, b: mnist.loss_fn(MNIST, params, b),
        init_params=lambda gen, dev: mnist.init_params(MNIST, gen, dev),
        batch_fn=lambda gen: mnist.synthetic_batch(MNIST, gen, MNIST_BATCH),
        device=device)


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
                  device: torch.device | str | None = None) -> Trainer:
    """A Trainer of ``cfg`` on Zipf batches (:func:`zipf_batches`)."""
    return Trainer(
        loss_fn=lambda params, b: llama.loss_fn(cfg, params, *b),
        init_params=lambda gen, dev: llama.init_params(cfg, gen, dev),
        batch_fn=zipf_batches(cfg.vocab_size, batch, seq),
        cfg=tcfg or TrainerConfig(learning_rate=LEARNING_RATE),
        device=device, optimizer=optimizer)


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
                 device: torch.device | str | None = None) -> Trainer:
    """The JAX example's LoRA Trainer: the state is the adapter tree and
    its Adam state; ``base`` (default :func:`lora_base`) is a constant of
    the loss, never part of the state."""
    device = resolve_device(device)
    if base is None:
        base = lora_base(cfg, device)
    return Trainer(
        loss_fn=lambda lp, b: lora.lora_loss_fn(cfg, lcfg, base, lp, *b),
        init_params=lambda gen, dev: lora.init_lora(cfg, lcfg, gen, dev),
        batch_fn=zipf_batches(cfg.vocab_size, batch, seq),
        cfg=tcfg or TrainerConfig(learning_rate=LORA_LR), device=device)


def moe_trainer(cfg: moe_llama.MoeLlamaConfig, *, batch: int, seq: int,
                tcfg: TrainerConfig | None = None,
                device: torch.device | str | None = None) -> Trainer:
    """A Trainer of the MoE model on Zipf batches, Adam at the flagship's
    rate (bf16 parameters, no warmup)."""
    return Trainer(
        loss_fn=lambda params, b: moe_llama.loss_fn(cfg, params, *b),
        init_params=lambda gen, dev: moe_llama.init_params(cfg, gen, dev),
        batch_fn=zipf_batches(cfg.vocab_size, batch, seq),
        cfg=tcfg or TrainerConfig(learning_rate=LEARNING_RATE),
        device=device)


def main(argv: list[str] | None = None) -> None:
    from grit_tpu_torch.device.agentlet import Agentlet  # noqa: PLC0415
    from grit_tpu_torch.device.hook import restore_dir_from_env  # noqa: PLC0415
    from grit_tpu_torch.device.snapshot import last_restore_pipeline  # noqa: PLC0415
    from grit_tpu_torch.ops import build  # noqa: PLC0415
    from grit_tpu_torch.ops import flash_attention as fa  # noqa: PLC0415

    t_main = time.perf_counter()
    enable_determinism()
    args = parse_args(argv)
    base = None
    if args.model == "lora":
        t_base = time.perf_counter()
        base = lora_base(model_config(args), args.device)
        if base["tok_emb"].is_cuda:
            torch.cuda.synchronize(base["tok_emb"].device)
        base_s = time.perf_counter() - t_base
    tr = build_trainer(args, base=base)
    if "jax" in sys.modules:
        raise RuntimeError("the PyTorch workload imported jax")
    restore_dir = restore_dir_from_env()
    if restore_dir is not None:
        # A streamed stage may still be writing the data: the line lets
        # a stager (or a test) act at the moment the restore starts.
        print("RESTORE_BEGIN", flush=True)
        t0 = time.perf_counter()
        restored = tr.restore(restore_dir)
        print(f"RESTORED {restored}", flush=True)
        print(f"RESTORE_SECONDS {time.perf_counter() - t0!r}", flush=True)
        pipeline = last_restore_pipeline()
        if tr.postcopy is not None:
            pipeline.update(postcopy=True, hot_s=tr.postcopy.hot_s)
        print(f"RESTORE_PIPELINE {json.dumps(pipeline)}", flush=True)
        if args.model == "lora":
            # The frozen base's rebuild alone, inside the set-up before.
            print(f"BASE_SECONDS {base_s!r}", flush=True)
        print(f"INIT_SECONDS {t0 - t_main!r}", flush=True)
    postcopy = tr.postcopy
    if postcopy is None:
        # Materialize the state here, on the loop thread: the agentlet's
        # dispatch thread reads it (status, dump) and must never be the
        # one that initializes it. A post-copy restore is left to land:
        # the first step joins it, and no dump can come before that step.
        tr.state  # noqa: B018
    agentlet = Agentlet(lambda: tr.state, step_fn=lambda: tr.step,
                        reload_fn=tr.restore).start()
    print("READY", flush=True)
    n_steps = int(os.environ.get("N_STEPS", "10"))
    try:
        while tr.step < n_steps:
            loss = float(tr.train_step()["loss"])
            print(f"STEP {tr.step} {loss!r}", flush=True)
            if postcopy is not None:
                print("RESTORE_POSTCOPY " + json.dumps(
                    {"hot_s": postcopy.hot_s, "tail_s": postcopy.tail_s}),
                    flush=True)
                postcopy = None
            agentlet.checkpoint_point()
    finally:
        agentlet.stop()
    print("KERNELS " + json.dumps({"launches": fa.LAUNCHES,
                                   "built": build.BUILT,
                                   "loaded": build.LOADED}), flush=True)
    if tr.device.type == "cuda":
        print(f"MEMORY {torch.cuda.max_memory_allocated(tr.device)}",
              flush=True)
    print("DONE", flush=True)


if __name__ == "__main__":
    main()
