"""The migratable llama training workload: ``python -m grit_tpu_torch.workload``.

Counterpart of the JAX package's harness/bench workload
(``grit_tpu/harness.py`` ``WORKLOAD``, the bench's flagship): builds a
llama :class:`~grit_tpu_torch.train.trainer.Trainer`, restores from
``GRIT_TPU_RESTORE_DIR`` when the shim injected it (printing
``RESTORE_BEGIN`` just before the restore, then ``RESTORED <step>``,
``RESTORE_SECONDS <s>``, ``RESTORE_PIPELINE <json>`` with the restore's
legs, and ``INIT_SECONDS <s>``, the set-up before the restore), serves
the toggle protocol through an
:class:`~grit_tpu_torch.device.agentlet.Agentlet` (printing ``READY``),
then trains, printing ``STEP <n> <loss!r>`` and offering a checkpoint
point after every step, until ``N_STEPS`` (env, default 10), then
``DONE``.

Run on a tiny config on the CPU (what the tests do)::

    N_STEPS=8 python -m grit_tpu_torch.workload --config tiny --device cpu

or at the flagship widths on the card (the default)::

    python -m grit_tpu_torch.workload --layers 13 --seq 2048 --batch 2
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from dataclasses import replace

import torch

from grit_tpu_torch.models import llama
from grit_tpu_torch.train.trainer import Trainer, TrainerConfig, enable_determinism

# Adam without warmup moves every weight by about the learning rate on its
# first steps; at 1e-3 that is ~5% of a flagship weight (std 2560^-0.5)
# and the loss diverges, at 1e-4 it trains.
LEARNING_RATE = 1e-4

CONFIGS = {"flagship": llama.LlamaConfig.flagship,
           "tiny": lambda **kw: llama.LlamaConfig.tiny(
               dim=256, n_heads=2, n_kv_heads=2, param_dtype=torch.float32,
               dtype=torch.float32, **kw)}


def parse_args(argv: list[str] | None = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(prog="python -m grit_tpu_torch.workload",
                                description=__doc__.splitlines()[0])
    p.add_argument("--config", choices=sorted(CONFIGS), default="flagship")
    p.add_argument("--layers", type=int, default=None,
                   help="cut the depth (widths stay the config's)")
    p.add_argument("--seq", type=int, default=2048)
    p.add_argument("--batch", type=int, default=2)
    p.add_argument("--device", default=None,
                   help="torch device (default: the current CUDA device)")
    return p.parse_args(argv)


def build_trainer(args: argparse.Namespace) -> Trainer:
    cfg = CONFIGS[args.config]()
    if args.layers is not None:
        cfg = replace(cfg, n_layers=args.layers)
    return llama_trainer(cfg, batch=args.batch, seq=args.seq,
                         device=args.device)


def llama_trainer(cfg: llama.LlamaConfig, *, batch: int, seq: int,
                  tcfg: TrainerConfig | None = None,
                  device: torch.device | str | None = None) -> Trainer:
    """A Trainer of ``cfg`` on synthetic next-token batches ``(batch, seq)``
    whose token ids follow a Zipf law over the vocabulary, as words in
    text do: a distribution a randomly initialised model learns within a
    few steps, so a falling loss shows the step trains."""
    zipf = 1.0 / torch.arange(1, cfg.vocab_size + 1, dtype=torch.float64)

    def batch_fn(gen: torch.Generator):
        tokens = torch.multinomial(zipf, batch * (seq + 1), replacement=True,
                                   generator=gen).reshape(batch, seq + 1)
        return tokens[:, :-1].contiguous(), tokens[:, 1:].contiguous()

    return Trainer(
        loss_fn=lambda params, b: llama.loss_fn(cfg, params, *b),
        init_params=lambda gen, dev: llama.init_params(cfg, gen, dev),
        batch_fn=batch_fn,
        cfg=tcfg or TrainerConfig(learning_rate=LEARNING_RATE),
        device=device)


def main(argv: list[str] | None = None) -> None:
    from grit_tpu_torch.device.agentlet import Agentlet  # noqa: PLC0415
    from grit_tpu_torch.device.hook import restore_dir_from_env  # noqa: PLC0415
    from grit_tpu_torch.device.snapshot import last_restore_pipeline  # noqa: PLC0415

    t_main = time.perf_counter()
    enable_determinism()
    args = parse_args(argv)
    tr = build_trainer(args)
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
        print(f"RESTORE_PIPELINE {json.dumps(last_restore_pipeline())}",
              flush=True)
        print(f"INIT_SECONDS {t0 - t_main!r}", flush=True)
    # Materialize the state here, on the loop thread: the agentlet's
    # dispatch thread reads it (status, dump) and must never be the one
    # that initializes it.
    tr.state  # noqa: B018
    agentlet = Agentlet(lambda: tr.state, step_fn=lambda: tr.step).start()
    print("READY", flush=True)
    n_steps = int(os.environ.get("N_STEPS", "10"))
    try:
        while tr.step < n_steps:
            loss = float(tr.train_step()["loss"])
            print(f"STEP {tr.step} {loss!r}", flush=True)
            agentlet.checkpoint_point()
    finally:
        agentlet.stop()
    print("DONE", flush=True)


if __name__ == "__main__":
    main()
