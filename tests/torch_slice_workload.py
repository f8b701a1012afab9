"""The port's twin of the JAX package's slice workload
(``grit_tpu.harness.SLICE_WORKLOAD``): one host of a simulated slice, a
rank-seeded MNIST trainer (seed ``1000 + rank``, so each host has its own
loss sequence and a rank's is the same in any process) whose agentlet
carries a :class:`~grit_tpu_torch.parallel.coordination.SliceQuiesceGate`
over a :class:`~grit_tpu_torch.parallel.coordination.FileRendezvous` in
``$SLICE_RDV_DIR``. It prints the reference's ``READY``, ``RESTORED <step>``,
``STEP <n> <loss!r>`` and ``DONE`` lines and reads the same environment
(``SLICE_RANK``, ``SLICE_WORLD``, ``SLICE_RDV_DIR``, ``N_STEPS``), so the
reference's ``SliceHarness`` runs it where its own would run: tests set
``grit_tpu.harness.SLICE_WORKLOAD`` to :data:`SLICE_WORKLOAD`.
"""

from __future__ import annotations

import os
import textwrap

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SLICE_WORKLOAD = textwrap.dedent("""
    import os, sys, time
    import torch
    torch.set_num_threads(1)  # the hosts share a few cores
    sys.path.insert(0, {repo!r})
    from grit_tpu_torch.device.agentlet import Agentlet
    from grit_tpu_torch.models import mnist
    from grit_tpu_torch.parallel.coordination import (
        FileRendezvous, SliceCoordinator, SliceQuiesceGate,
    )
    from grit_tpu_torch.train.trainer import Trainer, TrainerConfig
    from grit_tpu_torch.workload import MNIST, MNIST_BATCH

    rank = int(os.environ["SLICE_RANK"])
    world = int(os.environ["SLICE_WORLD"])
    rdv = FileRendezvous(os.environ["SLICE_RDV_DIR"], rank, world)
    coord = SliceCoordinator(rdv, process_index=rank, process_count=world)
    gate = SliceQuiesceGate(coord)

    tr = Trainer(
        loss_fn=lambda p, b: mnist.loss_fn(MNIST, p, b),
        init_params=lambda gen, dev: mnist.init_params(MNIST, gen, dev),
        batch_fn=lambda gen: mnist.synthetic_batch(MNIST, gen, MNIST_BATCH),
        cfg=TrainerConfig(seed=1000 + rank), device="cpu")
    restored = tr.maybe_restore_from_env()
    if restored is not None:
        print(f"RESTORED {{restored}}", flush=True)
    agentlet = Agentlet(lambda: tr.state, step_fn=lambda: tr.step,
                        slice_gate=gate).start()
    print("READY", flush=True)
    n_steps = int(os.environ.get("N_STEPS", "10"))
    while tr.step < n_steps:
        loss = float(tr.train_step()["loss"])
        print(f"STEP {{tr.step}} {{loss!r}}", flush=True)
        time.sleep(0.01 * rank)  # desync hosts: the cut must run forward
        agentlet.checkpoint_point()
    print("DONE", flush=True)
""").format(repo=REPO)
