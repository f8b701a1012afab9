"""The Trainer: an eager PyTorch train step through an optax-style
optimizer, and snapshot/restore at step boundaries.

Counterpart of ``grit_tpu/train/trainer.py``. The migratable state is one
tree, named as the JAX Trainer's state so snapshots of the two share
leaf names::

    {"params": {...},
     "opt_state": (ScaleByAdamState(count, mu, nu), EmptyState()),
     "step": int32 scalar,
     "rng": int64 scalar}

``opt_state`` is the optimizer's state, in optax's classes and names
(:mod:`grit_tpu_torch.train.optim`): the default ``adam``'s above; the
frozen-trunk fine-tune's has no array leaf at all. A step asks autograd
only for the gradients its optimizer reads, and applies the update in
place. ``rng`` is a stated divergence: JAX keeps a threefry key, the
port keeps the seed. Batches are a pure
function of (seed, step) — drawn on the CPU from a ``torch.Generator``
seeded by both, then moved to the device — so resuming needs no
dataloader state.

Entry points run on CUDA unless the caller passes ``device="cpu"``; with
no GPU and no explicit device they raise.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Any, Callable

import torch

from grit_tpu_torch.api import config
from grit_tpu_torch.device.hook import restore_dir_from_env
from grit_tpu_torch.device.placement import resolve_device
from grit_tpu_torch.device.quiesce import quiesce
from grit_tpu_torch.device.snapshot import (
    PostcopyRestore,
    restore_snapshot,
    restore_snapshot_postcopy,
    write_snapshot,
)
from grit_tpu_torch.train.optim import GradientTransformation, adam
from grit_tpu_torch.tree import flatten_with_names, map_with_names, tree_map


def enable_determinism() -> None:
    """Bit-reproducible steps on the card, which bit-identical
    continuation after a migration needs: deterministic algorithms and a
    fixed cuBLAS workspace (the variable must be set before the first
    cuBLAS call, or deterministic mode raises)."""
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    torch.use_deterministic_algorithms(True)


@dataclass
class TrainerConfig:
    learning_rate: float = 1e-3
    seed: int = 0


def batch_seed(seed: int, step: int) -> int:
    """The seed of step ``step``'s batch generator."""
    return (seed * 1_000_003 + step) % (1 << 63)


class Trainer:
    """Owns the train step and the migratable state tree.

    Args:
      loss_fn: ``loss_fn(params, batch) -> scalar tensor``.
      init_params: ``init_params(generator, device) -> params``; called
        once on first use of the state, never when restoring. Called with
        ``(None, "meta")`` for the shape skeleton a restore loads into.
      batch_fn: ``batch_fn(generator) -> batch`` of CPU tensors, from a
        CPU generator seeded by (seed, step).
      optimizer: an optax-style transform of
        :mod:`grit_tpu_torch.train.optim`; ``adam(cfg.learning_rate)`` by
        default, as the JAX Trainer's.
      device: where params and optimizer state live (default CUDA).
    """

    def __init__(
        self,
        loss_fn: Callable[[Any, Any], torch.Tensor],
        init_params: Callable[[torch.Generator | None, Any], Any],
        batch_fn: Callable[[torch.Generator], Any],
        cfg: TrainerConfig | None = None,
        device: torch.device | str | None = None,
        optimizer: GradientTransformation | None = None,
    ) -> None:
        self.cfg = cfg or TrainerConfig()
        self.optimizer = optimizer or adam(self.cfg.learning_rate)
        self.device = resolve_device(device)
        self.loss_fn = loss_fn
        self.batch_fn = batch_fn
        self._init_params = init_params
        # Lazy: a restoring process must never pay the full param init —
        # at flagship scale that is seconds of RNG and optimizer-state
        # allocation inside the migration blackout, thrown away by the
        # restore one call later. First access materializes.
        self._state: dict | None = None
        # An in-flight post-copy restore (GRIT_RESTORE_POSTCOPY): the cold
        # bulk is still landing through the handle's tail, and the first
        # touch of the state joins it.
        self._postcopy: PostcopyRestore | None = None
        self._postcopy_step: int | None = None

    # -- state ------------------------------------------------------------------

    def _make_state(self, params: Any) -> dict:
        return {
            "params": params,
            "opt_state": self.optimizer.init(params),
            "step": torch.zeros((), dtype=torch.int32),
            "rng": torch.tensor(self.cfg.seed, dtype=torch.int64),
        }

    def abstract_state(self) -> dict:
        """The state's shape skeleton (device tensors on the meta device):
        the ``like`` tree of :meth:`restore`."""
        return self._make_state(self._init_params(None, torch.device("meta")))

    @property
    def state(self) -> dict:
        if self._postcopy is not None:
            # First touch of the whole tree: join the post-copy tail. The
            # handle is dropped only after wait() succeeds, so a failed
            # join stays loud on every retry and never turns into a
            # fresh state at step 0.
            resolved = self._postcopy.wait()
            self._postcopy = None
            self._postcopy_step = None
            self._state = resolved
        if self._state is None:
            gen = torch.Generator(device=self.device).manual_seed(self.cfg.seed)
            self._state = self._make_state(self._init_params(gen, self.device))
        return self._state

    @state.setter
    def state(self, value: dict) -> None:
        self._state = value
        self._postcopy = None
        self._postcopy_step = None

    @property
    def postcopy(self) -> PostcopyRestore | None:
        """The post-copy restore still landing, if any."""
        return self._postcopy

    @property
    def step(self) -> int:
        if self._postcopy is not None and self._postcopy_step is not None:
            return self._postcopy_step  # the manifest's; the tail runs on
        return int(self.state["step"])

    # -- step -------------------------------------------------------------------

    def batch(self, step: int) -> Any:
        gen = torch.Generator().manual_seed(batch_seed(self.cfg.seed, step))
        return tree_map(lambda x: x.to(self.device), self.batch_fn(gen))

    def train_step(self) -> dict:
        state = self.state
        params = state["params"]
        named = flatten_with_names(params)
        reads = self.optimizer.reads_grad(params)
        wanted = [p for name, p in named if reads[name]]
        for name, p in named:
            p.requires_grad_(reads[name])
        batch = self.batch(int(state["step"]))
        if wanted:
            loss = self.loss_fn(params, batch)
            grads = iter(torch.autograd.grad(loss, wanted))
        else:
            with torch.no_grad():
                loss = self.loss_fn(params, batch)
        # A leaf whose transform reads no gradient gets a zero view of its
        # shape (stride 0: no memory, no kernel).
        grad_tree = map_with_names(
            lambda name, p: next(grads) if reads[name] else torch.zeros(
                (), dtype=p.dtype, device=p.device).expand(p.shape), params)
        state["opt_state"] = self.optimizer.apply_(params, grad_tree,
                                                   state["opt_state"])
        state["step"] = state["step"] + 1
        return {"loss": loss.detach()}

    def run(self, n_steps: int) -> list[float]:
        return [float(self.train_step()["loss"]) for _ in range(n_steps)]

    # -- snapshot / restore -----------------------------------------------------

    def snapshot(self, directory: str, *, barrier=lambda: None,
                 base: str | None = None, hashes: bool = False) -> str:
        """Consistent cut at the current step boundary → committed dir.

        ``barrier``: the multi-process dump's synchronization
        (:func:`~grit_tpu_torch.device.snapshot.write_snapshot`).
        ``base``: delta-dump against an earlier committed snapshot (the
        pre-copy pattern: dump full while training, delta at the
        blackout). ``hashes``: record a sha256 per chunk, so a later delta
        against this dump matches by hash instead of reading it back."""
        quiesce(self.state)
        return write_snapshot(directory, self.state, meta={"step": self.step},
                              barrier=barrier, base=base, hashes=hashes)

    def snapshot_coordinated(self, directory: str, coordinator) -> str:
        """Consistent-cut snapshot across all hosts of the slice: agree on
        the cut step, run forward to it, dump. ``coordinator`` is a
        :class:`~grit_tpu_torch.parallel.coordination.SliceCoordinator`;
        the state goes as a getter, since stepping may rebind it."""
        return coordinator.snapshot(directory, lambda: self.state,
                                    step_fn=self.train_step,
                                    current_step=self.step)

    def maybe_restore_from_env(self) -> int | None:
        """Transparent-migration entry: restore from ``GRIT_TPU_RESTORE_DIR``
        when the shim injected it (returns the step), else None."""
        d = restore_dir_from_env()
        return self.restore(d) if d else None

    def restore(self, directory: str) -> int:
        """Load state (never materializing the initial state); returns the
        restored step.

        With ``GRIT_RESTORE_POSTCOPY`` set the restore is lazy: the hot set
        is placed now, the step comes from the manifest, and the cold bulk
        lands through a background tail that the first touch of the state
        (normally the first ``train_step``) joins."""
        like = self.abstract_state()
        if config.RESTORE_POSTCOPY.get_flag():
            handle = restore_snapshot_postcopy(directory, like=like,
                                               device=self.device)
            step = handle.meta.get("step")
            if isinstance(step, (int, float)):
                self._state = None
                self._postcopy = handle
                self._postcopy_step = int(step)
                return self._postcopy_step
            # No recorded step: the caller needs it now.
            self.state = handle.wait()
            return self.step
        self.state = restore_snapshot(directory, like=like, device=self.device)
        return self.step

