"""The Trainer: an eager PyTorch train step with Adam, and snapshot/restore
at step boundaries.

Counterpart of ``grit_tpu/train/trainer.py``. The migratable state is one
tree, named as the JAX Trainer's state so snapshots of the two share
leaf names::

    {"params": {...},
     "opt_state": (ScaleByAdamState(count, mu, nu), EmptyState()),
     "step": int32 scalar,
     "rng": int64 scalar}

``opt_state`` mirrors optax's ``adam`` state (``['opt_state'][0].mu[...]``,
``.nu[...]``, the int32 ``.count``), and :func:`adam_update_` does
optax's arithmetic in optax's order. ``rng`` is a stated divergence: JAX
keeps a threefry key, the port keeps the seed. Batches are a pure
function of (seed, step) — drawn on the CPU from a ``torch.Generator``
seeded by both, then moved to the device — so resuming needs no
dataloader state.

Entry points run on CUDA unless the caller passes ``device="cpu"``; with
no GPU and no explicit device they raise.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Any, Callable, NamedTuple

import torch

from grit_tpu_torch.device.hook import restore_dir_from_env
from grit_tpu_torch.device.placement import resolve_device
from grit_tpu_torch.device.quiesce import quiesce
from grit_tpu_torch.device.snapshot import restore_snapshot, write_snapshot
from grit_tpu_torch.tree import flatten_with_names, map_with_names, tree_map


def enable_determinism() -> None:
    """Bit-reproducible steps on the card, which bit-identical
    continuation after a migration needs: deterministic algorithms and a
    fixed cuBLAS workspace (the variable must be set before the first
    cuBLAS call, or deterministic mode raises)."""
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    torch.use_deterministic_algorithms(True)


class ScaleByAdamState(NamedTuple):
    """optax's ``ScaleByAdamState``: same fields, same snapshot names."""

    count: torch.Tensor
    mu: Any
    nu: Any


class EmptyState(NamedTuple):
    """optax's leafless state of the ``scale_by_learning_rate`` step."""


def adam_init(params: Any) -> tuple:
    """optax ``adam(lr).init``: moments zeros like the params (same dtype),
    count an int32 scalar (kept on the host: no device sync per step)."""
    return (ScaleByAdamState(count=torch.zeros((), dtype=torch.int32),
                             mu=tree_map(torch.zeros_like, params),
                             nu=tree_map(torch.zeros_like, params)),
            EmptyState())


@torch.no_grad()
def adam_update_(params: Any, grads: Any, opt_state: tuple, lr: float, *,
                 b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8) -> tuple:
    """One ``optax.adam(lr)`` update, in optax's arithmetic order:

        mu = (1 - b1) g + b1 mu        nu = (1 - b2) g^2 + b2 nu
        mu_hat = mu / (1 - b1^t)       nu_hat = nu / (1 - b2^t)
        p = p + (-lr) mu_hat / (sqrt(nu_hat) + eps)

    with the bias corrections computed in fp32 and cast to each moment's
    dtype. Updates params, mu and nu in place (no second copy of the
    state on the device); returns the new opt_state."""
    st = opt_state[0]
    count = st.count + 1 if st.count < torch.iinfo(torch.int32).max else st.count
    t = count.float()
    bc1 = 1 - torch.tensor(b1, dtype=torch.float32) ** t
    bc2 = 1 - torch.tensor(b2, dtype=torch.float32) ** t
    p_leaves = [x for _, x in flatten_with_names(params)]
    g_leaves = [x for _, x in flatten_with_names(grads)]
    mu_leaves = [x for _, x in flatten_with_names(st.mu)]
    nu_leaves = [x for _, x in flatten_with_names(st.nu)]
    for p, g, mu, nu in zip(p_leaves, g_leaves, mu_leaves, nu_leaves):
        mu.copy_((1 - b1) * g + b1 * mu)
        nu.copy_((1 - b2) * (g * g) + b2 * nu)
        mu_hat = mu / bc1.to(mu.dtype)
        nu_hat = nu / bc2.to(nu.dtype)
        update = (mu_hat / (torch.sqrt(nu_hat) + eps)) * -lr
        p.copy_((p + update).to(p.dtype))
    return (ScaleByAdamState(count=count, mu=st.mu, nu=st.nu),) + opt_state[1:]


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
      device: where params and optimizer state live (default CUDA).
    """

    def __init__(
        self,
        loss_fn: Callable[[Any, Any], torch.Tensor],
        init_params: Callable[[torch.Generator | None, Any], Any],
        batch_fn: Callable[[torch.Generator], Any],
        cfg: TrainerConfig | None = None,
        device: torch.device | str | None = None,
    ) -> None:
        self.cfg = cfg or TrainerConfig()
        self.device = resolve_device(device)
        self.loss_fn = loss_fn
        self.batch_fn = batch_fn
        self._init_params = init_params
        # Lazy: a restoring process must never pay the full param init —
        # at flagship scale that is seconds of RNG and optimizer-state
        # allocation inside the migration blackout, thrown away by the
        # restore one call later. First access materializes.
        self._state: dict | None = None

    # -- state ------------------------------------------------------------------

    def _make_state(self, params: Any) -> dict:
        return {
            "params": params,
            "opt_state": adam_init(params),
            "step": torch.zeros((), dtype=torch.int32),
            "rng": torch.tensor(self.cfg.seed, dtype=torch.int64),
        }

    def abstract_state(self) -> dict:
        """The state's shape skeleton (device tensors on the meta device):
        the ``like`` tree of :meth:`restore`."""
        return self._make_state(self._init_params(None, torch.device("meta")))

    @property
    def state(self) -> dict:
        if self._state is None:
            gen = torch.Generator(device=self.device).manual_seed(self.cfg.seed)
            self._state = self._make_state(self._init_params(gen, self.device))
        return self._state

    @property
    def step(self) -> int:
        return int(self.state["step"])

    # -- step -------------------------------------------------------------------

    def batch(self, step: int) -> Any:
        gen = torch.Generator().manual_seed(batch_seed(self.cfg.seed, step))
        return tree_map(lambda x: x.to(self.device), self.batch_fn(gen))

    def train_step(self) -> dict:
        state = self.state
        params = state["params"]
        leaves = [p for _, p in flatten_with_names(params)]
        for p in leaves:
            p.requires_grad_(True)
        loss = self.loss_fn(params, self.batch(int(state["step"])))
        grads = iter(torch.autograd.grad(loss, leaves))
        grad_tree = map_with_names(lambda _name, _p: next(grads), params)
        state["opt_state"] = adam_update_(params, grad_tree, state["opt_state"],
                                          self.cfg.learning_rate)
        state["step"] = state["step"] + 1
        return {"loss": loss.detach()}

    def run(self, n_steps: int) -> list[float]:
        return [float(self.train_step()["loss"]) for _ in range(n_steps)]

    # -- snapshot / restore -----------------------------------------------------

    def snapshot(self, directory: str) -> str:
        """Consistent cut at the current step boundary → committed dir."""
        quiesce(self.state)
        return write_snapshot(directory, self.state, meta={"step": self.step})

    def maybe_restore_from_env(self) -> int | None:
        """Transparent-migration entry: restore from ``GRIT_TPU_RESTORE_DIR``
        when the shim injected it (returns the step), else None."""
        d = restore_dir_from_env()
        return self.restore(d) if d else None

    def restore(self, directory: str) -> int:
        """Load state (never materializing the initial state); returns the
        restored step."""
        self._state = restore_snapshot(directory, like=self.abstract_state(),
                                       device=self.device)
        return self.step

