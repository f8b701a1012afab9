"""Carry weights, trainer state and serving state between the JAX package
and the port.

Both sides speak numpy: the JAX side converts its pytree with
``jax.tree.map(np.asarray, tree)``, and these functions turn such a tree
into the port's tensors (and back). The walk is generic: a llama, LoRA
adapter or MoE parameter tree, and its Adam state, carry over by their
leaf names alike, and a sharded state (DTensor leaves) comes back whole. bf16 arrives as an ml_dtypes
``bfloat16`` array, which ``torch.from_numpy`` refuses; its bytes are
reinterpreted through int16 instead, so this module needs no ml_dtypes.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from grit_tpu_torch.parallel.sharding import is_dtensor
from grit_tpu_torch.train.optim import EmptyState, ScaleByAdamState
from grit_tpu_torch.tree import flatten_with_names, map_with_names, tree_map


def tensor_from_numpy(a, device: torch.device | str = "cpu") -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(np.ascontiguousarray(a).view(np.int16).copy())
        return t.view(torch.bfloat16).to(device)
    return torch.from_numpy(np.array(a)).to(device)


def tensor_to_numpy(t: torch.Tensor) -> np.ndarray:
    """bf16 comes back as float32 (exact): numpy has no bf16 of its own. A
    DTensor comes back whole (a collective: every rank of its mesh calls
    this)."""
    if is_dtensor(t):
        t = t.full_tensor()
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.numpy()


def params_from_jax(tree: Any, device: torch.device | str = "cpu") -> Any:
    """A JAX parameter pytree (numpy leaves) → the port's parameter tree."""
    return tree_map(lambda a: tensor_from_numpy(a, device), tree)


def state_from_jax(state: Any, *, seed: int,
                   device: torch.device | str = "cpu") -> dict:
    """A JAX ``Trainer`` state (numpy leaves; ``opt_state`` as optax's
    ``(ScaleByAdamState, EmptyState)``) → the port Trainer's state. The
    JAX threefry key has no port counterpart: ``rng`` becomes ``seed``.
    ``step`` and ``count`` stay on the host, as the port keeps them."""
    adam = state["opt_state"][0]
    return {
        "params": params_from_jax(state["params"], device),
        "opt_state": (ScaleByAdamState(
            count=tensor_from_numpy(adam.count),
            mu=params_from_jax(adam.mu, device),
            nu=params_from_jax(adam.nu, device)), EmptyState()),
        "step": tensor_from_numpy(state["step"]),
        "rng": torch.tensor(seed, dtype=torch.int64),
    }


def serving_state_from_jax(state: Any,
                           device: torch.device | str = "cpu",
                           shardings: Any = None) -> dict:
    """A JAX serving engine's state (numpy leaves; lock-step or
    continuous batching) → the port engine's state: the KV cache on
    ``device``, and the lock-step engine's ``last_token``, which its next
    step feeds back; the bookkeeping on the host. The RNG leaves carry
    over as their uint32 words; the port reads them in its own encoding
    (:mod:`grit_tpu_torch.models.serving`). ``shardings``: a sharded
    engine's (its ``_state_shardings``): each rank keeps its shard of
    every leaf they split, as a DTensor."""
    out = tree_map(tensor_from_numpy, state)
    out["cache"] = {**out["cache"], "k": out["cache"]["k"].to(device),
                    "v": out["cache"]["v"].to(device)}
    if "rng" in out:  # the lock-step engine
        out["last_token"] = out["last_token"].to(device)
    if shardings is None:
        return out
    where = dict(flatten_with_names(shardings))
    return map_with_names(lambda name, t: where[name].distribute(t)
                          if where[name].shards() else t, out)


def state_to_numpy(state: Any) -> Any:
    """The port's state tree with numpy leaves (bf16 as exact float32)."""
    return tree_map(tensor_to_numpy, state)
