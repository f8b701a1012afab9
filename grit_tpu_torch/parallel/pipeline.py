"""Pipeline parallelism: the GPipe microbatch schedule over an axis.

Counterpart of ``grit_tpu/parallel/pipeline.py``: ``stack_stage_params``,
``_spmd_pipeline``, ``pipeline_apply``, ``microbatch`` and
``pipeline_loss``. The reference runs the schedule as one ``shard_map``
of a ``lax.scan``; here each rank of the axis is one stage, holds only
its stage's parameters (the reference's stacked leaves with the stage
axis stripped: ``stacked[rank]``) and runs ``num_microbatches +
num_stages - 1`` ticks: stage 0 injects microbatch ``t``, every stage
applies ``stage_fn`` to what it holds, and hands its activation to the
next stage with one :func:`~grit_tpu_torch.parallel.collectives.ring_shift`
a tick. The last stage's outputs are summed over the axis (every other
stage contributes zeros), so every rank returns them.

Gradients are exact: the hop's backward is the hop back, the input
microbatches enter through :func:`replicate` (the sum of every stage's
part of their gradient: stage 0's) and the output leaves through
:func:`reduce_sum` (every rank computes the same loss from it). Every
rank builds the same graph, stage 0 included: it takes its injected
microbatch through ``torch.where`` over what it received, as the
reference's ``jnp.where`` does, so the hops' backward runs on every rank
in the same order. ``stage_sharding`` is not ported: the port has no
sharded state yet.
"""

from __future__ import annotations

from typing import Any, Callable

import torch

from grit_tpu_torch.parallel.collectives import (
    axis_index,
    axis_size,
    reduce_sum,
    replicate,
    ring_shift,
)
from grit_tpu_torch.tree import flatten_with_names, map_with_names

PIPE_AXIS = "pipe"

# StageFn: (stage_params, activation) -> activation, applied by every
# stage to its resident microbatch each tick.
StageFn = Callable[[Any, torch.Tensor], torch.Tensor]


def stack_stage_params(per_stage: list[Any]) -> Any:
    """Stack per-stage parameter trees on a new leading stage axis."""
    leaves = [dict(flatten_with_names(t)) for t in per_stage]
    return map_with_names(
        lambda name, _leaf: torch.stack([t[name] for t in leaves]),
        per_stage[0])


def _spmd_pipeline(stage_fn: StageFn, n_stages: int, stage: int,
                   params_local: Any, x_mb: torch.Tensor,
                   axis=None) -> torch.Tensor:
    """This stage's ticks; returns what it emitted in the ticks where the
    last stage emits microbatches 0..M-1 (meaningful on the last stage)."""
    n_mb = x_mb.shape[0]
    first = torch.tensor(stage == 0, device=x_mb.device)
    held = torch.zeros_like(x_mb[0])  # what the predecessor handed over
    emitted = []
    for t in range(n_mb + n_stages - 1):
        # Bubble ticks compute on placeholders, dropped at collection.
        act_in = torch.where(first, x_mb[min(t, n_mb - 1)], held)
        act_out = stage_fn(params_local, act_in)
        emitted.append(act_out)
        if t < n_mb + n_stages - 2:  # the last tick's hop would feed nothing
            held = ring_shift(act_out, axis)
    return torch.stack(emitted[n_stages - 1:])


def pipeline_apply(stage_fn: StageFn, params_local: Any, x_mb: torch.Tensor,
                   *, axis=None) -> torch.Tensor:
    """Run microbatches ``x_mb`` (M, mb, ...), the same on every rank,
    through the stage pipeline over ``axis``; ``params_local`` is this
    rank's stage. Returns the last stage's (M, mb, ...) outputs on every
    rank."""
    n_stages, stage = axis_size(axis), axis_index(axis)
    x_mb = replicate(x_mb, axis)
    y = _spmd_pipeline(stage_fn, n_stages, stage, params_local, x_mb, axis)
    last = torch.tensor(stage == n_stages - 1, device=y.device)
    return reduce_sum(torch.where(last, y, torch.zeros_like(y)), axis)


def microbatch(x: torch.Tensor, n_microbatches: int) -> torch.Tensor:
    """Split a global batch ``(B, ...)`` into ``(M, B // M, ...)``."""
    if x.shape[0] % n_microbatches:
        raise ValueError(f"batch {x.shape[0]} not divisible by "
                         f"{n_microbatches} microbatches")
    return x.reshape(n_microbatches, x.shape[0] // n_microbatches,
                     *x.shape[1:])


def pipeline_loss(stage_fn: StageFn,
                  loss_fn: Callable[[torch.Tensor, torch.Tensor], torch.Tensor],
                  params_local: Any, x_mb: torch.Tensor, y_mb: torch.Tensor,
                  *, axis=None) -> torch.Tensor:
    """Mean of ``loss_fn`` over the microbatches through the pipeline:
    the same value on every rank, whose backward gives each rank its
    stage's gradient."""
    out = pipeline_apply(stage_fn, params_local, x_mb, axis=axis)
    return torch.stack([loss_fn(o, y) for o, y in zip(out, y_mb)]).mean()
