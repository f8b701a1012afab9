"""Quiesce the CUDA devices a state tree lives on, ahead of a snapshot.

Counterpart of ``grit_tpu/device/quiesce.py:quiesce``. PyTorch queues
kernels asynchronously on each device's streams, as XLA does; the cut is
cooperative and taken at a step boundary, after every kernel queued
before the call has retired, so the device reads of the dump see stable
memory.

:func:`clone_generation` is the counterpart of the reference's cloned
generation for the quiesce-free (speculative) dump: a copy of the state
that a concurrent writer reads while the loop keeps stepping.
"""

from __future__ import annotations

from typing import Any, Callable

import torch

from grit_tpu_torch.parallel.sharding import (
    is_dtensor,
    like_dtensor,
    local_shard,
)
from grit_tpu_torch.tree import flatten_with_names, tree_map


def _clone_leaf(x):
    """A tensor leaf's copy: a DTensor's local shard copied and wrapped
    as the leaf is, with its sharding (no collective); other leaves as
    they are."""
    if not isinstance(x, torch.Tensor):
        return x
    if is_dtensor(x):
        return like_dtensor(_clone_leaf(local_shard(x).detach()), x)
    return x.detach().clone(memory_format=torch.contiguous_format)


def clone_generation(state: Any) -> Any:
    """Copy every tensor leaf of ``state`` into fresh memory on the
    leaf's own device (contiguous, so a writer reads it as a flat byte
    view with no further copy); other leaves (Python scalars, static
    config) pass through by reference.

    The port's optimizer and engines update their state in place, so the
    speculative dump must not read the live tensors while steps run. The
    clone is queued on the calling thread's current stream: called by
    the loop thread at a step boundary, stream order puts its reads
    before the next step's in-place writes. It then drains, as
    :func:`quiesce` does: an event recorded right after the copies is
    waited on before the clone is handed over, so its bytes are complete
    on every stream and a writer on another thread need not wait on the
    loop's stream (which by then holds later steps). A DTensor leaf's clone
    is its local shard's, wrapped as the leaf (its sharding too)."""
    clone = tree_map(_clone_leaf, state)
    devices = {local_shard(leaf).device for _, leaf in flatten_with_names(clone)
               if isinstance(leaf, torch.Tensor) and leaf.is_cuda}
    for dev in sorted(devices, key=str):
        done = torch.cuda.Event()
        done.record(torch.cuda.current_stream(dev))
        done.synchronize()
    return clone


def clone_live_generation(state_fn: Callable[[], Any], *,
                          attempts: int = 8,
                          backoff_s: float = 0.02) -> Any:
    """Clone the generation ``state_fn`` returns (the reference's name and
    signature). The reference retries across the window in which a
    donated step has deleted its inputs and not yet rebound its outputs;
    torch has no donated-buffer deletion, so there is no such window and
    nothing to retry: the first failure propagates, and callers degrade
    to the parked full dump. ``attempts`` and ``backoff_s`` are accepted
    for the reference's signature and unused."""
    del attempts, backoff_s
    return clone_generation(state_fn())


def quiesce(state: Any = None) -> None:
    """Synchronise every CUDA device holding a tensor of ``state`` (all
    visible devices when ``state`` is None; a DTensor leaf's shard's
    device). CPU-only state needs no drain: PyTorch's CPU ops are
    synchronous."""
    if state is None:
        devices = ({torch.device("cuda", i)
                    for i in range(torch.cuda.device_count())}
                   if torch.cuda.is_available() else set())
    else:
        devices = {local_shard(leaf).device for _, leaf in flatten_with_names(state)
                   if isinstance(leaf, torch.Tensor) and leaf.is_cuda}
    for dev in sorted(devices, key=str):
        torch.cuda.synchronize(dev)
