"""Quiesce the CUDA devices a state tree lives on, ahead of a snapshot.

Counterpart of ``grit_tpu/device/quiesce.py:quiesce``. PyTorch queues
kernels asynchronously on each device's streams, as XLA does; the cut is
cooperative and taken at a step boundary, after every kernel queued
before the call has retired, so the device reads of the dump see stable
memory.
"""

from __future__ import annotations

from typing import Any

import torch

from grit_tpu_torch.tree import flatten_with_names


def quiesce(state: Any = None) -> None:
    """Synchronise every CUDA device holding a tensor of ``state`` (all
    visible devices when ``state`` is None). CPU-only state needs no
    drain: PyTorch's CPU ops are synchronous."""
    if state is None:
        devices = ({torch.device("cuda", i)
                    for i in range(torch.cuda.device_count())}
                   if torch.cuda.is_available() else set())
    else:
        devices = {leaf.device for _, leaf in flatten_with_names(state)
                   if isinstance(leaf, torch.Tensor) and leaf.is_cuda}
    for dev in sorted(devices, key=str):
        torch.cuda.synchronize(dev)
