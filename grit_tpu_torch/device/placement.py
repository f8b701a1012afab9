"""Where the port's entry points put tensors when the caller names no
device: the current CUDA device, never a silent CPU."""

from __future__ import annotations

import torch


def resolve_device(device: torch.device | str | None = None) -> torch.device:
    """``device`` as given, else the current CUDA device. Never a silent
    CPU: with no GPU the caller must ask for the CPU explicitly."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' "
                           "to run on the CPU explicitly")
    return torch.device("cuda", torch.cuda.current_device())
