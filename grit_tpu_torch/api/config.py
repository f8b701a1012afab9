"""The port's knob registry: only the environment knobs this package reads.

Counterpart of ``grit_tpu/api/config.py``. The names are wire/env
contracts shared with the unchanged node agent and shim, so they keep
their ``GRIT_TPU_`` spelling.
"""

from __future__ import annotations

import os
from dataclasses import dataclass


@dataclass(frozen=True)
class Knob:
    """One declared string knob; every read goes to ``os.environ``."""

    name: str
    default: str
    help: str

    def get(self) -> str:
        return os.environ.get(self.name, self.default)


TPU_SOCKET_DIR = Knob(
    "GRIT_TPU_SOCKET_DIR", "/tmp",
    "Directory of the per-pid agentlet toggle sockets "
    "(grit-tpu-<pid>.sock) shared by workload and agent.")
TPU_RESTORE_DIR = Knob(
    "GRIT_TPU_RESTORE_DIR", "",
    "HBM snapshot dir to restore from; injected by the shim on "
    "restore-mode creates.")
