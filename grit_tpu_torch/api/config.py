"""The port's knob registry: only the environment knobs this package reads.

Counterpart of ``grit_tpu/api/config.py``. The names are wire/env
contracts shared with the unchanged node agent, shim and control plane,
so they keep the reference's spelling.
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
SERVE_DRAIN_MODE = Knob(
    "GRIT_SERVE_DRAIN_MODE", "serialize",
    "Request-drain policy the serving agentlet applies when a quiesce "
    "lands: 'serialize' (default) parks at the next batch boundary and "
    "ships in-flight slots' KV/position state inside the snapshot; "
    "'drain' keeps decoding admitted requests to completion (EOS/"
    "length) before parking — bounded by GRIT_SERVE_DRAIN_TIMEOUT_S. "
    "Unknown values degrade to 'serialize' loudly.")
SERVE_DRAIN_TIMEOUT_S = Knob(
    "GRIT_SERVE_DRAIN_TIMEOUT_S", "30.0",
    "Ceiling, in seconds, on the 'drain' policy's run-to-completion "
    "window. Expiry raises ServingDrainTimeout out of the serving loop — "
    "a drain that cannot finish must fail the migration attempt loudly, "
    "never silently serialize or park a half-drained batch.")
