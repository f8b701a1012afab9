"""Workload-side restore hook: where a restored process finds its snapshot.

Counterpart of ``grit_tpu/device/hook.py:restore_dir_from_env``. The shim
injects ``GRIT_TPU_RESTORE_DIR`` into a restore-mode container; the
workload's trainer calls :func:`restore_dir_from_env` once before its
first step. The agent side of the hook (the node agent's device hook)
is the unchanged reference's, driving this package's agentlet over the
shared toggle protocol.
"""

from __future__ import annotations

from grit_tpu_torch.api import config
from grit_tpu_torch.device.snapshot import snapshot_exists

# Subdirectory of a container checkpoint that holds the device snapshot.
HBM_SUBDIR = "hbm"
RESTORE_ENV = config.TPU_RESTORE_DIR.name


def restore_dir_from_env() -> str | None:
    """The snapshot dir to restore from: ``GRIT_TPU_RESTORE_DIR`` when it
    holds a committed snapshot, else None."""
    d = config.TPU_RESTORE_DIR.get()
    if not d:
        return None
    return d if snapshot_exists(d) else None
