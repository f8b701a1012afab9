"""The build stamp the workload's ``/version`` endpoint serves.

Counterpart of ``grit_tpu/version.py``: ``"grit-tpu <version> (<sha>)"``,
the sha from ``GRIT_TPU_GIT_SHA`` (baked into an image, which has no
``.git``) or else from a live checkout's ``git rev-parse``, with the
port's own ``__version__``.
"""

from __future__ import annotations

import os
import subprocess

from grit_tpu_torch import __version__
from grit_tpu_torch.api import config


def git_sha() -> str:
    sha = config.TPU_GIT_SHA.get()
    if sha:
        return sha
    try:
        return subprocess.run(
            ["git", "rev-parse", "--short", "HEAD"],
            cwd=os.path.dirname(os.path.abspath(__file__)),
            capture_output=True, text=True, timeout=5,
        ).stdout.strip() or "unknown"
    except Exception:  # noqa: BLE001 - no git in the image
        return "unknown"


def version_string() -> str:
    return f"grit-tpu {__version__} ({git_sha()})"
