"""Early restore prefetch: open the restart window and warm the page cache
before ``import torch``.

Counterpart of ``grit_tpu/prefetch.py``. A restored workload's blackout
is interpreter start and imports, set-up, the state's load and the first
step. The load reads files, which needs nothing of torch, so the
restoring process calls :func:`start_restore_prefetch` before it imports
torch (``grit_tpu_torch.workload`` does, when run as a program): the
snapshot's bytes stream into the page cache while ``import torch`` burns
CPU, and the restore's reads hit memory.

It also makes the restored process visible from its first statements:

- it emits ``restart.start`` on the migration's flight log
  (:func:`~grit_tpu_torch.obs.flight.emit_near`'s walk-up from the
  snapshot), which opens the window the restore's ``restart.end`` closes,
  so the flight log splits kill → ``place.start`` at the process's start;
- it starts the workload's metrics server and its sampler
  (``GRIT_WORKLOAD_METRICS_PORT``), so the place loop's progress gauges
  are scrapeable through the whole restore;
- it installs log correlation.

``posix_fadvise(WILLNEED)`` starts the kernel's readahead, then a
sequential read on a daemon thread (``grit-restore-prefetch``) backs it
up. This module and everything it imports is stdlib-only: no torch.
"""

from __future__ import annotations

import logging
import os
import threading

from grit_tpu_torch.api import config

log = logging.getLogger(__name__)

_READ_CHUNK = 8 << 20


def _warm_file(path: str) -> None:
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:
        return
    try:
        try:
            size = os.fstat(fd).st_size
            os.posix_fadvise(fd, 0, size, os.POSIX_FADV_WILLNEED)
        except (AttributeError, OSError):
            pass
        # The sequential read backs up the fadvise.
        while os.read(fd, _READ_CHUNK):
            pass
    except OSError:
        pass
    finally:
        os.close(fd)


def _warm_tree(directory: str) -> None:
    for root, _dirs, files in os.walk(directory):
        for name in files:
            _warm_file(os.path.join(root, name))


def start_restore_prefetch(directory: str | None = None,
                           ) -> threading.Thread | None:
    """Open the restart window and start streaming the snapshot in
    ``directory`` (default ``$GRIT_TPU_RESTORE_DIR``, which the shim
    injects) into the page cache. Returns the daemon thread, or None when
    there is nothing to prefetch. Never raises: a missing or unreadable
    directory leaves the restore to read cold."""
    try:
        d = directory or config.TPU_RESTORE_DIR.get()
        if not d or not os.path.isdir(d) \
                or not os.access(d, os.R_OK | os.X_OK):
            return None
        from grit_tpu_torch.obs import flight  # noqa: PLC0415

        flight.emit_near(d, "restart.start")
        from grit_tpu_torch.obs.server import (  # noqa: PLC0415
            start_workload_metrics_server,
        )

        start_workload_metrics_server()
        from grit_tpu_torch.obs.logctx import (  # noqa: PLC0415
            install_log_correlation,
        )

        install_log_correlation()
        t = threading.Thread(target=_warm_tree, args=(d,),
                             name="grit-restore-prefetch", daemon=True)
        t.start()
        return t
    except Exception as exc:  # noqa: BLE001 — the restore reads cold instead
        log.warning("restore prefetch of %r failed: %s", directory, exc,
                    exc_info=True)
        return None
