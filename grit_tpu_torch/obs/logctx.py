"""Log correlation: stamp the migration uid and role onto every record.

Counterpart of ``grit_tpu/obs/logctx.py``. A log-record factory wrapper
stamps ``grit_uid``/``grit_role`` (from the process's flight recorder:
the configured one, or the log the last :func:`~grit_tpu_torch.obs.flight.emit_near`
found) onto every record, whichever logger made it, and a formatter
wrapper appends ``[uid=... role=...]`` to a rendered line when a
migration context exists, so a workload's log lines join the gritscope
timeline with one grep. The agentlet's start installs it
(:func:`install_log_correlation` is idempotent and never raises).
"""

from __future__ import annotations

import logging
import threading

from grit_tpu_torch.obs import flight

_lock = threading.Lock()
_installed = False


def _context() -> tuple[str, str]:
    """(uid, role) of this process's live migration, or ("", "").
    ``flight.active()``, not ``current()``: workload and restored-pod
    processes never call configure() — they join the migration through
    emit_near's walk-up, and correlation must cover exactly them."""
    rec = flight.active()
    if rec is None:
        return "", ""
    return rec.uid, rec.role


class CorrelationFormatter(logging.Formatter):
    """Wraps another formatter, appending the migration context to the
    rendered line when one exists."""

    def __init__(self, inner: logging.Formatter | None = None) -> None:
        super().__init__()
        self._inner = inner or logging.Formatter()

    def format(self, record: logging.LogRecord) -> str:
        line = self._inner.format(record)
        uid = getattr(record, "grit_uid", "")
        if uid:
            role = getattr(record, "grit_role", "")
            line += f" [uid={uid} role={role}]"
        return line


def install_log_correlation() -> None:
    """Idempotent process-wide install: wrap the record factory (stamp
    attributes on every record) and the rendering path (append the
    context to rendered lines): the root handlers that exist get their
    formatter wrapped, and so does ``logging.lastResort``, which renders
    for a process with no root handler. No handler is added: the
    agentlet lives inside a user's workload, whose own logging set-up
    would then print every line twice."""
    global _installed
    with _lock:
        if _installed:
            return
        _installed = True
        try:
            factory = logging.getLogRecordFactory()

            def _with_context(*args: object, **kwargs: object) -> logging.LogRecord:
                record = factory(*args, **kwargs)
                uid, role = _context()
                record.grit_uid = uid
                record.grit_role = role
                return record

            logging.setLogRecordFactory(_with_context)
            root = logging.getLogger()
            for handler in root.handlers:
                if not isinstance(handler.formatter, CorrelationFormatter):
                    handler.setFormatter(
                        CorrelationFormatter(handler.formatter))
            last = logging.lastResort
            if last is not None \
                    and not isinstance(last.formatter,
                                       CorrelationFormatter):
                last.setFormatter(CorrelationFormatter(last.formatter))
        except Exception as exc:  # noqa: BLE001 — logging must not kill a leg
            logging.getLogger(__name__).warning(
                "log correlation install failed: %s", exc)


def reset() -> None:
    """Forget the install flag (tests). Does not unwrap the factory —
    the wrapper is idempotent and stamps empty strings when no
    migration is configured."""
    global _installed
    with _lock:
        _installed = False
