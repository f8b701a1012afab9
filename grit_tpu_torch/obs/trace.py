"""Distributed tracing for the migration path.

Counterpart of ``grit_tpu/obs/trace.py``, exporting the same span records,
so ``grit_tpu.obs.trace.read_trace_file`` and ``tools/gritscope`` read a
port workload's spans beside the agent's:

- **Noop by default.** Tracing turns on only when ``GRIT_TPU_TRACE_FILE``
  names a JSONL sink (one OTLP-shaped span dict per line). Several
  processes may append to one sink.
- **W3C context propagation.** One migration is one trace across
  processes: a child process gets ``TRACEPARENT`` (:func:`inject_env`)
  and reads it back (:func:`extract_parent`).
- **Threading.** The current span is thread-local; work handed to a pool
  or a background thread joins the submitter's trace through
  :func:`current_context` and :func:`parented`/:func:`wrap_parented`
  (the codec pool, the mirror writer, the restore's readers and the
  post-copy tail), so no span is an orphan.

The reference's mirror of spans through an installed OpenTelemetry SDK
is not ported.
"""

from __future__ import annotations

import json
import os
import secrets
import threading
import time
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Any, Callable, Iterator, Mapping, TextIO

from grit_tpu_torch.api import config

TRACEPARENT_ENV = "TRACEPARENT"
TRACE_FILE_ENV = config.TPU_TRACE_FILE.name

_local = threading.local()
_lock = threading.Lock()


def enabled() -> bool:
    return bool(config.TPU_TRACE_FILE.get())


@dataclass
class SpanContext:
    trace_id: str  # 32 hex chars
    span_id: str   # 16 hex chars

    def traceparent(self) -> str:
        return f"00-{self.trace_id}-{self.span_id}-01"


@dataclass
class Span:
    name: str
    context: SpanContext
    parent_span_id: str | None
    start_ns: int
    attributes: dict[str, Any] = field(default_factory=dict)
    status: str = "OK"

    def set_attribute(self, key: str, value: object) -> None:
        self.attributes[key] = value


def _current() -> Span | None:
    return getattr(_local, "span", None)


def parse_traceparent(value: str) -> SpanContext | None:
    """``00-<trace>-<span>-<flags>`` → SpanContext; None if malformed."""
    parts = value.strip().split("-")
    if len(parts) != 4 or len(parts[1]) != 32 or len(parts[2]) != 16:
        return None
    return SpanContext(trace_id=parts[1], span_id=parts[2])


def current_traceparent() -> str | None:
    """The active span's W3C traceparent, for manual propagation."""
    span = _current()
    return span.context.traceparent() if span else None


def current_context() -> SpanContext | None:
    """The calling thread's effective parent context: the active span's,
    or the fallback installed by :func:`parented`. Capture this BEFORE
    handing work to a pool/background thread — the span stack is
    thread-local, so without it every pooled span roots a new trace."""
    span = _current()
    if span is not None:
        return span.context
    return getattr(_local, "parent_ctx", None)


@contextmanager
def parented(ctx: SpanContext | None) -> Iterator[None]:
    """Install ``ctx`` as this thread's fallback parent for the duration.

    The hand-off half of cross-thread propagation: the submitting thread
    captures :func:`current_context` and the worker runs inside
    ``parented(ctx)`` — spans (and :func:`record_span`) opened there join
    the migration trace instead of rooting their own. Nests safely (the
    previous fallback is restored) and is a no-op for ``ctx=None``."""
    prev = getattr(_local, "parent_ctx", None)
    _local.parent_ctx = ctx if ctx is not None else prev
    try:
        yield
    finally:
        _local.parent_ctx = prev


def wrap_parented(fn: Callable[..., Any],
                  ctx: SpanContext | None = None) -> Callable[..., Any]:
    """Bind ``fn`` to the submitting thread's trace context: returns a
    callable that runs ``fn`` under :func:`parented`. The one-line seam
    pool submissions thread the parent through (codec pool, mirror
    writer)."""
    if ctx is None:
        ctx = current_context()
    if ctx is None:
        return fn

    def run(*args: Any, **kwargs: Any) -> Any:
        with parented(ctx):
            return fn(*args, **kwargs)

    return run


def inject_env(env: Mapping[str, str] | None = None) -> dict[str, str]:
    """Add ``TRACEPARENT`` for a child process (no-op when not tracing)."""
    env = dict(env or {})
    tp = current_traceparent()
    if tp:
        env[TRACEPARENT_ENV] = tp
    return env


def extract_parent(
        environ: Mapping[str, str] | None = None) -> SpanContext | None:
    """Remote parent from ``TRACEPARENT`` in the (process) environment."""
    environ = environ if environ is not None else os.environ
    raw = environ.get(TRACEPARENT_ENV, "")
    return parse_traceparent(raw) if raw else None


def _service_name() -> str:
    return os.environ.get("OTEL_SERVICE_NAME", "grit-tpu")


# Export sink state, all under _lock: a cached append handle (one open
# per sink, not one per span — the old per-span open was measurable on
# chunk-hot paths), plus a retry clock so a failed sink RECOVERS on a
# later successful open instead of latching broken for the process
# lifetime (the disk-full-then-cleared case).
_sink_path: str | None = None
_sink_file: TextIO | None = None
_sink_retry_at = 0.0
_SINK_RETRY_S = 5.0
_sink_warned = False
_sink_check_at = 0.0
_SINK_CHECK_S = 5.0


def _sink_stale_locked() -> bool:
    """True when the cached handle no longer backs the sink path (the
    file was rotated/deleted): the open-per-span code recreated it
    implicitly; the cached handle must notice, at a coarse interval, or
    every later span writes to an orphaned inode forever."""
    global _sink_check_at
    now = time.monotonic()
    if now < _sink_check_at:
        return False
    _sink_check_at = now + _SINK_CHECK_S
    try:
        disk = os.stat(_sink_path)
        here = os.fstat(_sink_file.fileno())
        return (disk.st_ino, disk.st_dev) != (here.st_ino, here.st_dev)
    except OSError:
        return True  # unlinked (or handle broken): reopen


def _sink_open_locked(path: str) -> TextIO | None:
    """(Re)open the sink for append, healing the torn-line boundary: a
    writer killed mid-line leaves the file without a trailing newline,
    and a new record appended raw would glue onto the torn line — both
    records would then be lost to every reader. Start on a fresh line."""
    global _sink_path, _sink_file
    if _sink_file is not None and _sink_path == path \
            and not _sink_stale_locked():
        return _sink_file
    if _sink_file is not None:
        try:
            _sink_file.close()
        except OSError:
            pass
        _sink_file = None
    needs_newline = False
    try:
        with open(path, "rb") as probe:
            probe.seek(0, os.SEEK_END)
            if probe.tell() > 0:
                probe.seek(-1, os.SEEK_END)
                needs_newline = probe.read(1) != b"\n"
    except OSError:
        pass  # absent file: nothing to heal
    f = open(path, "a")
    if needs_newline:
        f.write("\n")
    _sink_path, _sink_file = path, f
    return f


def _sink_close_locked() -> None:
    global _sink_path, _sink_file
    if _sink_file is not None:
        try:
            _sink_file.close()
        except OSError:
            pass
    _sink_path, _sink_file = None, None


def close_export() -> None:
    """Close the cached sink handle (tests flip the sink path; a process
    about to exec should flush)."""
    with _lock:
        _sink_close_locked()


def _export(span: Span, end_ns: int) -> None:
    global _sink_retry_at, _sink_warned
    path = config.TPU_TRACE_FILE.get()
    if not path:
        return
    record = {
        "traceId": span.context.trace_id,
        "spanId": span.context.span_id,
        "parentSpanId": span.parent_span_id or "",
        "name": span.name,
        "startTimeUnixNano": span.start_ns,
        "endTimeUnixNano": end_ns,
        "serviceName": _service_name(),
        "status": span.status,
        "attributes": span.attributes,
    }
    line = json.dumps(record, default=str) + "\n"
    with _lock:
        if _sink_file is None and time.monotonic() < _sink_retry_at:
            return  # sink recently failed; back off, retry soon
        try:
            f = _sink_open_locked(path)
            f.write(line)
            f.flush()
            if _sink_warned:
                _sink_warned = False
                import logging

                logging.getLogger(__name__).warning(
                    "trace sink %s recovered; tracing resumed", path)
            return
        except OSError as e:
            # Observability must never take down the data path (and must
            # not mask an in-flight exception from span()'s finally):
            # drop this span, close the handle, and retry the open after
            # a short backoff — a cleared disk recovers the sink instead
            # of the old latched-forever disable.
            _sink_close_locked()
            _sink_retry_at = time.monotonic() + _SINK_RETRY_S
            if not _sink_warned:
                _sink_warned = True
                import logging

                logging.getLogger(__name__).warning(
                    "trace sink %s unwritable (%s); dropping spans, will "
                    "retry in %.0fs", path, e, _SINK_RETRY_S)


@contextmanager
def span(name: str, parent: SpanContext | None = None,
         **attributes: object) -> "Iterator[Span | _NoopSpan]":
    """Context manager for one span. Near-zero cost when disabled (one
    env lookup); exceptions mark the span ERROR and re-raise."""
    if not enabled():
        yield _NOOP_SPAN
        return
    prev = _current()
    if parent is None and prev is not None:
        parent = prev.context
    if parent is None:
        # Cross-thread fallback (parented()): pool/background threads
        # join the submitting thread's trace instead of rooting new ones.
        parent = getattr(_local, "parent_ctx", None)
    ctx = SpanContext(
        trace_id=parent.trace_id if parent else secrets.token_hex(16),
        span_id=secrets.token_hex(8),
    )
    s = Span(
        name=name,
        context=ctx,
        parent_span_id=parent.span_id if parent else None,
        start_ns=time.time_ns(),
        attributes=dict(attributes),
    )
    _local.span = s
    try:
        yield s
    except BaseException:
        s.status = "ERROR"
        raise
    finally:
        _local.span = prev
        _export(s, time.time_ns())


def record_span(name: str, start_unix_ns: int, *,
                parent: SpanContext | None = None,
                status: str = "OK", **attributes: object) -> None:
    """Export a span retroactively (no context management) — for hot
    paths that already time themselves and must not grow an indent level.
    Joins the calling thread's current span when no parent is given."""
    if not enabled():
        return
    cur = _current()
    if parent is None and cur is not None:
        parent = cur.context
    if parent is None:
        parent = getattr(_local, "parent_ctx", None)
    ctx = SpanContext(
        trace_id=parent.trace_id if parent else secrets.token_hex(16),
        span_id=secrets.token_hex(8),
    )
    s = Span(name=name, context=ctx,
             parent_span_id=parent.span_id if parent else None,
             start_ns=start_unix_ns, attributes=dict(attributes),
             status=status)
    _export(s, time.time_ns())


class _NoopSpan:
    __slots__ = ()

    def set_attribute(self, key: str, value: object) -> None:
        pass


_NOOP_SPAN = _NoopSpan()


def read_trace_file(path: str) -> list[dict[str, Any]]:
    """Parse a JSONL trace sink (test/docs helper). Malformed lines are
    skipped, not fatal: several processes append under per-process locks
    only, so a torn line at a crash boundary must not poison the whole
    trace."""
    out: list[dict[str, Any]] = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                out.append(json.loads(line))
            except ValueError:
                continue
    return out
