"""Per-migration flight recorder: a crash-safe log of phase-boundary events.

Counterpart of ``grit_tpu/obs/flight.py``, writing the same file in the
same line schema, so the unchanged agent, its hook and a port workload
append to one log and ``tools/gritscope`` turns it into one migration's
phases:

- **One append-only JSONL file per migration**
  (:data:`grit_tpu_torch.metadata.FLIGHT_LOG_FILE`) in the agent's
  work/stage dir, keyed by the Checkpoint uid (by default the basename of
  that dir). It never ships with the checkpoint.
- **Crash-safe**: every event is one ``O_APPEND`` write of one JSON line;
  phase-boundary events also fsync (all but :data:`_NO_FSYNC`), so a
  SIGKILL mid-migration still leaves a readable partial timeline, and a
  reader skips a torn trailing line.
- **Every event carries wall and monotonic times** plus host, pid and
  role; ``GRIT_FLIGHT_CLOCK`` (the manager's pair) is echoed as
  ``clock.manager``.
- **Event names are a closed registry** (:data:`EVENTS`, the
  reference's): an unknown name is dropped with a warning, never fatal.

:func:`configure` and :func:`emit` record only under ``GRIT_FLIGHT``;
:func:`emit_near` (the workload's agentlet dump and the restored
process's place loop) is not gated on it: it walks up from a directory to
the log the agent created there, so a workload whose environment predates
the migration still joins it, and a directory with no such log is left
untouched. The reference's phase profiler, armed by these events, is not
part of the port.
"""

from __future__ import annotations

import json
import logging
import os
import socket
import threading
import time
from typing import Any

from grit_tpu_torch.api import config
from grit_tpu_torch.metadata import FLIGHT_LOG_FILE
from grit_tpu_torch.obs.metrics import FLIGHT_EVENTS

log = logging.getLogger(__name__)

#: The reference's closed registry of flight events, whole, grouped by
#: phase family (the first dotted segment — also the bounded label of
#: ``grit_flight_events_total``); gritscope's phase model reads these
#: names. ``tests/test_torch_flight.py`` holds it equal to the
#: reference's and every emit site of this package to a literal name
#: from it.
EVENTS = (
    # lifecycle / clock alignment
    "migration.configure",
    "clock.manager",
    "clock.peer",
    # source: the agent's whole blackout leg (enclosing, lowest-priority
    # phase: glue between the named phases attributes here, not to a gap)
    "source.start",
    "source.end",
    # source: quiesce + device dump
    "quiesce.start",
    "quiesce.end",
    "dump.start",
    "dump.chunk",
    "dump.end",
    # speculative (quiesce-free) dump: the concurrent pass launched at
    # the quiesce REQUEST (before the park) and the validation decision
    # at the step boundary — the bracket gritscope attributes as
    # dump_concurrent, showing the dump overlapping execution instead
    # of sitting inside the blackout window
    "snap.speculative.start",
    "snap.speculative.validated",
    "precopy.start",
    "precopy.end",
    # one bracket per convergence-loop round (round 0 = the full pass)
    "precopy.round.start",
    "precopy.round.end",
    # standby mode: one bracket per governed delta round (round 0 = the
    # arming full pass), plus the instant the arm/fire protocol fired
    "standby.round.start",
    "standby.round.end",
    "standby.fire",
    # source: process (CRIU) dump + transport
    "criu.dump.start",
    "criu.dump.end",
    "upload.start",
    "upload.end",
    "wire.open",
    "wire.send.start",
    "wire.send.end",
    "wire.commit.start",
    "wire.commit.end",
    "wire.close",
    # destination: receive + stage + restore
    "wire.recv.open",
    "wire.recv.commit",
    "wire.recv.fail",
    "stage.start",
    "stage.end",
    # restored process: interpreter+import window (prefetch opens it as
    # the process's first statement; restore_snapshot closes it)
    "restart.start",
    "restart.end",
    "criu.restore.start",
    "criu.restore.end",
    "place.start",
    "place.waterline",
    "place.end",
    # post-copy restore: the cold-array tail placed AFTER the workload
    # resumed (blackout ends at "hot set placed", the tail overlaps the
    # restart/compile window and first-touch blocks per array)
    "postcopy.tail.start",
    "postcopy.tail.end",
    # codec stage
    "codec.wait",
    # native file data plane (gritio-file): one summary point per leg —
    # io.drain when a dump's mirror tee ran the native drain (raw/comp
    # bytes, wall), io.place when a restore's container/raw reads went
    # through the native place path (bytes, read engine), io.degrade
    # whenever a leg that WOULD have run native fell back to the Python
    # plane (reason) — the loud half of the degrade contract.
    "io.drain",
    "io.place",
    "io.degrade",
    # gang slice migration (grit_tpu.agent.slicerole + coordination):
    # the cross-host quiesce barrier bracket (per host: from "reached
    # the agreed cut step" to "every host arrived"), the instant a
    # destination leg verified and parked prepared, and the slice-wide
    # commit/abort decisions any host may record in the shared ledger
    "slice.barrier.start",
    "slice.barrier.end",
    "slice.prepared",
    "slice.commit",
    "slice.abort",
    # resume / recovery
    "resume.start",
    "resume.end",
    "abort.start",
    "abort.end",
    # manager control plane
    "manager.phase",
    "manager.abort",
    # fleet migration scheduler (grit_tpu.manager.fleet): plan-level
    # decisions keyed by the PLAN name as uid — phase/verdict moves,
    # each bin-packing placement, each admission wave advancing, and
    # each member failure resolution (retry vs recorded-failed)
    "fleet.plan",
    "fleet.place",
    "fleet.wave",
    "fleet.abort",
    # serving snapshot fan-out (grit_tpu.serving + the RestoreSet
    # controller): the request-drain bracket the serving agentlet runs
    # before parking at a batch boundary (per drain: policy, slots
    # drained vs serialized), the fan-out decision keyed by the
    # SNAPSHOT name as uid, and per-clone lifecycle points (created /
    # first served while the cold tail was still in flight / ready /
    # aborted) from both the controller and the in-process fan-out legs
    "serve.drain.start",
    "serve.drain.end",
    "serve.fanout",
    "serve.clone.start",
    "serve.clone.served",
    "serve.clone.ready",
    "serve.clone.abort",
)

_EVENT_SET = frozenset(EVENTS)

#: High-rate waterline/progress events: flushed, not fsynced (a lost
#: trailing waterline costs resolution, not the timeline).
_NO_FSYNC = frozenset(("dump.chunk", "place.waterline", "codec.wait",
                       "manager.phase"))

_lock = threading.Lock()
_recorder: "Recorder | None" = None
#: The recorder the most recent emission actually used. Differs from
#: the configured one in processes that never call configure() — the
#: workload's agentlet and the restored pod join the migration via
#: emit_near's walk-up. Log correlation reads this so THOSE processes'
#: lines carry the uid too.
_last_active: "Recorder | None" = None
#: dir → Recorder (or None): walk-up results cached as OBJECTS so the
#: hot emit_near events (dump.chunk per HBM chunk) pay a dict hit, not
#: a Recorder construction (env read + path normalization) per event.
_near_cache: dict[str, "Recorder | None"] = {}
_warned_unknown: set[str] = set()
# Cached once: a gethostname() syscall per event would tax the exact
# blackout window the recorder measures (dump.chunk fires per chunk).
_HOST = socket.gethostname()


def enabled() -> bool:
    """Flight recording is opt-in (``GRIT_FLIGHT``): emit sites are one
    env read when off, exactly like trace/faults."""
    return config.FLIGHT.get_flag()


class Recorder:
    """One migration's flight log. Stateless between events on purpose:
    each emit is an independent ``open(append) → write one line →
    [fsync] → close`` so concurrent processes (agent, workload agentlet,
    shim) can append to the same file safely (single-``write`` O_APPEND
    lines), and a crashed writer never wedges a shared handle."""

    def __init__(self, path: str, uid: str, role: str) -> None:
        self.path = path
        self.uid = uid
        self.role = role
        # Tee target resolved ONCE (env read + path normalization are
        # per-event costs otherwise; the env is stable for a process).
        self._tee: str | None = None
        tee_dir = config.FLIGHT_DIR.get()
        if tee_dir:
            tee = os.path.join(
                tee_dir, f"flight-{_HOST}-{os.getpid()}.jsonl")
            if os.path.abspath(tee) != os.path.abspath(path):
                try:
                    os.makedirs(tee_dir, exist_ok=True)
                    self._tee = tee
                except OSError:
                    self._tee = None

    def write(self, event: str, durable: bool,
              fields: dict[str, Any]) -> None:
        record = {
            "ev": event,
            "uid": self.uid,
            "role": self.role,
            "wall": time.time(),
            "mono": time.monotonic(),
            "host": _HOST,
            "pid": os.getpid(),
        }
        record.update(fields)
        line = json.dumps(record, default=str) + "\n"
        try:
            self._append(self.path, line, durable)
        except OSError as exc:
            # Observability must never take down the data path.
            log.warning("flight log %s unwritable: %s", self.path, exc)
        if self._tee is not None:
            # Lane artifact tee: one file per process so concurrent test
            # migrations do not interleave partial lines across hosts.
            try:
                self._append(self._tee, line, False)
            except OSError:
                pass

    @staticmethod
    def _append(path: str, line: str, durable: bool) -> None:
        fd = os.open(path, os.O_WRONLY | os.O_CREAT | os.O_APPEND, 0o644)
        try:
            os.write(fd, line.encode())
            if durable:
                os.fsync(fd)
        finally:
            os.close(fd)


def _default_uid(dir_path: str) -> str:
    return os.path.basename(os.path.normpath(dir_path)) or "migration"


def configure(dir_path: str, role: str, uid: str | None = None) -> None:
    """Open (or adopt) the migration's flight log in ``dir_path`` and make
    it this process's default sink. Called by the agent drivers at entry
    (checkpoint/restore/abort); a no-op when ``GRIT_FLIGHT`` is off.

    Emits ``migration.configure`` (the recorder's own clock pair — the
    anchor every later event aligns against) and, when the manager
    stamped its pair into this Job's env (``GRIT_FLIGHT_CLOCK``), a
    ``clock.manager`` event echoing it so manager-side events can be
    placed on the agent timeline."""
    global _recorder
    if not enabled():
        return
    try:
        os.makedirs(dir_path, exist_ok=True)
    except OSError as exc:
        log.warning("flight: cannot create %s: %s", dir_path, exc)
        return
    path = os.path.join(dir_path, FLIGHT_LOG_FILE)
    with _lock:
        _recorder = Recorder(path, uid or _default_uid(dir_path), role)
        _near_cache.clear()
    emit("migration.configure", dir=dir_path)
    raw_clock = config.FLIGHT_CLOCK.get()
    if raw_clock:
        try:
            pair = json.loads(raw_clock)
            emit("clock.manager",
                 peer_wall=float(pair.get("wall", 0.0)),
                 peer_mono=float(pair.get("mono", 0.0)),
                 peer_host=str(pair.get("host", "")),
                 peer_pid=int(pair.get("pid", 0)))
        except (ValueError, TypeError):
            log.warning("flight: malformed %s=%r ignored",
                        config.FLIGHT_CLOCK.name, raw_clock)


def clock_pair() -> dict[str, Any]:
    """This process's wall/monotonic pair, for handshake exchange (the
    wire commit/ack and the manager's Job stamp both carry one)."""
    return {"wall": time.time(), "mono": time.monotonic(),
            "host": socket.gethostname(), "pid": os.getpid()}


def current() -> "Recorder | None":
    with _lock:
        return _recorder


def active() -> "Recorder | None":
    """The configured recorder, or — in processes that never ran
    configure() (workload agentlet, restored pod) — the recorder the
    most recent emission resolved to. The migration context for log
    correlation."""
    with _lock:
        return _recorder or _last_active


def reset() -> None:
    """Forget the configured recorder (tests)."""
    global _recorder, _last_active
    with _lock:
        _recorder = None
        _last_active = None
        _near_cache.clear()


def emit(event: str, dir: str | None = None, **fields: object) -> None:  # noqa: A002
    """Record one event on the configured recorder (or, with ``dir``, on
    the flight log governing that directory — see :func:`emit_near` for
    the lookup). Cheap no-op when recording is off; unknown event names
    are dropped with a loud (once) warning — ``tests/test_torch_flight.py``
    catches them statically, and a typo at runtime must not crash a
    data-path leg."""
    if not enabled():
        return
    if event not in _EVENT_SET:
        if event not in _warned_unknown:
            _warned_unknown.add(event)
            log.warning("flight: undeclared event %r dropped "
                        "(register it in grit_tpu_torch.obs.flight.EVENTS)",
                        event)
        return
    # Priority: a dir-carrying event belongs to the log governing that
    # dir (source and destination drivers can share one process — the
    # harness does — and the module-global recorder then points at
    # whichever configured last); then the configured recorder; then the
    # artifact-dir fallback (processes with no work/stage dir — the
    # manager; gritscope merges by the uid the event carries).
    rec = _resolve(dir) or _dir_recorder()
    if rec is None:
        return
    family = event.split(".", 1)[0]
    FLIGHT_EVENTS.inc(phase=family)
    rec.write(event, event not in _NO_FSYNC, fields)


def emit_near(dir_path: str, event: str, **fields: object) -> None:
    """Emit onto the flight log that governs ``dir_path`` — found by
    walking up a bounded number of parents, exactly like the stage
    journal's ``_StageMonitor.find``. This is how processes that never
    ran :func:`configure` (the workload's agentlet dump, the restored
    workload's place loop, the shim) join the migration's log: the
    driver created the file at the work/stage root, and the device dirs
    live a few levels below it. No file found → recording is off for
    this dir (never create stray files inside snapshot trees).

    Deliberately NOT gated on ``GRIT_FLIGHT``: the emitting process is
    often a workload pod whose environment predates the migration (a
    running pod cannot be re-env'd, and a restored pod inherits the
    pre-dump env). The per-migration log file IS the enablement signal —
    the driver only creates it when flight recording is on, and the
    walk-up is one cached stat when it is off."""
    rec = _resolve(dir_path)
    if rec is None:
        return
    emit_on(rec, event, **fields)


def emit_on(rec: Recorder, event: str, **fields: object) -> None:
    global _last_active
    if rec is None:
        return
    with _lock:
        _last_active = rec
    if event not in _EVENT_SET:
        # Warn directly: emit()'s funnel is env-gated, and this path
        # serves exactly the processes whose env predates the migration.
        if event not in _warned_unknown:
            _warned_unknown.add(event)
            log.warning("flight: undeclared event %r dropped "
                        "(register it in grit_tpu_torch.obs.flight.EVENTS)",
                        event)
        return
    family = event.split(".", 1)[0]
    FLIGHT_EVENTS.inc(phase=family)
    rec.write(event, event not in _NO_FSYNC, fields)


def _resolve(dir_path: str | None) -> Recorder | None:
    """The recorder for an event: the log governing ``dir_path`` when
    given (keeping the configured recorder — and its role — when it IS
    that log), else the configured recorder."""
    cur = current()
    if dir_path is None:
        return cur
    near = _find_near(dir_path)
    if near is None:
        return cur
    if cur is not None and os.path.abspath(cur.path) == \
            os.path.abspath(near.path):
        return cur
    return near


def _dir_recorder() -> Recorder | None:
    tee_dir = config.FLIGHT_DIR.get()
    if not tee_dir:
        return None
    try:
        os.makedirs(tee_dir, exist_ok=True)
    except OSError:
        return None
    path = os.path.join(
        tee_dir, f"flight-{_HOST}-{os.getpid()}.jsonl")
    return Recorder(path, "manager", "manager")


def _find_near(dir_path: str) -> Recorder | None:
    d = os.path.abspath(dir_path)
    with _lock:
        if d in _near_cache:
            return _near_cache[d]
    probe = d
    found: str | None = None
    for _ in range(5):
        p = os.path.join(probe, FLIGHT_LOG_FILE)
        if os.path.isfile(p):
            found = p
            break
        parent = os.path.dirname(probe)
        if parent == probe:
            break
        probe = parent
    rec = (Recorder(found, _default_uid(os.path.dirname(found)), "device")
           if found is not None else None)
    with _lock:
        if len(_near_cache) >= 256:
            _near_cache.clear()
        _near_cache[d] = rec
    return rec


def read_flight_file(path: str) -> list[dict[str, Any]]:
    """Parse one flight JSONL log. A torn trailing line (crashed writer)
    is skipped, not fatal — the analyzer reconstructs the partial
    timeline and marks the gap."""
    out: list[dict[str, Any]] = []
    with open(path, encoding="utf-8", errors="replace") as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except ValueError:
                continue
            if isinstance(rec, dict) and "ev" in rec:
                out.append(rec)
    return out
