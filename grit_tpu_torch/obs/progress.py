"""Live migration progress: a leg's bytes, rate and ETA while it runs.

Counterpart of ``grit_tpu/obs/progress.py``. One :class:`ProgressTracker`
per migration role in this process (``source``: the dump's mirror tee and
the wire sender; ``workload``: the restored process's place loop, the
post-copy tail included), fed from the byte accounting the data path
already does, and published three ways, none of which touches a data
path's lock:

- the ``grit_progress_*`` gauges, refreshed by the periodic sampler
  (:mod:`grit_tpu_torch.obs.sampler`), so a scrape of the workload's
  ``/metrics`` between events reads live values;
- the node-local ``.grit-progress.json`` snapshot (atomically replaced,
  one tmp file a thread), for a tracker given a ``publish_dir``;
- :meth:`ProgressTracker.snapshot`, the record's one shape.

A feeder pays one dict hit and an integer add under a lock; every
publication runs on somebody else's cadence. The reference's lease and
manager helpers (``annotation_value``, ``wire_channel_totals``,
``host_pair_channels``) run in the reference agent's and manager's
processes and are not here.
"""

from __future__ import annotations

import json
import logging
import os
import threading
import time
from collections import deque
from typing import Any

from grit_tpu_torch.metadata import PROGRESS_FILE
from grit_tpu_torch.obs.metrics import (
    PROGRESS_BYTES_SHIPPED,
    PROGRESS_ETA_SECONDS,
    PROGRESS_RATE_BPS,
    PROGRESS_TOTAL_BYTES,
)

log = logging.getLogger(__name__)

#: Sliding window (seconds) the instantaneous rate/ETA derive from: long
#: enough to smooth frame bursts, short enough that a stall shows within
#: one watchdog poll.
RATE_WINDOW_S = 20.0

ROLE_SOURCE = "source"
ROLE_DESTINATION = "destination"
ROLE_WORKLOAD = "workload"


class ProgressTracker:
    """One migration leg's live counters. Thread-safe; bytes are
    monotonic by construction (a feeder can only add)."""

    def __init__(self, uid: str, role: str,
                 publish_dir: str | None = None,
                 ordinal: int | None = None,
                 clone: int | None = None) -> None:
        self.uid = uid
        self.role = role
        # Gang slice migration: this leg's host ordinal. Rides the
        # snapshot as "ord" (the per-host key the manager's
        # status.progress.hosts fan-in and gritscope watch group by);
        # the Prometheus role label stays the bounded base role — the
        # per-process gauges are per-host by construction anyway.
        self.ordinal = ordinal
        # RestoreSet fan-out: this restore leg's clone ordinal
        # (grit.dev/clone-ordinal → GRIT_CLONE_ORDINAL). Every clone
        # derives the SAME uid from the shared snapshot name, so the
        # ordinal is what lets `gritscope watch --restoreset` key live
        # per-clone progress files apart.
        self.clone = clone
        self._dir = publish_dir
        self._lock = threading.Lock()
        self._bytes = 0
        self._total = 0
        self._round = -1  # -1 = no pre-copy loop ran
        self._phase = ""
        self._dirty_bps: float | None = None
        self._link_bps: float | None = None
        # stream -> [bytes, first_mono, last_mono]: per-stream totals AND
        # active windows, so per-stream/channel throughput is derivable
        # (the N×N multi-host item budgets by exactly this).
        self._streams: dict[str, list[float]] = {}
        # Seeded with (t0, 0) so a leg that ships everything in one add
        # still has a baseline to rate against.
        self._samples: deque[tuple[float, int]] = deque(
            [(time.monotonic(), 0)])
        self._started_wall = time.time()
        self._advanced_wall = self._started_wall  # last FORWARD progress
        self._first_byte_mono: float | None = None
        self._last_byte_mono: float | None = None
        self._last_publish = 0.0
        # Most recent resource-ledger stamp (grit_tpu_torch.obs.profile
        # sample_ledger: live cores/IO rates/python share) — ledger
        # updates are NOT forward progress, so they never touch
        # _advanced_wall (a stalled transfer with a healthy sampler must
        # still trip the watchdog's ProgressStalled verdict).
        self._ledger: dict[str, Any] | None = None
        # Standby arm state (the reference agent's standby loop): lastBaseAt /
        # backlogBytes / tickAt / round counters. Like the ledger,
        # stamping it is NOT forward progress (idle-armed is a
        # legitimate state) — only shipped rounds bump advancedAt, via
        # note_round/add_bytes on the normal feeders.
        self._standby: dict[str, Any] | None = None

    # -- feeders (hot path: one lock, integer math) ---------------------------

    def add_bytes(self, n: int, stream: str | None = None) -> None:
        if n <= 0:
            return
        now = time.monotonic()
        with self._lock:
            self._bytes += n
            self._advanced_wall = time.time()
            if self._first_byte_mono is None:
                self._first_byte_mono = now
            self._last_byte_mono = now
            if stream is not None:
                slot = self._streams.get(stream)
                if slot is None:
                    self._streams[stream] = [n, now, now]
                else:
                    slot[0] += n
                    slot[2] = now
            self._samples.append((now, self._bytes))
            cutoff = now - RATE_WINDOW_S
            while len(self._samples) > 2 and self._samples[0][0] < cutoff:
                self._samples.popleft()

    def set_total(self, nbytes: int) -> None:
        """Best current estimate of bytes to ship; grows monotonically
        (more containers / rounds discovered), never shrinks."""
        with self._lock:
            self._total = max(self._total, int(nbytes))

    def add_total(self, nbytes: int) -> None:
        """Accumulate into the total: for feeders that see the work in
        independent batches (the post-copy restore places a hot subset,
        then the cold tail — each leg knows only ITS arrays, and a
        max() of subset sums would let bytesShipped run past the
        total)."""
        if nbytes > 0:
            with self._lock:
                self._total += int(nbytes)

    def note_round(self, rnd: int) -> None:
        with self._lock:
            if rnd > self._round:
                self._round = rnd
                self._advanced_wall = time.time()

    def set_phase(self, phase: str) -> None:
        with self._lock:
            if phase != self._phase:
                self._phase = phase
                self._advanced_wall = time.time()

    def set_standby(self, **fields: object) -> None:
        """Merge standby arm-state fields (lastBaseAt, backlogBytes,
        tickAt, roundsShipped, ...) into the snapshot's ``standby``
        record. Deliberately never touches ``_advanced_wall``: the
        governor ticking while idle-armed is health, not progress."""
        with self._lock:
            if self._standby is None:
                self._standby = {}
            self._standby.update(fields)

    def standby_state(self) -> dict[str, Any] | None:
        with self._lock:
            return dict(self._standby) if self._standby is not None \
                else None

    def set_ledger(self, ledger: dict[str, Any]) -> None:
        """Stamp the per-process resource ledger (cpu cores, io rates,
        python share, codec saturation) onto this leg's snapshot."""
        with self._lock:
            self._ledger = dict(ledger)

    def set_rates(self, dirty_bps: float | None = None,
                  link_bps: float | None = None) -> None:
        with self._lock:
            if dirty_bps is not None:
                self._dirty_bps = float(dirty_bps)
            if link_bps is not None:
                self._link_bps = float(link_bps)

    # -- derived views ---------------------------------------------------------

    def rate_bps(self) -> float:
        """Windowed shipping rate: bytes over the recent sample window.
        0.0 while idle — a stalled leg decays to zero as the window
        slides past its last sample."""
        now = time.monotonic()
        with self._lock:
            if len(self._samples) < 2:
                return 0.0
            first_t, first_b = self._samples[0]
            last_t, last_b = self._samples[-1]
            if last_t < now - RATE_WINDOW_S:
                return 0.0  # stalled: the window slid past the last byte
            # Rate over now - first_t (not last_t - first_t): a leg that
            # went quiet mid-window reads as SLOWING, not as its last
            # burst's instantaneous speed.
            span = max(now - first_t, 1e-6)
            return max(0.0, (last_b - first_b) / span)

    def avg_rate_bps(self) -> float:
        """Whole-leg average: total bytes over the first→last byte wall.
        The number CI compares against the bench wire throughput."""
        with self._lock:
            if self._first_byte_mono is None \
                    or self._last_byte_mono is None:
                return 0.0
            span = self._last_byte_mono - self._first_byte_mono
            return self._bytes / span if span > 0 else 0.0

    def channel_rate_bps(self, prefix: str = "") -> float:
        """Average throughput of the streams whose name starts with
        ``prefix`` (e.g. ``"wire-"``): their summed bytes over the union
        first→last-byte window. 0.0 when no matching stream has a
        nonzero window. The number the CI lane checks against the bench
        wire throughput."""
        with self._lock:
            slots = [s for name, s in self._streams.items()
                     if name.startswith(prefix)]
            if not slots:
                return 0.0
            total = sum(s[0] for s in slots)
            span = max(s[2] for s in slots) - min(s[1] for s in slots)
            return total / span if span > 0 else 0.0

    def eta_s(self) -> float | None:
        """Seconds until the remaining bytes ship at the windowed rate;
        None while unknowable (no total yet, or zero rate with bytes
        still outstanding); 0.0 once shipped >= total."""
        with self._lock:
            total, shipped = self._total, self._bytes
        if total <= 0:
            return None
        if shipped >= total:
            return 0.0
        rate = self.rate_bps()
        if rate <= 0:
            return None
        return (total - shipped) / rate

    def snapshot(self) -> dict[str, Any]:
        """The publication record: the reference's shape, the one its
        ``grit.dev/progress`` Job annotation, ``status.progress`` on the
        CR and the ``.grit-progress.json`` file carry."""
        eta = self.eta_s()
        rate = self.rate_bps()
        avg = self.avg_rate_bps()
        with self._lock:
            return {
                "uid": self.uid,
                "role": self.role,
                "phase": self._phase,
                "bytesShipped": self._bytes,
                "totalBytes": self._total,
                "round": self._round,
                "rateBps": round(rate, 1),
                "avgRateBps": round(avg, 1),
                "etaSeconds": (round(eta, 1) if eta is not None else None),
                "dirtyRateBps": (round(self._dirty_bps, 1)
                                 if self._dirty_bps is not None else None),
                "linkRateBps": (round(self._link_bps, 1)
                                if self._link_bps is not None else None),
                "streams": {
                    name: {"bytes": s[0],
                           "seconds": round(s[2] - s[1], 4)}
                    for name, s in self._streams.items()},
                "ledger": (dict(self._ledger)
                           if self._ledger is not None else None),
                # Only armed standbys carry the record — every other
                # migration's snapshot keeps the reference's shape.
                **({"standby": dict(self._standby)}
                   if self._standby is not None else {}),
                # Only slice legs carry the ordinal — single-host
                # snapshots stay byte-identical.
                **({"ord": self.ordinal}
                   if self.ordinal is not None else {}),
                # Only RestoreSet clone legs carry the clone ordinal.
                **({"clone": self.clone}
                   if self.clone is not None else {}),
                "startedAt": round(self._started_wall, 3),
                "advancedAt": round(self._advanced_wall, 3),
                "updatedAt": round(time.time(), 3),
            }

    # -- publications ----------------------------------------------------------

    def export_gauges(self) -> None:
        snap = self.snapshot()
        PROGRESS_BYTES_SHIPPED.set(snap["bytesShipped"], role=self.role)
        PROGRESS_TOTAL_BYTES.set(snap["totalBytes"], role=self.role)
        PROGRESS_RATE_BPS.set(snap["rateBps"], role=self.role)
        PROGRESS_ETA_SECONDS.set(
            snap["etaSeconds"] if snap["etaSeconds"] is not None else -1.0,
            role=self.role)

    def publish(self, min_interval_s: float = 0.0) -> bool:
        """Atomically replace the node-local snapshot file (the
        ``gritscope watch`` feed). Throttled by ``min_interval_s`` so
        callers on hot paths cannot turn it into per-chunk fsync
        traffic. Never raises — observability must not take down the
        data path."""
        if self._dir is None:
            return False
        now = time.monotonic()
        with self._lock:
            if min_interval_s and now - self._last_publish < min_interval_s:
                return False
            self._last_publish = now
        path = os.path.join(self._dir, PROGRESS_FILE)
        # Per-thread tmp: the sampler thread and driver publish() calls
        # can run concurrently in one process — a shared per-pid tmp would let two writers
        # interleave JSON and atomically install the torn result.
        tmp = f"{path}.tmp-{os.getpid()}-{threading.get_ident()}"
        try:
            os.makedirs(self._dir, exist_ok=True)
            with open(tmp, "w") as f:
                json.dump(self.snapshot(), f)
            os.replace(tmp, path)
            return True
        except OSError as exc:
            log.warning("progress snapshot %s unwritable: %s", path, exc)
            try:
                os.unlink(tmp)
            except OSError:
                pass
            return False


# -- process-global registry (one tracker per role) ---------------------------

_lock = threading.Lock()
_trackers: dict[str, ProgressTracker] = {}


def configure(uid: str, role: str,
              publish_dir: str | None = None,
              ordinal: int | None = None,
              clone: int | None = None) -> ProgressTracker:
    """Install a fresh tracker for ``role`` (a new migration leg starts
    from zero — the previous leg's counters must not leak into its
    rate window)."""
    tracker = ProgressTracker(uid, role, publish_dir=publish_dir,
                              ordinal=ordinal, clone=clone)
    with _lock:
        _trackers[role] = tracker
    return tracker


def uid_from_dir(dir_path: str) -> str:
    """The migration uid both ends derive independently: the checkpoint
    name is the work/stage dir basename (same convention as the flight
    recorder)."""
    return os.path.basename(os.path.normpath(dir_path)) or "migration"


def adopt(uid: str, role: str,
          publish_dir: str | None = None,
          ordinal: int | None = None,
          clone: int | None = None) -> ProgressTracker:
    """Keep the live tracker when it already belongs to this migration
    (a driver continuing a leg another driver started — run_checkpoint
    after a split-phase run_precopy_phase must not zero the counters);
    configure fresh otherwise."""
    with _lock:
        tracker = _trackers.get(role)
        if tracker is not None and tracker.uid == uid:
            if publish_dir and tracker._dir is None:
                tracker._dir = publish_dir
            if ordinal is not None and tracker.ordinal is None:
                tracker.ordinal = ordinal
            if clone is not None and tracker.clone is None:
                tracker.clone = clone
            return tracker
    return configure(uid, role, publish_dir=publish_dir, ordinal=ordinal,
                     clone=clone)


def ensure(role: str, uid: str = "",
           publish_dir: str | None = None) -> ProgressTracker:
    """The tracker for ``role``, creating one on first use (the
    workload's place loop has no driver that calls configure). A
    DIFFERENT non-empty uid replaces the tracker: a second migration in
    the same process must not inherit the first one's counters."""
    with _lock:
        tracker = _trackers.get(role)
        if tracker is None or (uid and tracker.uid != uid):
            tracker = ProgressTracker(uid, role, publish_dir=publish_dir)
            _trackers[role] = tracker
        return tracker


def get(role: str) -> ProgressTracker | None:
    with _lock:
        return _trackers.get(role)


def trackers() -> list[ProgressTracker]:
    with _lock:
        return list(_trackers.values())


def reset() -> None:
    """Forget every tracker (tests)."""
    with _lock:
        _trackers.clear()


def add_bytes(role: str, n: int, stream: str | None = None) -> None:
    """Feeder funnel: count ``n`` shipped bytes on ``role``'s tracker —
    one dict hit + int add when configured, a no-op when not."""
    tracker = get(role)
    if tracker is not None:
        tracker.add_bytes(n, stream=stream)


def sample() -> None:
    """One sampler tick: refresh the progress gauges and the node-local
    snapshot files for every live tracker."""
    for tracker in trackers():
        tracker.export_gauges()
        tracker.publish(min_interval_s=0.5)


def read_progress_file(path: str) -> dict[str, Any] | None:
    """Parse one ``.grit-progress.json`` snapshot; None on a torn or
    missing file (the writer replaces it atomically, but a reader can
    still race a crashed writer's leftover tmp)."""
    try:
        with open(path, encoding="utf-8", errors="replace") as f:
            rec = json.load(f)
        return rec if isinstance(rec, dict) else None
    except (OSError, ValueError):
        return None
