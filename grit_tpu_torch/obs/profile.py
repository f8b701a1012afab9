"""Phase-scoped sampling profiler and the per-process resource ledger.

Counterpart of ``grit_tpu/obs/profile.py``: the flight recorder says how
long each phase took; this says where the host's time went inside it.

- **PhaseProfiler**: armed by the flight recorder's phase brackets (every
  ``*.start``/``*.end`` pair :data:`PROFILED_PHASES` names; ``emit`` and
  ``emit_on`` call :func:`on_flight_event`). While a bracket is open, a
  thread walks ``sys._current_frames()`` at ``GRIT_PROF_HZ`` and
  classifies each thread's sample as on-CPU **python**, **native** (a
  GIL-released C call: zlib, the crc32c library, a kernel launch; the
  Python frame is frozen while CPU burns), **syscall** wait, **lock** wait
  (futex, GIL contention included), **idle**, or **unknown**, from frame
  inspection and the thread's ``/proc/self/task/<tid>/stat`` and
  ``wchan``. When the bracket closes, the phase's collapsed stacks land
  next to the flight log as ``.grit-prof-<phase>-p<pid>.folded``
  (flamegraph.pl and speedscope read it; the category is the first
  segment of every stack; ``tools/gritscope profile`` reports it), teed
  into ``GRIT_FLIGHT_DIR``.
- **The resource ledger**, on the observability sampler's cadence
  (:mod:`grit_tpu_torch.obs.sampler`): process CPU seconds,
  ``/proc/self/io`` bytes, RSS, context switches and the codec pool's
  saturation, as the ``grit_prof_*`` gauges, and stamped as windowed
  rates into every live progress tracker's snapshot.
- **:func:`sample_profile`**: the ``/debug/pprof/profile`` endpoint,
  through the same sampling and classification, with the unique-stack
  cap (``GRIT_PROF_MAX_STACKS`` and one ``[overflow]`` bucket) and the
  handler's own thread left out.

It arms only on flight events, so with no flight log it costs two dict
misses an event and nothing samples; ``GRIT_PROF_HZ=0`` turns sampling
off under a flight log too. The names, the file format and the
categories are the reference's, so gritscope reads the port's files as
it reads the reference's. Where the port differs: its ctypes funnels
(:data:`_NATIVE_FFI_FILES`) are its own.
"""

from __future__ import annotations

import json
import logging
import os
import sys
import threading
import time
from collections import deque
from types import FrameType
from typing import TYPE_CHECKING, Any

from grit_tpu_torch.api import config
from grit_tpu_torch.metadata import PROF_FILE_PREFIX
from grit_tpu_torch.obs.metrics import (
    PROF_CODEC_POOL_SATURATION,
    PROF_CPU_SECONDS,
    PROF_CTX_SWITCHES,
    PROF_IO_BYTES,
    PROF_RSS_BYTES,
    PROF_SAMPLE_TICKS,
    PROF_TICK_SECONDS,
)

if TYPE_CHECKING:
    from grit_tpu_torch.obs.flight import Recorder

log = logging.getLogger(__name__)

#: Closed classification vocabulary (the bounded label set of
#: ``grit_prof_sample_ticks_total`` and the folded-header categories).
CATEGORIES = ("python", "native", "syscall", "lock", "idle", "unknown")

#: The cap's overflow bucket: stacks beyond ``GRIT_PROF_MAX_STACKS``
#: fold here instead of growing the table.
OVERFLOW_STACK = "[overflow]"

MAX_SECONDS = 30.0  # debug-endpoint ceiling (unchanged contract)

#: Flight phase brackets that arm/disarm the profiler, keyed by the
#: gritscope phase name the folded file is labeled with. Event names are
#: literals from ``grit_tpu_torch.obs.flight.EVENTS`` (this table is a
#: *consumer* of the registry, like gritscope's phase model).
PROFILED_PHASES = {
    "quiesce": ("quiesce.start", "quiesce.end"),
    "dump": ("dump.start", "dump.end"),
    "precopy_round": ("precopy.round.start", "precopy.round.end"),
    "criu_dump": ("criu.dump.start", "criu.dump.end"),
    "upload": ("upload.start", "upload.end"),
    "wire_send": ("wire.send.start", "wire.send.end"),
    "wire_commit": ("wire.commit.start", "wire.commit.end"),
    "wire_recv": ("wire.recv.open", "wire.recv.commit"),
    "stage": ("stage.start", "stage.end"),
    "criu_restore": ("criu.restore.start", "criu.restore.end"),
    "place": ("place.start", "place.end"),
    "postcopy_tail": ("postcopy.tail.start", "postcopy.tail.end"),
    "resume": ("resume.start", "resume.end"),
}

_ARM_EVENTS = {start: phase
               for phase, (start, _end) in PROFILED_PHASES.items()}
_DISARM_EVENTS = {end: phase
                  for phase, (_start, end) in PROFILED_PHASES.items()}
# The receive window also closes on failure — a poisoned wire session's
# profile is exactly the one worth reading.
_DISARM_EVENTS["wire.recv.fail"] = "wire_recv"


# -- sample classification ----------------------------------------------------

# Stdlib files whose presence at the TOP of a sampled stack identifies
# the wait class even without /proc (Event.wait/Condition.wait/Queue.get
# have pure-Python frames; socket/selectors wrap their blocking
# builtins in Python helpers).
_LOCK_FILES = ("threading.py", "queue.py")
_SYSCALL_FILES = ("socket.py", "socketserver.py", "selectors.py",
                  "ssl.py", "subprocess.py")
# Call sites that are thin wrappers around GIL-releasing C work: a top
# frame from one of these burning CPU is native compute even on the
# first sample (before the frozen-frame signal exists).
_NATIVE_FUNCS = frozenset({
    "compress", "decompress", "flush", "crc32", "digest", "hexdigest",
})
# The port's ctypes funnels: a thread whose TOP frame sits in one of
# these modules while CPU burns is EXECUTING the C call behind it
# (ctypes releases the GIL, and a C callable pushes no Python frame, so
# the wrapper stays the sampled leaf): the crc32c library's calls
# (``checksum.crc32c``) and the flash kernels' launches
# (``ops/flash_attention.py``'s call of ``build.kernel``'s entry point).
# The frozen-frame signal alone misses them: each call is a NEW wrapper
# frame, so a loop over long GIL-released calls reads as "moving frames
# = python" without this hint.
_NATIVE_FFI_FILES = ("grit_tpu_torch/checksum.py",
                     "grit_tpu_torch/ops/flash_attention.py")


# (id(code), f_lasti) -> rendered frame label. f_lineno decoding and
# string formatting are the sampler's per-tick hot cost (GIL-held,
# stolen from the data path being measured); a frame at the same
# instruction offset renders identically, and most sampled frames are
# parents frozen at a call site. Bounded; cleared on overflow.
_label_cache: dict[tuple[int, int], str] = {}


def _frame_label(f: FrameType) -> str:
    key = (id(f.f_code), f.f_lasti)
    label = _label_cache.get(key)
    if label is None:
        code = f.f_code
        label = (f"{code.co_name} "
                 f"({code.co_filename.rsplit('/', 1)[-1]}:{f.f_lineno})")
        if len(_label_cache) >= 8192:
            _label_cache.clear()
        _label_cache[key] = label
    return label


def _format_stack(frame: FrameType) -> str:
    parts: list[str] = []
    f: FrameType | None = frame
    while f is not None:
        parts.append(_frame_label(f))
        f = f.f_back
    return ";".join(reversed(parts))


def _read_small(path: str) -> bytes | None:
    """One-shot os.open/os.read/os.close of a small proc file: every
    syscall return re-acquires the GIL (a full scheduler round trip
    behind busy threads), so the read path is three syscalls, not
    open()'s buffered-IO half dozen."""
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:
        return None
    try:
        return os.read(fd, 1024)
    except OSError:
        return None
    finally:
        os.close(fd)


def _task_stat(tid: int) -> tuple[str, int] | None:
    """(state, utime+stime clock ticks) for one OS thread, or None when
    /proc is unreadable (non-Linux, masked sandbox, exited thread)."""
    data = _read_small(f"/proc/self/task/{tid}/stat")
    if data is None:
        return None
    try:
        # comm (field 2) may contain spaces/parens: split after the
        # LAST ')' — state is field 3, utime/stime fields 14/15.
        rest = data.rsplit(b")", 1)[1].split()
        return rest[0].decode("ascii", "replace"), \
            int(rest[11]) + int(rest[12])
    except (IndexError, ValueError):
        return None


def _task_wchan(tid: int) -> str:
    """The kernel function the thread is blocked in ("" / "0" when
    running or when the kernel masks wchan)."""
    data = _read_small(f"/proc/self/task/{tid}/wchan")
    if data is None:
        return ""
    return data.decode("ascii", "replace").strip()


#: CPU-rate floor (fraction of a core over the sweep window) above
#: which a thread counts as on-CPU. Tick-based kernels bill a whole
#: jiffy to whichever thread the accounting tick catches, and timer-
#: sleep EXPIRIES are correlated with those ticks — a 20 Hz sleeper
#: measures up to ~0.25 cores of phantom CPU. Real compute measures
#: 0.4+ even on a saturated 2-core host, so the floor sits between.
#: Genuinely-computing-but-starved threads below it still classify
#: python via the moving-frame fallback; only a starved *frozen-frame*
#: native worker can undercount, and it is mostly waiting then anyway.
ON_CPU_RATE = 0.3


def classify_sample(frame: FrameType, state: str,
                    cpu_rate: float | None,
                    frozen: bool, wchan: str) -> str:
    """One thread sample -> a :data:`CATEGORIES` member. ``cpu_rate``
    is the thread's CPU seconds per wall second over the last sweep
    window (None before a baseline exists).

    Order is load-bearing: CPU-burn evidence first (a busy Python
    thread's instantaneous wchan is often futex — it is waiting for the
    GIL *we* hold while sampling — and must not read as lock-wait),
    then kernel truth (state/wchan), then frame hints, then idle.
    """
    top = frame.f_code
    top_file = top.co_filename.rsplit("/", 1)[-1]
    if state == "S" and wchan and ("nanosleep" in wchan
                                   or "hrtimer" in wchan):
        # Asleep on a timer, by choice. Outranks the billed CPU rate:
        # tick-based kernels bill a whole jiffy to whichever thread the
        # accounting tick catches, and sleep EXPIRIES are correlated
        # with those ticks — a 20 Hz sleeper can read 0.2 cores of
        # phantom CPU. A timer sleep is never a GIL wait (those are
        # futex), so this cannot eat real compute samples.
        return "idle"
    # R-state alone only counts before a rate baseline exists: on a
    # contended host every starved thread is runnable-waiting much of
    # the time — the measured rate, once available, is the truth.
    on_cpu = (cpu_rate > ON_CPU_RATE) if cpu_rate is not None \
        else state == "R"
    if on_cpu:
        # Burning CPU (or runnable right now). A frozen Python frame
        # (identical frame/instruction across ticks) while CPU burns
        # means the GIL is released — a C extension is doing the work.
        if frozen or top.co_name in _NATIVE_FUNCS \
                or top.co_filename.endswith(_NATIVE_FFI_FILES):
            return "native"
        return "python"
    if state == "D":
        return "syscall"  # uninterruptible: disk/device wait
    if wchan and wchan != "0":
        if "futex" in wchan:
            return "lock"
        if "nanosleep" in wchan or "hrtimer" in wchan:
            return "idle"
        if any(k in wchan for k in (
                "poll", "select", "epoll", "sock", "skb", "pipe",
                "unix_stream", "io_schedule", "wait_on", "fsync",
                "sync", "flock", "lock_page", "read", "write", "accept")):
            if ("poll" in wchan or "select" in wchan) \
                    and top_file not in _SYSCALL_FILES:
                # CPython <= 3.10 implements time.sleep via select():
                # the sleeper parks in poll_schedule_timeout, kernel-
                # indistinguishable from an fd poll. A poll/select wait
                # whose sampled Python leaf is NOT an I/O module is a
                # timer sleep, not I/O.
                return "idle"
            return "syscall"
    if top_file in _LOCK_FILES:
        return "lock"
    if top_file in _SYSCALL_FILES:
        return "syscall"
    if not frozen:
        # The Python frame MOVED since the last tick: the thread
        # executed Python in between, whatever the (sticky, possibly
        # pre-baseline) kernel info says — a GIL-waiting busy thread
        # reads S-state at the sweep but is still the frame loop.
        return "python"
    if state:
        return "idle"
    return "unknown"


# -- per-phase aggregation ----------------------------------------------------


class PhaseAgg:
    """One phase bracket's sample table: (category, stack) -> count,
    with the unique-stack cardinality cap."""

    __slots__ = ("phase", "out_dir", "uid", "role", "hz", "max_stacks",
                 "counts", "cats", "ticks", "overflow", "started_mono",
                 "seconds")

    def __init__(self, phase: str, out_dir: str | None, uid: str,
                 role: str, hz: float, max_stacks: int) -> None:
        self.phase = phase
        self.out_dir = out_dir
        self.uid = uid
        self.role = role
        self.hz = hz
        self.max_stacks = max(1, int(max_stacks))
        self.counts: dict[tuple[str, str], int] = {}
        self.cats: dict[str, int] = {}
        self.ticks = 0
        self.overflow = 0
        self.started_mono = time.monotonic()
        # Wall seconds the bracket(s) actually covered, stamped at
        # disarm. Share math uses ticks (achieved rate), never the
        # nominal hz: a starved sampler under-ticks, it does not lie.
        self.seconds = 0.0

    def add(self, category: str, stack: str, n: int = 1) -> None:
        self.cats[category] = self.cats.get(category, 0) + n
        key = (category, stack)
        if key not in self.counts and len(self.counts) >= self.max_stacks:
            self.overflow += n
            key = (category, OVERFLOW_STACK)
        self.counts[key] = self.counts.get(key, 0) + n

    def snapshot(self) -> "PhaseAgg":
        """Detached copy for writing/merging. ``dict()`` of a dict is a
        single C-level copy — atomic under the GIL — so this is safe
        against a sampler thread still holding a reference to this agg
        mid-tick (a Python-level iteration over the live dicts is not:
        it raises ``dictionary changed size during iteration``)."""
        out = PhaseAgg(self.phase, self.out_dir, self.uid, self.role,
                       self.hz, self.max_stacks)
        out.counts = dict(self.counts)
        out.cats = dict(self.cats)
        out.ticks = self.ticks
        out.overflow = self.overflow
        out.started_mono = self.started_mono
        out.seconds = self.seconds
        return out

    def merge(self, other: "PhaseAgg") -> None:
        """Fold ``other`` in (a re-armed phase — pre-copy rounds —
        accumulates into one folded file per phase and dir). Pass a
        :meth:`snapshot` when ``other`` may still be receiving
        samples."""
        self.ticks += other.ticks
        self.seconds += other.seconds
        self.overflow += other.overflow
        for cat, n in other.cats.items():
            self.cats[cat] = self.cats.get(cat, 0) + n
        for (cat, stack), n in other.counts.items():
            key = (cat, stack)
            if stack != OVERFLOW_STACK and key not in self.counts \
                    and len(self.counts) >= self.max_stacks:
                # Newly lost identity in the merge — count it. The
                # incoming [overflow] buckets themselves are already in
                # other.overflow (added above); re-counting them here
                # would double-bill depending on dict order.
                key = (cat, OVERFLOW_STACK)
                self.overflow += n
            self.counts[key] = self.counts.get(key, 0) + n

    def samples(self) -> int:
        return sum(self.cats.values())

    def header(self) -> dict[str, Any]:
        return {
            "phase": self.phase,
            "uid": self.uid,
            "role": self.role,
            "hz": self.hz,
            "ticks": self.ticks,
            "seconds": round(self.seconds, 4),
            "samples": self.samples(),
            "categories": dict(sorted(self.cats.items())),
            "overflow": self.overflow,
        }

    def folded(self) -> str:
        """Collapsed-stack text: a ``# grit-prof <json>`` header line,
        then ``category;frame;frame count`` lines, hottest first."""
        lines = ["# grit-prof " + json.dumps(self.header(),
                                             sort_keys=True)]
        for (cat, stack), n in sorted(self.counts.items(),
                                      key=lambda kv: -kv[1]):
            lines.append(f"{cat};{stack} {n}")
        return "\n".join(lines) + "\n"


def prof_file_name(phase: str) -> str:
    """Per-phase, per-PROCESS artifact name. The pid suffix is load-
    bearing: the agent (device/hook.py) and the workload process
    (device/snapshot.py, via emit_near) both bracket the dump phase
    against the same governing flight-log dir, and a shared name would
    let the agent's mostly-idle enclosing bracket os.replace away the
    workload's compute samples. gritscope profile merges per phase
    across files, so N processes just mean N inputs."""
    return f"{PROF_FILE_PREFIX}{phase}-p{os.getpid()}.folded"


# The folded artifact's READER lives in tools/gritscope/profilecmd.py
# (read_folded), with the analyzer: one reader for both packages' files.


# -- the profiler -------------------------------------------------------------


class PhaseProfiler:
    """Continuous all-thread sampler, active only while at least one
    phase bracket is armed. One instance per process (see
    :func:`default_profiler`); ``sample_once`` is synchronous and
    lock-ordered so tests can drive it without the thread."""

    #: Sliding window (seconds) the ledger's live python-share derives
    #: from (matches the progress tracker's rate window).
    SHARE_WINDOW_S = 20.0

    #: Kernel-info (/proc stat+wchan) sweep cadence floor. Per-thread
    #: /proc reads are syscalls, and every syscall return must
    #: re-acquire the GIL AND a CPU — on a saturated host a single read
    #: measured >100 ms, which at per-tick granularity turned a 50 Hz
    #: profiler into a 3 Hz one. CPU-time granularity is a 10 ms jiffy
    #: anyway, so the sweep runs at most at ~10 Hz with sticky
    #: per-thread kernel info, and the per-tick cost stays one
    #: ``sys._current_frames`` call (zero syscalls).
    PROC_SWEEP_S = 0.1

    #: Overhead bound on the sweep itself: each sweep's measured wall
    #: cost pushes the next sweep out to ``cost / SWEEP_DUTY`` — a
    #: starved sweep self-decimates instead of eating the blackout
    #: window it is measuring (fidelity degrades, overhead stays <3%;
    #: together with TICK_DUTY this keeps the whole profiler under 5%
    #: overhead by construction).
    SWEEP_DUTY = 0.03

    #: Until every sampled thread has a CPU-rate baseline (two stat
    #: readings), sweeps re-run on this spacing regardless of the duty
    #: bound: a thread caught momentarily runnable at the FIRST sweep
    #: must not stay classified on-CPU for the whole adaptive gap. Long
    #: enough that 1-2 wakeup jiffies over the gap stay under
    #: :data:`ON_CPU_RATE`.
    BASELINE_SWEEP_S = 0.4

    #: Duty bound on the TICK itself (frames + classification +
    #: formatting, GIL-held — stolen from exactly the data path being
    #: measured): the loop stretches its interval so ticking costs at
    #: most this fraction of wall clock. At the default rate a cheap
    #: tick keeps the nominal cadence; a many-threaded process
    #: self-decimates instead of taxing the blackout window (share math
    #: uses achieved ticks, so fidelity degrades, truth does not).
    TICK_DUTY = 0.02

    def __init__(self, hz: float | None = None,
                 max_stacks: int | None = None) -> None:
        self._hz_override = hz
        self._max_override = max_stacks
        self._lock = threading.Lock()
        self._armed: dict[str, PhaseAgg] = {}
        self._arm_depth: dict[str, int] = {}
        # (out_dir, phase, uid) -> PhaseAgg accumulated across re-arms,
        # so a phase that brackets repeatedly (pre-copy rounds) keeps
        # ONE stable folded file with cumulative counts. uid is part of
        # the key: a later migration reusing the same work dir must not
        # merge into (or inherit the header uid of) the previous one.
        self._history: dict[tuple[str, str, str], PhaseAgg] = {}
        self._exclude: set[int] = set()
        self._thread: threading.Thread | None = None
        self._stop = threading.Event()
        # ident -> frame_marker from the previous tick (frozen-frame
        # detection: identical marker while CPU burns = GIL released)
        self._frame_state: dict[int, tuple] = {}
        # ident -> (state, cpu_rate, wchan) from the last /proc sweep
        self._kinfo: dict[int, tuple] = {}
        # ident -> (cumulative cpu ticks, reading time): the rate
        # baseline, rolled forward only when the pair spacing is wide
        # enough for jiffy-resolution rates.
        self._cpu_prev: dict[int, tuple] = {}
        self._next_sweep = 0.0
        self._last_tick_cost = 0.0
        # recent per-tick category counts for the live ledger share
        self._recent: deque[tuple[float, dict[str, int]]] = deque()

    # -- knobs (read live: tests and Jobs flip env) ---------------------------

    def hz(self) -> float:
        if self._hz_override is not None:
            return float(self._hz_override)
        return float(config.PROF_HZ.get())

    def max_stacks(self) -> int:
        if self._max_override is not None:
            return int(self._max_override)
        return int(config.PROF_MAX_STACKS.get())

    def enabled(self) -> bool:
        return self.hz() > 0

    # -- arm / disarm ---------------------------------------------------------

    def arm(self, phase: str, out_dir: str | None, uid: str = "",
            role: str = "") -> None:
        if not self.enabled():
            return
        with self._lock:
            depth = self._arm_depth.get(phase, 0)
            self._arm_depth[phase] = depth + 1
            if depth == 0:
                if not self._armed:
                    # Fresh arming epoch: the duty bound caps a LIVE
                    # loop's overhead, but one expensive final tick of
                    # the previous epoch (GIL starvation on a saturated
                    # box) otherwise carries a 50x-stretched interval
                    # into this epoch's first wait — a back-to-back
                    # in-process migration then closes every phase with
                    # zero ticks.
                    self._last_tick_cost = 0.0
                self._armed[phase] = PhaseAgg(
                    phase, out_dir, uid, role, self.hz(),
                    self.max_stacks())
            self._ensure_thread_locked()

    def disarm(self, phase: str) -> None:
        with self._lock:
            depth = self._arm_depth.get(phase, 0)
            if depth <= 0:
                return
            self._arm_depth[phase] = depth - 1
            if depth > 1:
                return
            self._arm_depth.pop(phase, None)
            agg = self._armed.pop(phase, None)
            if agg is None:
                return
            agg.seconds = time.monotonic() - agg.started_mono
            # A sampler tick in flight captured the armed list BEFORE
            # this pop and may still be adding samples: merge/write
            # from a detached snapshot, never the live object.
            snap = agg.snapshot()
            key = (agg.out_dir or "", phase, agg.uid)
            merged = self._history.get(key)
            if merged is None:
                # Bounded: evict oldest entries (insertion order), not
                # the whole table — a clear() mid-pre-copy would drop
                # the earlier rounds from the cumulative artifact.
                while len(self._history) >= 128:
                    self._history.pop(next(iter(self._history)))
                self._history[key] = snap
                merged = snap
            else:
                merged.merge(snap)
            out = merged.snapshot()
        self._write(out)

    def armed_phases(self) -> list[str]:
        with self._lock:
            return sorted(self._armed)

    def exclude_thread(self, ident: int) -> None:
        with self._lock:
            self._exclude.add(ident)

    # -- sampling -------------------------------------------------------------

    def _ensure_thread_locked(self) -> None:
        if self._thread is not None and self._thread.is_alive():
            return
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._loop, name="grit-prof-sampler", daemon=True)
        self._thread.start()

    def _loop(self) -> None:
        while True:
            hz = self.hz()
            base = 1.0 / hz if hz > 0 else 0.5
            start = time.monotonic()
            while True:
                # Waits are sliced so the duty stretch is re-read each
                # slice: a duty-stretched interval can reach tens of
                # seconds, and an unsliced wait would (a) park the
                # thread alive-but-useless long past every disarm and
                # (b) sleep straight through a fresh arming epoch's
                # duty reset — the re-armed migration would then close
                # every phase with zero ticks.
                interval = max(base,
                               self._last_tick_cost / self.TICK_DUTY)
                remaining = start + interval - time.monotonic()
                if remaining <= 0:
                    break
                if self._stop.wait(min(remaining, 0.25)):
                    return
                with self._lock:
                    if not self._armed:
                        # Last phase disarmed: the thread exits instead
                        # of idling in every process forever; the next
                        # arm starts a fresh one.
                        self._thread = None
                        return
            with self._lock:
                if not self._armed:
                    self._thread = None
                    return
            try:
                self.sample_once()
            except Exception as exc:  # noqa: BLE001 — never kill sampling
                log.warning("profiler tick failed: %s", exc)

    def stop(self) -> None:
        """Halt the sampling thread (tests / reset); armed state stays."""
        self._stop.set()
        thread = self._thread
        if thread is not None:
            thread.join(timeout=2.0)
            self._thread = None

    def _proc_sweep(self, idents: list[int]) -> None:
        """Refresh sticky kernel info (state, cpu rate, wchan) for the
        given threads. Syscall-heavy — run on the adaptive cadence, not
        per tick."""
        natives = {t.ident: getattr(t, "native_id", None)
                   for t in threading.enumerate()}
        now = time.monotonic()
        min_gap = self.BASELINE_SWEEP_S * 0.8
        try:
            jiffy = 1.0 / (os.sysconf("SC_CLK_TCK") or 100)
        except (OSError, ValueError, AttributeError):
            jiffy = 0.01
        for ident in idents:
            nid = natives.get(ident)
            stat = _task_stat(nid) if nid else None
            if stat is None:
                self._kinfo[ident] = ("", None, "")
                self._cpu_prev.pop(ident, None)
                continue
            state, cpu = stat
            prev = self._cpu_prev.get(ident)
            # CPU seconds per wall second over the baseline window: a
            # sleeper's single wakeup jiffy over a long gap must not
            # read as compute, so the RATE (not the raw delta) is what
            # classification thresholds. The baseline pair only rolls
            # forward on adequately-spaced readings (a short-gap rate
            # would let one jiffy clear the threshold); in between, the
            # previous rate is carried.
            if prev is None:
                self._cpu_prev[ident] = (cpu, now)
                cpu_rate = None
            elif now - prev[1] >= min_gap:
                cpu_rate = (cpu - prev[0]) * jiffy / (now - prev[1])
                self._cpu_prev[ident] = (cpu, now)
            else:
                cpu_rate = self._kinfo.get(ident, ("", None, ""))[1]
            # wchan only where it can change the verdict (S-state):
            # R/D threads classify without it. Read it regardless of
            # the billed rate — the sleep-wchan override in
            # classify_sample needs it exactly when phantom CPU billing
            # makes the rate lie.
            wchan = ""
            if state == "S" and nid:
                wchan = _task_wchan(nid)
            self._kinfo[ident] = (state, cpu_rate, wchan)
        for known in (self._kinfo, self._cpu_prev, self._frame_state):
            for ident in list(known):
                if ident not in natives:
                    del known[ident]

    def sample_once(self) -> dict[str, int]:
        """One tick: sample + classify every thread, credit every armed
        phase. Returns this tick's per-category sample counts."""
        t0 = time.monotonic()
        c0 = time.thread_time()
        with self._lock:
            armed = list(self._armed.values())
            exclude = set(self._exclude)
        exclude.add(threading.get_ident())
        frames = sys._current_frames()
        sampled = [i for i in frames if i not in exclude]
        unseen = [i for i in sampled if i not in self._kinfo]
        if t0 >= self._next_sweep:
            self._proc_sweep(sampled)
            cost = time.monotonic() - t0
            no_baseline = any(
                self._kinfo.get(i, ("", None, ""))[1] is None
                and i in self._cpu_prev
                for i in sampled)
            if no_baseline:
                self._next_sweep = t0 + self.BASELINE_SWEEP_S
            else:
                self._next_sweep = t0 + max(self.PROC_SWEEP_S,
                                            cost / self.SWEEP_DUTY)
        elif unseen:
            # Threads born since the last sweep (wire conn workers,
            # codec pool growth) would otherwise sample as unknown
            # until the adaptive cadence reaches them — sweep just the
            # newcomers, a bounded handful.
            self._proc_sweep(unseen)
        tick_cats: dict[str, int] = {}
        for ident in sampled:
            frame = frames[ident]
            marker = (id(frame), frame.f_lasti, id(frame.f_code))
            frozen = self._frame_state.get(ident) == marker
            self._frame_state[ident] = marker
            state, cpu_rate, wchan = self._kinfo.get(
                ident, ("", None, ""))
            category = classify_sample(
                frame, state, cpu_rate, frozen, wchan)
            stack = _format_stack(frame)
            for agg in armed:
                agg.add(category, stack)
            tick_cats[category] = tick_cats.get(category, 0) + 1
        for agg in armed:
            agg.ticks += 1
        for cat, n in tick_cats.items():
            PROF_SAMPLE_TICKS.inc(n, category=cat)
        now = time.monotonic()
        with self._lock:
            self._recent.append((now, tick_cats))
            cutoff = now - self.SHARE_WINDOW_S
            while self._recent and self._recent[0][0] < cutoff:
                self._recent.popleft()
        # The duty bound charges the tick's CPU time, not its wall
        # time: on a saturated box most of a tick's wall is the sampler
        # WAITING — for the GIL, or descheduled — which imposes no
        # overhead on the workload. Billing that starvation as cost
        # stretched the interval to seconds exactly when the workload
        # was busiest, and the phases that most needed samples closed
        # with zero ticks.
        self._last_tick_cost = time.thread_time() - c0
        PROF_TICK_SECONDS.observe(now - t0)
        return tick_cats

    def recent_python_share(self) -> float | None:
        """python / (python + native) over the recent sample window —
        "how much of this process's on-CPU time is the frame loop",
        live. None when nothing sampled on-CPU recently. The window is
        re-cut against *now* on every read: once sampling stops (last
        phase disarmed) the share must expire, not freeze at its final
        value and masquerade as live for hours."""
        cutoff = time.monotonic() - self.SHARE_WINDOW_S
        with self._lock:
            recent = [(t, c) for t, c in self._recent if t >= cutoff]
        py = sum(c.get("python", 0) for _t, c in recent)
        native = sum(c.get("native", 0) for _t, c in recent)
        if py + native == 0:
            return None
        return py / (py + native)

    # -- output ---------------------------------------------------------------

    def _write(self, agg: PhaseAgg) -> None:
        text = agg.folded()
        if agg.out_dir:
            path = os.path.join(agg.out_dir, prof_file_name(agg.phase))
            try:
                tmp = f"{path}.tmp-{os.getpid()}-{threading.get_ident()}"
                with open(tmp, "w", encoding="utf-8") as f:
                    f.write(text)
                os.replace(tmp, path)
            except OSError as exc:
                log.warning("profiler artifact %s unwritable: %s",
                            path, exc)
        tee_dir = str(config.FLIGHT_DIR.get())
        if tee_dir:
            try:
                os.makedirs(tee_dir, exist_ok=True)
                import socket  # noqa: PLC0415 — tee path only

                tee = os.path.join(
                    tee_dir, f"prof-{socket.gethostname()}-{os.getpid()}"
                             f"-{agg.phase}.folded")
                with open(tee, "w", encoding="utf-8") as f:
                    f.write(text)
            except OSError:
                pass


_lock = threading.Lock()
_profiler: PhaseProfiler | None = None


def default_profiler() -> PhaseProfiler:
    global _profiler
    with _lock:
        if _profiler is None:
            _profiler = PhaseProfiler()
        return _profiler


def reset() -> None:
    """Drop the process profiler and ledger state (tests)."""
    global _profiler
    with _lock:
        profiler, _profiler = _profiler, None
    if profiler is not None:
        profiler.stop()
    _ledger_state.reset()


def on_flight_event(rec: Recorder, event: str) -> None:
    """Flight-recorder funnel hook: arm/disarm the profiler on the phase
    brackets :data:`PROFILED_PHASES` names. Called for EVERY recorded
    event — two dict misses when the event is not a profiled boundary.
    Never raises: observability must not take down the data path."""
    try:
        phase = _ARM_EVENTS.get(event)
        if phase is not None:
            default_profiler().arm(
                phase, os.path.dirname(rec.path), uid=rec.uid,
                role=rec.role)
            return
        phase = _DISARM_EVENTS.get(event)
        if phase is not None:
            default_profiler().disarm(phase)
    except Exception as exc:  # noqa: BLE001 — hot-path guard
        log.warning("profiler flight hook failed on %s: %s", event, exc)


# -- on-demand profile (debug server) -----------------------------------------


def sample_profile(seconds: float = 5.0, hz: float = 100.0) -> str:
    """Sample all threads for ``seconds`` at ``hz``; returns collapsed
    stacks sorted by sample count (descending). The debug-server
    endpoint (``/debug/pprof/profile``) — same sampling/classification
    engine as the phase profiler, the calling (handler) thread excluded,
    unique-stack cardinality capped."""
    seconds = min(max(seconds, 0.1), MAX_SECONDS)
    prof = PhaseProfiler(hz=hz)
    prof.exclude_thread(threading.get_ident())
    agg = PhaseAgg("ondemand", None, "", "", hz,
                   prof.max_stacks())
    with prof._lock:
        prof._armed["ondemand"] = agg
        prof._arm_depth["ondemand"] = 1
    deadline = time.monotonic() + seconds
    interval = 1.0 / hz if hz > 0 else 0.01
    while time.monotonic() < deadline:
        prof.sample_once()
        time.sleep(interval)
    total = agg.samples()
    lines = [
        f"{n} {cat};{stack}"
        for (cat, stack), n in sorted(agg.counts.items(),
                                      key=lambda kv: -kv[1])
    ]
    header = (
        f"# wall-clock samples: {total} over {seconds:.1f}s at {hz:.0f} Hz "
        f"({len(agg.counts)} unique stacks, "
        f"{agg.overflow} overflowed)\n"
    )
    return header + "\n".join(lines) + ("\n" if lines else "")


# -- resource ledger ----------------------------------------------------------


def read_process_resources() -> dict[str, float] | None:
    """One cumulative reading of this process's CPU/IO/RSS/ctx-switch
    counters from /proc; None when /proc is unavailable (non-Linux)."""
    try:
        with open("/proc/self/stat", "rb") as f:
            rest = f.read().rsplit(b")", 1)[1].split()
        tick = float(os.sysconf("SC_CLK_TCK") or 100)
        out = {
            "cpu_user_s": int(rest[11]) / tick,
            "cpu_sys_s": int(rest[12]) / tick,
        }
    except (OSError, IndexError, ValueError):
        return None
    try:
        with open("/proc/self/io", "rb") as f:
            for line in f.read().splitlines():
                if line.startswith(b"read_bytes:"):
                    out["io_read"] = int(line.split()[1])
                elif line.startswith(b"write_bytes:"):
                    out["io_write"] = int(line.split()[1])
    except (OSError, IndexError, ValueError):
        pass  # /proc/self/io needs CAP_SYS_PTRACE in some sandboxes
    try:
        with open("/proc/self/status", "rb") as f:
            for line in f.read().splitlines():
                if line.startswith(b"VmRSS:"):
                    out["rss"] = int(line.split()[1]) * 1024
                elif line.startswith(b"voluntary_ctxt_switches:"):
                    out["vctx"] = int(line.split()[1])
                elif line.startswith(b"nonvoluntary_ctxt_switches:"):
                    out["ivctx"] = int(line.split()[1])
    except (OSError, IndexError, ValueError):
        pass
    return out


class LedgerState:
    """Windowed-rate derivation over consecutive cumulative readings.
    ``update`` is pure bookkeeping (two readings -> deltas/rates) so the
    delta math is unit-testable without /proc."""

    def __init__(self) -> None:
        self._prev: dict[str, float] | None = None
        self._prev_t: float = 0.0

    def reset(self) -> None:
        self._prev = None
        self._prev_t = 0.0

    def update(self, reading: dict[str, float],
               now: float) -> dict[str, float]:
        """Rates since the previous reading: ``cpuCores`` (CPU seconds
        per wall second), ``ioReadBps``/``ioWriteBps``. First call (no
        baseline) rates as 0."""
        prev, prev_t = self._prev, self._prev_t
        self._prev, self._prev_t = dict(reading), now
        dt = now - prev_t if prev is not None else 0.0
        if prev is None or dt <= 0:
            return {"cpuCores": 0.0, "ioReadBps": 0.0, "ioWriteBps": 0.0}

        def rate(key: str) -> float:
            if key not in reading or key not in prev:
                return 0.0
            return max(0.0, (reading[key] - prev[key]) / dt)

        return {
            "cpuCores": round(rate("cpu_user_s") + rate("cpu_sys_s"), 4),
            "ioReadBps": round(rate("io_read"), 1),
            "ioWriteBps": round(rate("io_write"), 1),
        }


_ledger_state = LedgerState()


def sample_ledger() -> None:
    """One observability-sampler tick of the resource ledger: refresh
    the ``grit_prof_*`` gauges from /proc + the codec pool, and stamp
    the windowed rates (plus the profiler's live python share) into
    every live progress tracker, whose snapshot carries them."""
    from grit_tpu_torch import codec  # noqa: PLC0415 — torch-free, import-light

    reading = read_process_resources()
    sat = codec.pool_saturation()
    if sat is not None:
        PROF_CODEC_POOL_SATURATION.set(sat)
    if reading is None:
        return
    PROF_CPU_SECONDS.set(reading["cpu_user_s"], mode="user")
    PROF_CPU_SECONDS.set(reading["cpu_sys_s"], mode="system")
    if "io_read" in reading:
        PROF_IO_BYTES.set(reading["io_read"], dir="read")
    if "io_write" in reading:
        PROF_IO_BYTES.set(reading["io_write"], dir="write")
    if "rss" in reading:
        PROF_RSS_BYTES.set(reading["rss"])
    if "vctx" in reading:
        PROF_CTX_SWITCHES.set(reading["vctx"], kind="voluntary")
    if "ivctx" in reading:
        PROF_CTX_SWITCHES.set(reading["ivctx"], kind="involuntary")
    ledger = _ledger_state.update(reading, time.monotonic())
    if "rss" in reading:
        ledger["rssBytes"] = reading["rss"]
    if sat is not None:
        ledger["codecSaturation"] = round(sat, 3)
    share = default_profiler().recent_python_share()
    if share is not None:
        ledger["pyShare"] = round(share, 3)
    from grit_tpu_torch.obs import progress  # noqa: PLC0415

    for tracker in progress.trackers():
        tracker.set_ledger(ledger)
