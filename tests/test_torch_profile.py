"""The port's phase profiler (``grit_tpu_torch.obs.profile``) held to the
reference's (``grit_tpu.obs.profile``): the same categories, profiled
phases and arm/disarm tables; ``classify_sample`` giving the reference's
category on the same synthetic frames and ``/proc`` readings (and
``native`` on the port's own ctypes funnels, as the reference on its);
twins of ``tests/test_profile.py``'s live classification, cardinality
cap, flight arming, ledger, log-filter and on-demand cases; and the port's
folded files read by ``tools/gritscope``'s profile report."""

from __future__ import annotations

import json
import logging
import os
import queue
import sys
import threading
import time
import zlib
from collections import Counter

import numpy as np
import pytest
import torch

from grit_tpu.obs import flight as ref_flight
from grit_tpu.obs import profile as ref_profile
from grit_tpu_torch.obs import flight, profile, progress
from tools.gritscope.profilecmd import (
    build_profile_report,
    load_profiles,
    read_folded,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _prof_env(monkeypatch):
    monkeypatch.setenv("GRIT_FLIGHT", "1")
    for knob in ("GRIT_FLIGHT_DIR", "GRIT_PROF_HZ", "GRIT_PROF_MAX_STACKS"):
        monkeypatch.delenv(knob, raising=False)
    flight.reset()
    profile.reset()
    yield
    flight.reset()
    profile.reset()


def _folded_path(d: str, phase: str) -> str:
    return os.path.join(d, profile.prof_file_name(phase))


def test_tables_are_the_reference():
    assert profile.CATEGORIES == ref_profile.CATEGORIES
    assert profile.PROFILED_PHASES == ref_profile.PROFILED_PHASES
    assert profile._ARM_EVENTS == ref_profile._ARM_EVENTS
    assert profile._DISARM_EVENTS == ref_profile._DISARM_EVENTS
    assert profile._DISARM_EVENTS["wire.recv.fail"] == "wire_recv"
    assert profile.OVERFLOW_STACK == ref_profile.OVERFLOW_STACK
    assert profile.prof_file_name("dump") == ref_profile.prof_file_name("dump")
    for ev in profile._ARM_EVENTS.keys() | profile._DISARM_EVENTS.keys():
        assert ev in flight.EVENTS


# -- classify_sample against the reference -----------------------------------------


def _frame_in(filename: str, func: str = "leaf"):
    """A live frame whose code sits in ``filename`` (any path: the
    classifier reads only ``co_filename`` and ``co_name``)."""
    ns: dict = {"sys": sys}
    exec(compile(f"def {func}():\n    return sys._getframe()\n", filename,
                 "exec"), ns)
    return ns[func]()


HERE = os.path.abspath(__file__)
# (state, cpu_rate, frozen, wchan, top file, top function): the
# reference's TestClassifySample cases and the order rules' edges.
SAMPLES = {
    "cpu-moving-python": ("R", 3, False, "", HERE, "leaf"),
    "cpu-frozen-native": ("R", 3, True, "", HERE, "leaf"),
    "runnable-no-baseline-frozen": ("R", None, True, "", HERE, "leaf"),
    "runnable-no-baseline-moving": ("R", None, False, "", HERE, "leaf"),
    "dstate-syscall": ("D", 0, True, "", HERE, "leaf"),
    "futex-lock": ("S", 0, True, "futex_wait_queue", HERE, "leaf"),
    "nanosleep-idle": ("S", 0, True, "hrtimer_nanosleep", HERE, "leaf"),
    "sock-syscall": ("S", 0, True, "sock_wait_data", HERE, "leaf"),
    "no-proc-unknown": ("", None, True, "", HERE, "leaf"),
    "moving-beats-stale-kernel": ("S", None, False, "", HERE, "leaf"),
    "timer-sleep-beats-billed-cpu": ("S", 0.5, False, "do_nanosleep", HERE,
                                     "leaf"),
    "poll-outside-io-is-idle": ("S", 0, True, "poll_schedule_timeout", HERE,
                                "leaf"),
    "poll-in-socket-is-syscall": ("S", 0, True, "poll_schedule_timeout",
                                  "/usr/lib/python3/socket.py", "recv_into"),
    "threading-top-is-lock": ("S", 0, True, "", "/lib/threading.py", "wait"),
    "queue-top-is-lock": ("S", None, True, "", "/lib/queue.py", "get"),
    "selectors-top-is-syscall": ("S", 0, True, "", "/lib/selectors.py",
                                 "select"),
    "frozen-sleeper-is-idle": ("S", 0, True, "", HERE, "leaf"),
    "native-func-name": ("R", 3, False, "", HERE, "compress"),
    "below-cpu-floor-moving": ("S", 0.1, False, "", HERE, "leaf"),
    "pipe-wait-syscall": ("S", 0, True, "pipe_read", HERE, "leaf"),
}


@pytest.mark.parametrize("case", sorted(SAMPLES))
def test_classify_sample_is_the_reference(case):
    state, cpu_rate, frozen, wchan, filename, func = SAMPLES[case]
    frame = _frame_in(filename, func)
    got = profile.classify_sample(frame, state, cpu_rate, frozen, wchan)
    want = ref_profile.classify_sample(frame, state, cpu_rate, frozen, wchan)
    assert got == want and got in profile.CATEGORIES


@pytest.mark.parametrize("k", range(2))
def test_the_port_ctypes_funnels_read_native(k):
    """A moving frame burning CPU in one of the port's ctypes funnels is
    native, as the reference's in its own (``_NATIVE_FFI_FILES``)."""
    port_file = os.path.join(REPO, profile._NATIVE_FFI_FILES[k])
    ref_file = os.path.join(REPO, ref_profile._NATIVE_FFI_FILES[k])
    assert os.path.isfile(port_file)
    got = profile.classify_sample(_frame_in(port_file, "crc32c"), "R", 3,
                                  False, "")
    want = ref_profile.classify_sample(_frame_in(ref_file, "crc32c"), "R", 3,
                                       False, "")
    assert got == want == "native"
    # ... and the same frame is python to the reference, which does not
    # know the port's files.
    assert ref_profile.classify_sample(_frame_in(port_file, "crc32c"), "R",
                                       3, False, "") == "python"


def test_the_ctypes_funnels_are_the_port_s_call_sites():
    """Each named file calls a ctypes entry point: the crc32c library's,
    and the kernel wrappers' launch through ``build.kernel``."""
    with open(os.path.join(REPO, "grit_tpu_torch/checksum.py")) as f:
        assert "library().grit_crc32c(" in f.read()
    with open(os.path.join(REPO, "grit_tpu_torch/ops/flash_attention.py")) as f:
        assert "build.kernel(" in f.read()


# -- live classification (twin of TestClassificationLive) --------------------------


def test_busy_sleeping_native_lock_threads(tmp_path):
    stop = threading.Event()

    def _busy():
        x = 0
        while not stop.is_set():
            x += sum(i for i in range(200))

    def _asleep():
        while not stop.is_set():
            time.sleep(0.05)

    buf = os.urandom(16 << 20)

    def _native_ext():
        while not stop.is_set():
            zlib.compress(buf, 6)

    q: queue.Queue = queue.Queue()

    def _lockwait():
        while not stop.is_set():
            try:
                q.get(timeout=0.5)
            except queue.Empty:
                pass

    threads = [threading.Thread(target=f, daemon=True)
               for f in (_busy, _asleep, _native_ext, _lockwait)]
    for t in threads:
        t.start()
    time.sleep(0.2)
    d = str(tmp_path / "ck")
    flight.configure(d, "source")
    flight.emit("dump.start")
    prof = profile.default_profiler()
    deadline = time.monotonic() + 20.0
    while time.monotonic() < deadline:
        prof.sample_once()
        agg = prof._armed.get("dump")
        if agg is not None and agg.ticks >= 60:
            break
        time.sleep(0.03)
    flight.emit("dump.end")
    stop.set()
    for t in threads:
        t.join()
    rec = read_folded(_folded_path(d, "dump"))
    assert rec is not None and rec["meta"]["ticks"] >= 60
    per_fn: dict[str, Counter] = {}
    for cat, stack, n in rec["stacks"]:
        for fn in ("_busy", "_asleep", "_native_ext", "_lockwait"):
            if fn in stack:
                per_fn.setdefault(fn, Counter())[cat] += n
    want = {"_busy": "python", "_asleep": "idle",
            "_native_ext": "native", "_lockwait": "lock"}
    for fn, expected in want.items():
        assert fn in per_fn, (fn, rec["stacks"][:5])
        assert per_fn[fn].most_common(1)[0][0] == expected, \
            (fn, dict(per_fn[fn]))


# -- the cardinality cap (twins of TestCardinalityCap) -----------------------------


@pytest.mark.parametrize("mod", [profile, ref_profile],
                         ids=["port", "ref"])
def test_overflow_bucket(mod):
    agg = mod.PhaseAgg("p", None, "u", "r", 50.0, max_stacks=4)
    for i in range(10):
        agg.add("python", f"f{i} (mod.py:{i})")
    assert len(agg.counts) == 5 and agg.overflow == 6 and agg.samples() == 10
    assert agg.counts[("python", mod.OVERFLOW_STACK)] == 6
    meta = json.loads(agg.folded().splitlines()[0][len("# grit-prof "):])
    assert meta["overflow"] == 6


def _agg_ops(mod) -> str:
    a = mod.PhaseAgg("p", "/d", "u", "r", 25.0, max_stacks=2)
    b = mod.PhaseAgg("p", "/d", "u", "r", 25.0, max_stacks=2)
    for i in range(4):
        b.add("python", f"g{i} (m.py:{i})")
    a.add("native", "base (m.py:1)")
    a.ticks, b.ticks = 3, 4
    a.merge(b)
    snap = a.snapshot()
    a.add("idle", "later (m.py:9)")
    return snap.folded()


def test_merge_snapshot_and_folded_text_are_the_reference():
    got, want = _agg_ops(profile), _agg_ops(ref_profile)
    assert got == want
    meta = json.loads(got.splitlines()[0][len("# grit-prof "):])
    assert meta["overflow"] == 3 and meta["samples"] == 5


def test_cap_knob_respected(monkeypatch):
    monkeypatch.setenv("GRIT_PROF_MAX_STACKS", "2")
    monkeypatch.setenv("GRIT_PROF_HZ", "7.5")
    prof = profile.PhaseProfiler()
    assert (prof.max_stacks(), prof.hz()) == (2, 7.5)
    assert (prof.max_stacks(), prof.hz()) == \
        (ref_profile.PhaseProfiler().max_stacks(),
         ref_profile.PhaseProfiler().hz())


# -- arming on flight brackets (twins of TestFlightArming) -------------------------


def _wait_ticks(phase: str, n: int = 1) -> None:
    deadline = time.monotonic() + 10.0
    while time.monotonic() < deadline:
        agg = profile.default_profiler()._armed.get(phase)
        if agg is not None and agg.ticks >= n:
            return
        time.sleep(0.02)


def test_bracket_produces_folded_artifact(tmp_path):
    d = str(tmp_path / "ck")
    flight.configure(d, "source")
    flight.emit("wire.send.start")
    _wait_ticks("wire_send")
    flight.emit("wire.send.end", bytes=123)
    rec = read_folded(_folded_path(d, "wire_send"))
    assert (rec["meta"]["phase"], rec["meta"]["uid"], rec["meta"]["role"]) \
        == ("wire_send", "ck", "source")
    assert rec["meta"]["ticks"] >= 1 and rec["meta"]["seconds"] > 0
    assert all(cat in profile.CATEGORIES for cat, _s, _n in rec["stacks"])


def test_hz_zero_disables(tmp_path, monkeypatch):
    monkeypatch.setenv("GRIT_PROF_HZ", "0")
    d = str(tmp_path / "ck")
    flight.configure(d, "source")
    flight.emit("dump.start")
    time.sleep(0.1)
    flight.emit("dump.end")
    assert not os.path.exists(_folded_path(d, "dump"))
    assert profile.default_profiler()._thread is None


def test_rearm_accumulates_same_file(tmp_path):
    d = str(tmp_path / "ck")
    flight.configure(d, "source")
    for rnd in range(2):
        flight.emit("precopy.round.start", round=rnd)
        _wait_ticks("precopy_round")
        flight.emit("precopy.round.end", round=rnd)
    rec = read_folded(_folded_path(d, "precopy_round"))
    assert rec["meta"]["ticks"] >= 2


def test_artifact_dir_tee(tmp_path, monkeypatch):
    tee = tmp_path / "artifacts"
    monkeypatch.setenv("GRIT_FLIGHT_DIR", str(tee))
    d = str(tmp_path / "ck")
    flight.configure(d, "source")
    flight.emit("dump.start")
    flight.emit("dump.end")
    assert [p for p in os.listdir(tee)
            if p.startswith("prof-") and p.endswith("-dump.folded")]


def test_wire_recv_fail_closes_the_window(tmp_path):
    d = str(tmp_path / "ck")
    flight.configure(d, "destination")
    flight.emit("wire.recv.open")
    assert profile.default_profiler().armed_phases() == ["wire_recv"]
    flight.emit("wire.recv.fail", error="boom")
    assert profile.default_profiler().armed_phases() == []
    assert os.path.isfile(_folded_path(d, "wire_recv"))


def test_profiler_artifacts_never_ship_with_tree(tmp_path):
    """The reference agent's tree walk leaves the port's folded files out,
    as it does its own."""
    from grit_tpu.agent.copy import _iter_files

    d = str(tmp_path / "ck")
    flight.configure(d, "source")
    flight.emit("dump.start")
    flight.emit("dump.end")
    with open(os.path.join(d, "data.bin"), "w") as f:
        f.write("payload")
    assert os.path.isfile(_folded_path(d, "dump"))
    assert {rel for _p, rel in _iter_files(d)} == {"data.bin"}


# -- the resource ledger (twins of TestLedger) -------------------------------------


def test_ledger_delta_math_is_the_reference():
    readings = [({"cpu_user_s": 10.0, "cpu_sys_s": 2.0, "io_read": 1000,
                  "io_write": 0}, 100.0),
                ({"cpu_user_s": 11.0, "cpu_sys_s": 2.5, "io_read": 3000,
                  "io_write": 500}, 102.0),
                ({"cpu_user_s": 4.0, "cpu_sys_s": 2.5}, 103.0)]
    port, ref = profile.LedgerState(), ref_profile.LedgerState()
    got = [port.update(r, now=t) for r, t in readings]
    assert got == [ref.update(r, now=t) for r, t in readings]
    assert got[1]["cpuCores"] == pytest.approx(0.75)
    assert got[1]["ioReadBps"] == pytest.approx(1000.0)
    assert got[2]["cpuCores"] == 0.0  # a counter reset clamps


def test_process_resources_have_the_reference_keys():
    got, want = profile.read_process_resources(), \
        ref_profile.read_process_resources()
    assert got is not None and set(got) == set(want)


def test_sample_ledger_stamps_progress_snapshot():
    from grit_tpu_torch.obs.metrics import PROF_CPU_SECONDS, PROF_RSS_BYTES

    progress.reset()
    try:
        tracker = progress.configure("ck", progress.ROLE_WORKLOAD)
        profile.sample_ledger()
        profile.sample_ledger()
        led = tracker.snapshot()["ledger"]
        assert led is not None and "cpuCores" in led and led["rssBytes"] > 0
        assert PROF_CPU_SECONDS.value(mode="user") > 0.0
        assert PROF_RSS_BYTES.value() == led["rssBytes"]
    finally:
        progress.reset()


def test_recent_python_share_expires_after_sampling_stops():
    prof = profile.PhaseProfiler(hz=50)
    now = time.monotonic()
    with prof._lock:
        prof._recent.append((now - prof.SHARE_WINDOW_S - 5.0,
                             {"python": 10, "native": 2}))
    assert prof.recent_python_share() is None
    with prof._lock:
        prof._recent.append((now, {"python": 3, "native": 1}))
    assert prof.recent_python_share() == pytest.approx(0.75)


def test_ledger_never_advances_stall_clock():
    progress.reset()
    try:
        tracker = progress.configure("ck", progress.ROLE_SOURCE)
        before = tracker.snapshot()["advancedAt"]
        time.sleep(0.05)
        profile.sample_ledger()
        assert tracker.snapshot()["advancedAt"] == before
    finally:
        progress.reset()


# -- MigrationLogFilter (twins of TestLogCorrelation's filter cases) ---------------


def _record() -> logging.LogRecord:
    return logging.LogRecord("x", logging.INFO, "f.py", 1, "m", (), None)


def test_filter_stamps_uid_and_role(tmp_path):
    from grit_tpu_torch.obs.logctx import MigrationLogFilter

    flight.configure(str(tmp_path / "ck"), "source")
    record = _record()
    assert MigrationLogFilter().filter(record)
    assert (record.grit_uid, record.grit_role) == ("ck", "source")


def test_filter_context_via_emit_near(tmp_path):
    """A workload or restored process never configures a recorder: it
    joins the migration through ``emit_near``'s walk-up, and the filter
    stamps exactly that context."""
    from grit_tpu_torch.obs.logctx import MigrationLogFilter

    root = str(tmp_path / "ck")
    ref_flight.configure(root, "source")  # the agent's log
    ref_flight.reset()
    nested = os.path.join(root, "main-work", "hbm")
    os.makedirs(nested)
    flight.emit_near(nested, "restart.start")
    record = _record()
    assert MigrationLogFilter().filter(record)
    assert (record.grit_uid, record.grit_role) == ("ck", "device")


def test_filter_without_context_stamps_empty_strings():
    from grit_tpu_torch.obs.logctx import MigrationLogFilter

    record = _record()
    assert MigrationLogFilter().filter(record)
    assert (record.grit_uid, record.grit_role) == ("", "")


def test_filter_and_formatter_leave_idle_lines_clean():
    import io

    from grit_tpu_torch.obs import logctx

    stream = io.StringIO()
    handler = logging.StreamHandler(stream)
    handler.setFormatter(logctx.CorrelationFormatter())
    handler.addFilter(logctx.MigrationLogFilter())
    logger = logging.getLogger("grit_tpu_torch.test.clean")
    logger.addHandler(handler)
    try:
        logger.warning("idle process line")
        assert "uid=" not in stream.getvalue()
    finally:
        logger.removeHandler(handler)


# -- gritscope reads the port's folded files -----------------------------------------

STATE = {"w": np.arange(64 * 1024, dtype=np.float32).reshape(64, 1024),
         "step": np.array(3, np.int32)}


def test_gritscope_profile_report_of_a_port_migration(tmp_path, monkeypatch):
    """A port dump and restore under the agent's flight log leave the
    dump's and the place's folded files from this process; gritscope's
    profile report reads them whole, beside the flight log."""
    from grit_tpu_torch.device.snapshot import restore_snapshot, write_snapshot
    from tools.gritscope import group_migrations, load_events

    root = str(tmp_path / "mig")
    ref_flight.configure(root, "node")
    ref_flight.reset()
    prof = profile.default_profiler()
    real_arm = prof.arm

    def arm_and_tick(*a, **k):
        real_arm(*a, **k)
        for _ in range(3):  # samples inside a millisecond-scale bracket
            prof.sample_once()

    monkeypatch.setattr(prof, "arm", arm_and_tick)
    state = {k: torch.from_numpy(v.copy()) for k, v in STATE.items()}
    d = write_snapshot(os.path.join(root, "main", "hbm"), state)
    restore_snapshot(d, like={k: torch.zeros_like(v) for k, v in state.items()})
    for phase in ("dump", "place"):
        rec = read_folded(_folded_path(root, phase))
        assert rec["meta"]["phase"] == phase and rec["meta"]["ticks"] >= 3
        assert rec["meta"]["role"] == "device" and rec["meta"]["uid"] == "mig"
    events = group_migrations(load_events([root]))["mig"]
    report = build_profile_report(events, load_profiles([root], uid="mig"),
                                  uid="mig")
    assert {"dump", "place"} <= set(report["phases"])
    assert report["classification_coverage"] >= 0.8


def test_folded_header_is_what_gritscope_reads(tmp_path):
    agg = profile.PhaseAgg("place", str(tmp_path), "ck", "device", 25.0, 16)
    agg.add("native", "place (snapshot.py:1);copy_ (snapshot.py:2)", 4)
    agg.add("python", "place (snapshot.py:1)", 6)
    agg.ticks, agg.seconds = 5, 0.2
    profile.PhaseProfiler()._write(agg)
    rec = read_folded(_folded_path(str(tmp_path), "place"))
    assert rec["meta"] == agg.header()
    assert sorted(rec["stacks"]) == sorted(
        (c, s, n) for (c, s), n in agg.counts.items())


# -- on-demand profile (twin of TestOnDemandProfile) -------------------------------


def test_sample_profile_excludes_caller_and_caps():
    out = profile.sample_profile(seconds=0.2, hz=100.0)
    assert out.startswith("# wall-clock samples:")
    assert "sample_profile" not in out
