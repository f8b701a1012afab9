"""The port's flight recorder (``grit_tpu_torch.obs.flight``) held to the
reference's (``grit_tpu.obs.flight``): the same closed registry of
events, twins of the recorder's cases of ``tests/test_flight.py``, a port
dump and restore emitting the reference's sequence of events and field
keys on the same numpy state, the unchanged agent's ``run_checkpoint``
driving the port's hook and agentlet into a gritscope report, a wire
migration of a port snapshot with no orphan span, and every emit site of
the port naming a registered event."""

from __future__ import annotations

import ast
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from grit_tpu.obs import flight as ref_flight
from grit_tpu_torch.metadata import FLIGHT_LOG_FILE
from grit_tpu_torch.obs import flight
from tools.gritscope import build_report, group_migrations, load_events

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _flight_env(monkeypatch):
    monkeypatch.setenv("GRIT_FLIGHT", "1")
    monkeypatch.delenv("GRIT_FLIGHT_DIR", raising=False)
    monkeypatch.delenv("GRIT_FLIGHT_CLOCK", raising=False)
    flight.reset()
    ref_flight.reset()
    yield
    flight.reset()
    ref_flight.reset()


def test_events_are_the_reference_registry():
    from grit_tpu.metadata import FLIGHT_LOG_FILE as REF_LOG

    assert flight.EVENTS == ref_flight.EVENTS
    assert flight._NO_FSYNC == ref_flight._NO_FSYNC
    assert FLIGHT_LOG_FILE == REF_LOG


# -- the recorder (twins of tests/test_flight.py's TestRecorder) -----------------


def test_configure_emit_roundtrip(tmp_path):
    d = str(tmp_path / "ns" / "ck")
    flight.configure(d, "source")
    flight.emit("quiesce.start", workload_pid=5)
    flight.emit("quiesce.end")
    path = os.path.join(d, FLIGHT_LOG_FILE)
    events = flight.read_flight_file(path)
    assert [e["ev"] for e in events] == ["migration.configure",
                                         "quiesce.start", "quiesce.end"]
    for e in events:
        assert e["uid"] == "ck" and e["role"] == "source"
        assert isinstance(e["wall"], float) and isinstance(e["mono"], float)
        assert e["pid"] == os.getpid()
    assert events[1]["workload_pid"] == 5
    # The reference's reader takes the port's lines as they are.
    assert ref_flight.read_flight_file(path) == events


def test_disabled_writes_nothing(tmp_path, monkeypatch):
    monkeypatch.delenv("GRIT_FLIGHT", raising=False)
    d = str(tmp_path / "ck")
    flight.configure(d, "source")
    flight.emit("quiesce.start")
    assert not os.path.exists(os.path.join(d, FLIGHT_LOG_FILE))


def test_unknown_event_dropped_not_fatal(tmp_path):
    d = str(tmp_path / "ck")
    flight.configure(d, "source")
    flight.emit("not.a.registered.event", bytes=1)
    flight.emit_near(d, "not.a.registered.event")
    events = flight.read_flight_file(os.path.join(d, FLIGHT_LOG_FILE))
    assert [e["ev"] for e in events] == ["migration.configure"]


def test_emit_near_walks_up_and_never_creates_strays(tmp_path, monkeypatch):
    root = str(tmp_path / "ck")
    ref_flight.configure(root, "source")  # the agent's log
    nested = os.path.join(root, "main-work", "hbm")
    os.makedirs(nested)
    # A workload process: no recorder configured and no GRIT_FLIGHT.
    monkeypatch.delenv("GRIT_FLIGHT", raising=False)
    flight.emit_near(nested, "dump.start")
    events = flight.read_flight_file(os.path.join(root, FLIGHT_LOG_FILE))
    assert [(e["ev"], e["uid"], e["role"]) for e in events][-1] == \
        ("dump.start", "ck", "device")
    orphan = str(tmp_path / "elsewhere" / "hbm")
    os.makedirs(orphan)
    flight.emit_near(orphan, "dump.start")
    assert os.listdir(orphan) == []


def test_torn_trailing_line_skipped(tmp_path):
    d = str(tmp_path / "ck")
    flight.configure(d, "source")
    flight.emit("dump.start")
    path = os.path.join(d, FLIGHT_LOG_FILE)
    with open(path, "a") as f:
        f.write('{"ev": "dump.end", "uid": "ck", "wa')  # a crash mid-write
    assert [e["ev"] for e in flight.read_flight_file(path)] == \
        ["migration.configure", "dump.start"]


def test_manager_clock_echoed(tmp_path, monkeypatch):
    pair = {"wall": 123.5, "mono": 7.25, "host": "mgr", "pid": 42}
    monkeypatch.setenv("GRIT_FLIGHT_CLOCK", json.dumps(pair))
    d = str(tmp_path / "ck")
    flight.configure(d, "source")
    events = flight.read_flight_file(os.path.join(d, FLIGHT_LOG_FILE))
    clock = [e for e in events if e["ev"] == "clock.manager"]
    assert clock and clock[0]["peer_wall"] == 123.5
    assert clock[0]["peer_host"] == "mgr" and clock[0]["peer_pid"] == 42


def test_artifact_dir_tee(tmp_path, monkeypatch):
    art = str(tmp_path / "artifacts")
    monkeypatch.setenv("GRIT_FLIGHT_DIR", art)
    d = str(tmp_path / "ck")
    flight.configure(d, "source")
    flight.emit("dump.start")
    (tee,) = os.listdir(art)
    assert tee.startswith("flight-")
    assert "dump.start" in [e["ev"] for e in
                            flight.read_flight_file(os.path.join(art, tee))]


def test_events_without_workdir_use_artifact_dir(tmp_path, monkeypatch):
    art = str(tmp_path / "artifacts")
    monkeypatch.setenv("GRIT_FLIGHT_DIR", art)
    flight.emit("manager.phase", uid="ck-7", kind="Checkpoint",
                phase="Checkpointing", reason="AgentJobCreated")
    (tee,) = os.listdir(art)
    (event,) = flight.read_flight_file(os.path.join(art, tee))
    assert event["uid"] == "ck-7" and event["role"] == "manager"


# -- the dump's and the restore's events against the reference's -----------------


STATE = {"w": np.arange(3 * 1024, dtype=np.float32).reshape(3, 1024),
         "b": np.linspace(-1, 1, 512, dtype=np.float32),
         "step": np.array(7, np.int32)}
_STAMP = {"ev", "uid", "role", "wall", "mono", "host", "pid"}


def _sequence(log: str) -> list[tuple[str, tuple[str, ...]]]:
    return [(e["ev"], tuple(sorted(set(e) - _STAMP)))
            for e in flight.read_flight_file(log)]


def _ref_migration(root: str, case: str) -> list:
    from grit_tpu.device.snapshot import (
        restore_snapshot,
        restore_snapshot_postcopy,
        write_snapshot,
    )

    state = {k: jnp.asarray(v) for k, v in STATE.items()}
    ref_flight.configure(root, "node")
    d = os.path.join(root, "main", "hbm")
    write_snapshot(d, state, mirror=(os.path.join(root, "mirror", "hbm")
                                     if case == "mirror" else None))
    if case == "postcopy":
        restore_snapshot_postcopy(d, like=state).wait(timeout=60)
    else:
        restore_snapshot(d, like=state)
    ref_flight.reset()
    return _sequence(os.path.join(root, FLIGHT_LOG_FILE))


def _port_migration(root: str, case: str) -> list:
    from grit_tpu_torch.device.snapshot import (
        restore_snapshot,
        restore_snapshot_postcopy,
        write_snapshot,
    )

    state = {k: torch.from_numpy(v.copy()) for k, v in STATE.items()}
    flight.configure(root, "node")
    d = os.path.join(root, "main", "hbm")
    write_snapshot(d, state, mirror=(os.path.join(root, "mirror", "hbm")
                                     if case == "mirror" else None))
    like = {k: torch.zeros_like(v) for k, v in state.items()}
    if case == "postcopy":
        restore_snapshot_postcopy(d, like=like).wait(timeout=60)
    else:
        restore_snapshot(d, like=like)
    flight.reset()
    return _sequence(os.path.join(root, FLIGHT_LOG_FILE))


@pytest.mark.parametrize("case", ["blocking", "postcopy", "mirror"])
def test_dump_and_restore_emit_the_reference_events(case, tmp_path,
                                                    monkeypatch):
    """A dump and a restore (blocking; post-copy with every array in the
    tail; a zlib mirror, whose tee reports ``codec.wait``) write the
    reference's events, in its order, with its field keys. The reference
    runs its Python planes (``GRIT_IO_NATIVE=0``, ``GRIT_TPU_NATIVE=0``),
    and its native plane's ``io.*`` events (there, the loud
    ``io.degrade``) are left out: the port has no native plane."""
    monkeypatch.setenv("GRIT_IO_NATIVE", "0")
    monkeypatch.setenv("GRIT_TPU_NATIVE", "0")
    if case == "postcopy":
        monkeypatch.setenv("GRIT_RESTORE_POSTCOPY_HOT_MB", "0")
    if case == "mirror":
        monkeypatch.setenv("GRIT_SNAPSHOT_CODEC", "zlib")
    got = _port_migration(str(tmp_path / "port" / "mig"), case)
    want = [(ev, keys) for ev, keys in
            _ref_migration(str(tmp_path / "ref" / "mig"), case)
            if not ev.startswith("io.")]
    assert got == want
    names = [ev for ev, _ in got]
    assert names.count("dump.chunk") == len(STATE)
    assert {"dump.start", "dump.end", "restart.end", "place.start",
            "place.end"} <= set(names)


# -- the unchanged agent drives the port's hook ----------------------------------


def test_reference_agent_with_the_port_hook_yields_a_complete_report(
        tmp_path, monkeypatch):
    """``run_checkpoint`` of the reference agent, the port's hook and a
    port agentlet: the hook's brackets and the workload's dump land in the
    log the agent configured, and gritscope reads a complete report with
    the quiesce and the dump."""
    from grit_tpu.agent.checkpoint import CheckpointOptions, run_checkpoint
    from grit_tpu.cri.runtime import (
        Container,
        FakeRuntime,
        OciSpec,
        Sandbox,
        SimProcess,
    )
    from grit_tpu_torch.device.hook import TpuDeviceCheckpointHook
    from test_torch_agentlet import _Loop

    monkeypatch.setenv("GRIT_TPU_SOCKET_DIR", str(tmp_path))
    rt = FakeRuntime(log_root=str(tmp_path / "logs"))
    rt.add_sandbox(Sandbox(id="sb", pod_name="p", pod_namespace="ns",
                           pod_uid="u"))
    rt.add_container(Container(id="c1", sandbox_id="sb", name="main",
                               spec=OciSpec(image="img")),
                     process=SimProcess(memory_size=8192), running=True)
    rt.tasks["c1"].pid = os.getpid()  # the in-process loop's agentlet
    work = str(tmp_path / "host" / "ns" / "ck")
    lp = _Loop()
    try:
        run_checkpoint(rt, CheckpointOptions(
            pod_name="p", pod_namespace="ns", pod_uid="u", work_dir=work,
            dst_dir=str(tmp_path / "pvc" / "ns" / "ck"),
            kubelet_log_root=str(tmp_path / "logs"), leave_running=True),
            TpuDeviceCheckpointHook())
    finally:
        lp.close()
    events = load_events([work])
    report = build_report(group_migrations(events)["ck"], uid="ck")
    assert not report["incomplete"], report
    for phase in ("quiesce", "dump"):
        assert phase in report["phases"], report["phases"].keys()
    by_pid = {(e["ev"], e["pid"]) for e in events}
    assert ("dump.chunk", os.getpid()) in by_pid
    assert {"quiesce.start", "quiesce.end", "snap.speculative.start",
            "snap.speculative.validated"} <= {e["ev"] for e in events}


# -- trace spans over a wire migration (twin of the zero-orphan case) ------------


def test_port_wire_migration_zero_orphan_spans(tmp_path, monkeypatch):
    """Twin of ``test_device_wire_migration_zero_orphan_spans``: a port
    dump with a zlib mirror and a wire tee into the reference's receiver
    (the agent ships the rest of the tree and commits), then a port
    restore. Every span's parent resolves (the mirror writer and the codec
    pool join the dump's trace), and gritscope reads a complete dump →
    wire → place timeline."""
    from grit_tpu.agent.copy import StageJournal, WireReceiver
    from grit_tpu.agent.copy import WireSender as RefSender
    from grit_tpu.obs import trace as ref_trace
    from grit_tpu_torch.device.snapshot import restore_snapshot, write_snapshot
    from grit_tpu_torch.obs import trace
    from grit_tpu_torch.wire import WireDumpSink, WireSender

    sink_path = str(tmp_path / "trace.jsonl")
    monkeypatch.setenv("GRIT_TPU_TRACE_FILE", sink_path)
    monkeypatch.setenv("GRIT_SNAPSHOT_CODEC", "zlib")
    trace.close_export()
    ref_trace.close_export()
    root = str(tmp_path / "mig")
    ref_flight.configure(root, "node")
    src, dst = os.path.join(root, "src"), os.path.join(root, "dst")
    state = {"w": torch.zeros((256, 512)),
             "b": torch.arange(4096, dtype=torch.int32)}
    recv = WireReceiver(dst, journal=StageJournal(dst))
    rel = os.path.join("main", "hbm", "data-h0000.bin")
    sender = RefSender(recv.endpoint, streams=2)
    try:
        with trace.span("agent.checkpoint"):
            dump_sender = WireSender(recv.endpoint, streams=2)
            wire_sink = WireDumpSink(dump_sender, rel)
            try:
                write_snapshot(os.path.join(src, "main", "hbm"), state,
                               mirror=os.path.join(root, "mirror", "main"),
                               wire=wire_sink)
            finally:
                dump_sender.close()
        assert wire_sink.ok, wire_sink.error
        ref_flight.emit("wire.send.start")
        files = dict(sender.send_tree(src, skip={rel}))
        ref_flight.emit("wire.send.end")
        files[rel] = wire_sink.nbytes
        sender.commit(files, timeout=30)
    finally:
        sender.close()
    recv.wait(timeout=30)
    out = restore_snapshot(os.path.join(dst, "main", "hbm"))
    assert torch.equal(out["['b']"], state["b"])
    trace.close_export()
    ref_trace.close_export()

    spans = trace.read_trace_file(sink_path)
    ids = {s["spanId"] for s in spans}
    orphans = [s["name"] for s in spans
               if s["parentSpanId"] and s["parentSpanId"] not in ids]
    assert orphans == []
    by_name = {s["name"]: s for s in spans}
    for name in ("snapshot.write", "snapshot.mirror", "wire_stream",
                 "snapshot.restore", "restore_pipeline"):
        assert name in by_name, sorted(by_name)
    joined = {s["name"] for s in spans
              if s["traceId"] == by_name["agent.checkpoint"]["traceId"]}
    assert {"snapshot.mirror", "snapshot.write", "wire_stream"} <= joined
    report = build_report(group_migrations(load_events([root]))["mig"],
                          uid="mig", trace_path=sink_path)
    assert not report["incomplete"], report
    for phase in ("dump", "wire_send", "wire_commit", "place"):
        assert phase in report["phases"]
    assert report.get("trace_spans")


# -- the phase profiler rides the recorder --------------------------------------


@pytest.mark.parametrize("via", ["emit", "emit_near", "no-log"])
def test_brackets_arm_the_phase_profiler(via, tmp_path):
    """``emit`` and ``emit_on`` (through ``emit_near``) hand every recorded
    event to the phase profiler: a bracket arms it and its end writes the
    folded file beside the log; a directory with no log records nothing
    and arms nothing."""
    from grit_tpu_torch.obs import profile

    profile.reset()
    d = str(tmp_path / "ck")
    nested = os.path.join(d, "main", "hbm")
    os.makedirs(nested)
    if via == "emit":
        flight.configure(d, "source")

        def emit(ev, **fields):
            flight.emit(ev, **fields)
    else:
        if via == "emit_near":
            ref_flight.configure(d, "node")  # the agent's log
            ref_flight.reset()

        def emit(ev, **fields):
            flight.emit_near(nested, ev, **fields)
    try:
        emit("place.start", arrays=1)
        armed = [] if via == "no-log" else ["place"]
        assert profile.default_profiler().armed_phases() == armed
        emit("place.waterline", array=1, arrays=1, bytes=4)
        assert profile.default_profiler().armed_phases() == armed
        emit("place.end", arrays=1, bytes=4, ok=True)
        assert profile.default_profiler().armed_phases() == []
        path = os.path.join(d, profile.prof_file_name("place"))
        assert os.path.isfile(path) == (via != "no-log")
    finally:
        profile.reset()


# -- every emit site of the port names a registered event ------------------------


def test_every_port_emit_site_uses_a_registered_literal():
    sites = []
    for root, _dirs, files in os.walk(os.path.join(REPO, "grit_tpu_torch")):
        for name in files:
            if not name.endswith(".py"):
                continue
            path = os.path.join(root, name)
            with open(path) as f:
                tree = ast.parse(f.read())
            for node in ast.walk(tree):
                if not (isinstance(node, ast.Call)
                        and isinstance(node.func, ast.Attribute)
                        and isinstance(node.func.value, ast.Name)
                        and node.func.value.id == "flight"
                        and node.func.attr in ("emit", "emit_near",
                                               "emit_on")):
                    continue
                arg = node.args[0 if node.func.attr == "emit" else 1]
                sites.append((os.path.relpath(path, REPO), node.lineno,
                              arg.value if isinstance(arg, ast.Constant)
                              else None))
    assert len(sites) >= 30, sites
    bad = [s for s in sites if s[2] not in flight.EVENTS]
    assert bad == [], bad
