"""The port's metrics (``grit_tpu_torch.obs.metrics``), its workload
``/metrics`` server and log correlation, held to the reference's: each
shared metric's name, type, help, label names and buckets, the text
exposition, the codec's byte accounting on the same blocks, the snapshot's
and the wire's counters against what they moved, speculation's outcome
counters, and nothing at all (no flight file, trace file or server) when
no knob asks for it."""

from __future__ import annotations

import logging
import os
import threading
import urllib.request

import numpy as np
import pytest
import torch

from grit_tpu.obs import metrics as ref_metrics
from grit_tpu_torch.obs import metrics
from grit_tpu_torch.obs import server

SHARED = sorted(name for name, m in vars(metrics).items()
                if isinstance(m, metrics._Metric))


def test_the_port_shares_the_issue_list_of_metrics():
    assert SHARED == sorted([
        "SNAPSHOT_BYTES", "SNAPSHOT_SECONDS", "SNAP_SPECULATIVE_BYTES",
        "SNAP_SPECULATIVE_SECONDS", "SNAP_SPECULATIVE_ROUNDS",
        "RESTORE_PIPELINE_SECONDS", "RESTORE_OVERLAP_FRACTION",
        "PLACE_CHUNK_SECONDS", "CODEC_BYTES", "CODEC_SECONDS",
        "CODEC_QUEUE_DEPTH", "CODEC_RATIO", "CODEC_WAIT_SECONDS", "WIRE_BYTES",
        "WIRE_SECONDS", "WIRE_STALL_SECONDS", "WIRE_FRAME_SEND_SECONDS",
        "SERVE_DRAIN_SECONDS", "SERVE_DRAINED_SLOTS", "SERVE_CLONES",
        "SLICE_BARRIER_SECONDS", "FLIGHT_EVENTS"])


@pytest.mark.parametrize("name", SHARED)
def test_metric_is_described_as_the_reference(name):
    got, want = getattr(metrics, name), getattr(ref_metrics, name)
    assert (got.name, got.kind, got.help, got.labelnames) == \
        (want.name, want.kind, want.help, want.labelnames)
    assert getattr(got, "buckets", None) == getattr(want, "buckets", None)
    assert metrics.REGISTRY._metrics[got.name] is got


def _exercise(mod, kind: str) -> str:
    reg = mod.Registry()
    if kind == "counter":
        c = reg.counter("t_total", "help with \"quotes\"", ("dir", "codec"))
        c.inc(3, dir="in", codec="zlib")
        c.inc(0.5, dir="out", codec='a"b\\c')
    elif kind == "gauge":
        g = reg.gauge("t_gauge", "a gauge")
        g.set(2.25)
        reg.gauge("t_labelled", "by role", ("role",)).set(7, role="send")
    else:
        h = reg.histogram("t_seconds", "a histogram", (0.01, 0.1, 1.0),
                          ("phase",))
        for v in (0.005, 0.05, 0.5, 5.0, 0.1):
            h.observe(v, phase="place")
    return reg.render()


@pytest.mark.parametrize("kind", ["counter", "gauge", "histogram"])
def test_text_exposition_is_the_reference(kind):
    assert _exercise(metrics, kind) == _exercise(ref_metrics, kind)


def _codec_bytes(mod) -> dict:
    return dict(mod.CODEC_BYTES._values)


BLOCKS = {
    "zero": np.zeros(1 << 16, np.uint8),
    "compressible": np.tile(np.arange(64, dtype=np.uint8), 1 << 10),
    "random": np.random.default_rng(0).integers(0, 256, 1 << 16, np.uint8),
}


@pytest.mark.parametrize("block", sorted(BLOCKS))
def test_codec_accounts_a_block_as_the_reference(block):
    """The same block through each package's ``compress_block`` and back
    through ``decompress_block`` moves the same ``CODEC_BYTES``."""
    from grit_tpu import codec as ref_codec
    from grit_tpu_torch import codec

    view = BLOCKS[block]
    deltas = []
    for mod, mmod in ((codec, metrics), (ref_codec, ref_metrics)):
        before = _codec_bytes(mmod)
        used, payload, raw_n, crc = mod.compress_block(view, mod.CODEC_ZLIB)
        assert bytes(mod.decompress_block(used, payload, raw_n, crc)) == \
            view.tobytes()
        after = _codec_bytes(mmod)
        deltas.append({k: v - before.get(k, 0.0) for k, v in after.items()
                       if v != before.get(k, 0.0)})
    assert deltas[0] == deltas[1] and deltas[0]


def test_snapshot_counters_equal_the_bytes_moved(tmp_path):
    from grit_tpu_torch.device.snapshot import (
        restore_snapshot,
        snapshot_nbytes,
        write_snapshot,
    )

    state = {"w": torch.randn(300, 7), "step": torch.tensor(3)}
    b0 = metrics.SNAPSHOT_BYTES.value(op="write")
    r0 = metrics.SNAPSHOT_BYTES.value(op="restore")
    s0 = metrics.SNAPSHOT_SECONDS.value(op="write")
    d = write_snapshot(str(tmp_path / "snap"), state)
    assert metrics.SNAPSHOT_BYTES.value(op="write") - b0 == snapshot_nbytes(d)
    assert metrics.SNAPSHOT_SECONDS.value(op="write") > s0
    n0 = metrics.PLACE_CHUNK_SECONDS.count()
    restore_snapshot(d, like={k: torch.zeros_like(v) for k, v in state.items()})
    assert metrics.SNAPSHOT_BYTES.value(op="restore") - r0 == \
        snapshot_nbytes(d)
    assert metrics.PLACE_CHUNK_SECONDS.count() - n0 == len(state)
    assert 0.0 <= metrics.RESTORE_OVERLAP_FRACTION.value() <= 1.0


def test_wire_counters_equal_what_the_sender_moved(tmp_path):
    """The port's sender into the reference's receiver: ``WIRE_BYTES``
    counts the bytes it put on its sockets, and each frame one
    ``WIRE_FRAME_SEND_SECONDS`` observation."""
    from grit_tpu.agent.copy import StageJournal, WireReceiver
    from grit_tpu_torch.wire import WireSender

    dst = str(tmp_path / "dst")
    recv = WireReceiver(dst, journal=StageJournal(dst))
    try:
        b0 = metrics.WIRE_BYTES.value(role="send")
        f0 = metrics.WIRE_FRAME_SEND_SECONDS.count()
        sender = WireSender(recv.endpoint, streams=2)
        for k in range(5):
            sender.send_chunk("f", k * 1024, b"x" * 1024)
        sender.eof("f", 5 * 1024)
        sender.close()
        assert metrics.WIRE_BYTES.value(role="send") - b0 == \
            sender.sent_bytes > 5 * 1024
        assert metrics.WIRE_FRAME_SEND_SECONDS.count() - f0 == 6
    finally:
        recv.close()


def test_a_validated_round_accounts_its_bytes(tmp_path, monkeypatch):
    """A quiesce with a dump spec, then its dump: one ``validated`` round,
    and clean plus dirty bytes equal to the snapshot's."""
    from grit_tpu_torch.device.agentlet import ToggleClient
    from grit_tpu_torch.device.snapshot import snapshot_nbytes
    from test_torch_agentlet import _Loop

    monkeypatch.setenv("GRIT_TPU_SOCKET_DIR", str(tmp_path))
    v0 = metrics.SNAP_SPECULATIVE_ROUNDS.value(outcome="validated")
    c0 = metrics.SNAP_SPECULATIVE_BYTES.value(outcome="clean")
    d0 = metrics.SNAP_SPECULATIVE_BYTES.value(outcome="dirty")
    lp = _Loop()
    try:
        with ToggleClient(0, path=lp.agentlet.path, timeout=30) as c:
            d = str(tmp_path / "ck" / "hbm")
            c.quiesce(dump_spec={"dir": d})
            assert c.dump(d)["speculative"]["outcome"] == "validated"
            c.resume()
    finally:
        lp.close()
    assert metrics.SNAP_SPECULATIVE_ROUNDS.value(outcome="validated") == v0 + 1
    moved = (metrics.SNAP_SPECULATIVE_BYTES.value(outcome="clean") - c0
             + metrics.SNAP_SPECULATIVE_BYTES.value(outcome="dirty") - d0)
    assert moved == snapshot_nbytes(d)


# -- the workload's /metrics and log correlation ---------------------------------


@pytest.fixture
def no_workload_server():
    server._workload_srv = None
    yield
    if server._workload_srv is not None:
        server._workload_srv.shutdown()
        server._workload_srv.server_close()
    server._workload_srv = None


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_workload_server_serves_metrics_once(no_workload_server, monkeypatch):
    port = _free_port()
    monkeypatch.setenv("GRIT_WORKLOAD_METRICS_PORT", str(port))
    srv = server.start_workload_metrics_server()
    assert srv is not None and server.start_workload_metrics_server() is srv
    with urllib.request.urlopen(f"http://127.0.0.1:{port}/metrics",
                                timeout=10) as resp:
        body = resp.read().decode()
    assert "# TYPE grit_snapshot_bytes_total counter" in body


@pytest.mark.parametrize("value", ["", "0"])
def test_workload_server_starts_nothing_at_port_zero(value, no_workload_server,
                                                     monkeypatch):
    monkeypatch.setenv("GRIT_WORKLOAD_METRICS_PORT", value)
    assert server.start_workload_metrics_server() is None
    assert server._workload_srv is None


def test_a_busy_port_never_raises(no_workload_server, monkeypatch):
    import socket

    with socket.socket() as busy:
        busy.bind(("0.0.0.0", 0))
        busy.listen(1)
        monkeypatch.setenv("GRIT_WORKLOAD_METRICS_PORT",
                           str(busy.getsockname()[1]))
        assert server.start_workload_metrics_server() is None


def test_log_correlation_stamps_uid_and_role(tmp_path, monkeypatch):
    from grit_tpu_torch.obs import flight, logctx

    monkeypatch.setenv("GRIT_FLIGHT", "1")
    flight.reset()
    logctx.reset()
    records: list[logging.LogRecord] = []

    class Keep(logging.Handler):
        def emit(self, record):
            records.append(record)

    handler = Keep()
    log = logging.getLogger("grit_tpu_torch.test_logctx")
    log.addHandler(handler)
    try:
        logctx.install_log_correlation()
        log.warning("before")
        flight.configure(str(tmp_path / "ns" / "ck-9"), "source")
        log.warning("during")
        fmt = logctx.CorrelationFormatter(logging.Formatter("%(message)s"))
        assert [(r.grit_uid, r.grit_role) for r in records] == \
            [("", ""), ("ck-9", "source")]
        assert fmt.format(records[1]) == "during [uid=ck-9 role=source]"
        assert fmt.format(records[0]) == "before"
    finally:
        log.removeHandler(handler)
        flight.reset()


def test_no_knob_no_file_no_server(tmp_path, monkeypatch, no_workload_server):
    """With no obs knob set, a dump (mirror and all) and a restore through
    an agentlet write no flight or trace file and start no server."""
    from grit_tpu_torch.device.agentlet import Agentlet
    from grit_tpu_torch.device.snapshot import restore_snapshot, write_snapshot
    from grit_tpu_torch.obs import flight, trace

    for knob in ("GRIT_FLIGHT", "GRIT_FLIGHT_DIR", "GRIT_TPU_TRACE_FILE",
                 "GRIT_WORKLOAD_METRICS_PORT"):
        monkeypatch.delenv(knob, raising=False)
    flight.reset()
    trace.close_export()
    root = tmp_path / "ck"
    flight.configure(str(root), "node")  # a no-op without GRIT_FLIGHT
    with Agentlet(lambda: {}, path=str(tmp_path / "a.sock")):
        d = write_snapshot(str(root / "hbm"), {"w": torch.ones(64)},
                           mirror=str(root / "mirror"))
        restore_snapshot(d, like={"w": torch.zeros(64)})
        assert server._workload_srv is None
        assert not any(t.name == "grit-metrics"
                       for t in threading.enumerate())
    found = [os.path.join(dp, f) for dp, _, fs in os.walk(tmp_path)
             for f in fs if f.endswith(".jsonl")]
    assert found == []
