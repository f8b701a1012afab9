"""The port's live progress (``grit_tpu_torch.obs.progress``), its sampler
(``grit_tpu_torch.obs.sampler``), the codec pool's probes and the
workload's server, held to the reference's: twins of
``tests/test_progress.py``'s tracker, sampler and workload-server cases run
through both packages on the same inputs, the snapshot record's shape, and
the port's feeders: the place loop's bytes (a restore, and a post-copy
restore's hot set plus tail) equal to the snapshot's and to the
reference's on the same state, the wire sender's raw bytes (raw and
zlib), and the mirror tee's, counted only when there is no wire."""

from __future__ import annotations

import json
import os
import socket
import threading
import time
import types
import urllib.request

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from grit_tpu import codec as ref_codec
from grit_tpu.obs import metrics as ref_metrics
from grit_tpu.obs import progress as ref_progress
from grit_tpu.obs import sampler as ref_sampler
from grit_tpu.obs import server as ref_server
from grit_tpu_torch import codec
from grit_tpu_torch.obs import metrics, progress, sampler, server

PKGS = {
    "port": types.SimpleNamespace(progress=progress, sampler=sampler,
                                  metrics=metrics, codec=codec, server=server),
    "ref": types.SimpleNamespace(progress=ref_progress, sampler=ref_sampler,
                                 metrics=ref_metrics, codec=ref_codec,
                                 server=ref_server),
}


@pytest.fixture(autouse=True)
def _clean_progress():
    for pkg in PKGS.values():
        pkg.progress.reset()
        pkg.sampler.reset()
    yield
    for pkg in PKGS.values():
        pkg.progress.reset()
        pkg.sampler.reset()


@pytest.fixture(params=sorted(PKGS))
def pkg(request):
    return PKGS[request.param]


def test_metadata_names_are_the_reference():
    from grit_tpu import metadata as ref_meta
    from grit_tpu_torch import metadata

    assert (metadata.PROGRESS_FILE, metadata.PROF_FILE_PREFIX) == \
        (ref_meta.PROGRESS_FILE, ref_meta.PROF_FILE_PREFIX)


# -- the tracker (twins of TestProgressTracker) ----------------------------------


def test_bytes_are_monotonic(pkg):
    t = pkg.progress.ProgressTracker("ck", "source")
    t.add_bytes(100)
    t.add_bytes(0)
    t.add_bytes(-50)  # feeders cannot subtract
    t.add_bytes(25)
    assert t.snapshot()["bytesShipped"] == 125


def test_total_never_shrinks(pkg):
    t = pkg.progress.ProgressTracker("ck", "source")
    t.set_total(1000)
    t.set_total(400)
    assert t.snapshot()["totalBytes"] == 1000
    t.set_total(2000)
    assert t.snapshot()["totalBytes"] == 2000
    t.add_total(500)
    assert t.snapshot()["totalBytes"] == 2500


def test_rate_window_and_eta(pkg):
    t = pkg.progress.ProgressTracker("ck", "source")
    t.set_total(10_000)
    t.add_bytes(1_000)
    time.sleep(0.05)
    t.add_bytes(1_000)
    rate = t.rate_bps()
    assert rate > 0
    eta = t.eta_s()
    assert eta is not None
    assert eta == pytest.approx(8_000 / rate, rel=0.25)


def test_eta_none_without_total_and_zero_when_done(pkg):
    t = pkg.progress.ProgressTracker("ck", "source")
    t.add_bytes(500)
    assert t.eta_s() is None
    t.set_total(500)
    assert t.eta_s() == 0.0


def test_stalled_rate_decays_to_zero(pkg, monkeypatch):
    monkeypatch.setattr(pkg.progress, "RATE_WINDOW_S", 0.1)
    t = pkg.progress.ProgressTracker("ck", "source")
    t.set_total(1000)
    t.add_bytes(10)
    time.sleep(0.25)
    assert t.rate_bps() == 0.0
    assert t.eta_s() is None


def test_advanced_at_bumps_on_forward_progress_only(pkg):
    t = pkg.progress.ProgressTracker("ck", "source")
    t0 = t.snapshot()["advancedAt"]
    time.sleep(0.02)
    t.set_rates(dirty_bps=1.0, link_bps=2.0)  # not progress
    t.set_ledger({"cpuCores": 1.0})            # not progress
    t.set_standby(tickAt=1.0)                  # not progress
    assert t.snapshot()["advancedAt"] == t0
    t.set_phase("place")
    t1 = t.snapshot()["advancedAt"]
    assert t1 > t0
    time.sleep(0.02)
    t.set_phase("place")
    assert t.snapshot()["advancedAt"] == t1
    time.sleep(0.02)
    t.note_round(1)
    assert t.snapshot()["advancedAt"] > t1


def test_publish_roundtrip(pkg, tmp_path):
    t = pkg.progress.ProgressTracker("ck", "workload",
                                     publish_dir=str(tmp_path))
    t.add_bytes(42)
    assert t.publish()
    rec = pkg.progress.read_progress_file(
        str(tmp_path / ".grit-progress.json"))
    assert rec["bytesShipped"] == 42 and rec["uid"] == "ck"
    assert not t.publish(min_interval_s=60.0)  # throttled
    # No tmp file is left behind.
    assert os.listdir(tmp_path) == [".grit-progress.json"]


def test_channel_rate(pkg):
    t = pkg.progress.ProgressTracker("ck", "source")
    t.add_bytes(100, stream="wire-0")
    time.sleep(0.05)
    t.add_bytes(100, stream="wire-1")
    t.add_bytes(1000, stream="mirror")
    assert t.channel_rate_bps("wire-") > 0
    snap = t.snapshot()
    assert snap["streams"]["wire-0"]["bytes"] == 100
    assert snap["streams"]["mirror"]["bytes"] == 1000


def test_adopt_keeps_same_uid_tracker(pkg, tmp_path):
    p = pkg.progress
    a = p.configure("ck", p.ROLE_SOURCE, publish_dir=str(tmp_path))
    a.add_bytes(10)
    assert p.adopt("ck", p.ROLE_SOURCE) is a
    b = p.adopt("other", p.ROLE_SOURCE)
    assert b is not a
    assert b.snapshot()["bytesShipped"] == 0


def test_ensure_replaces_on_a_new_uid_and_add_bytes_needs_a_tracker(pkg):
    p = pkg.progress
    p.add_bytes(p.ROLE_WORKLOAD, 99)  # no tracker: a no-op
    assert p.get(p.ROLE_WORKLOAD) is None
    a = p.ensure(p.ROLE_WORKLOAD, uid="/snap/a")
    assert p.ensure(p.ROLE_WORKLOAD) is a
    p.add_bytes(p.ROLE_WORKLOAD, 7, stream="place")
    assert a.snapshot()["bytesShipped"] == 7
    b = p.ensure(p.ROLE_WORKLOAD, uid="/snap/b")
    assert b is not a and b.snapshot()["bytesShipped"] == 0
    assert p.trackers() == [b]
    assert p.uid_from_dir("/host/ns/ck-7/") == "ck-7"


def test_read_progress_file_tolerates_torn_and_missing(pkg, tmp_path):
    torn = tmp_path / "torn.json"
    torn.write_text('{"uid": "ck", "bytes')
    assert pkg.progress.read_progress_file(str(torn)) is None
    assert pkg.progress.read_progress_file(str(tmp_path / "nope")) is None
    (tmp_path / "list.json").write_text("[1, 2]")
    assert pkg.progress.read_progress_file(str(tmp_path / "list.json")) is None


def _fill(mod):
    t = mod.ProgressTracker("ck", "source", ordinal=2, clone=1)
    t.set_total(4096)
    t.add_bytes(1024, stream="wire-0")
    t.set_phase("dump")
    t.note_round(0)
    t.set_rates(dirty_bps=5.0, link_bps=9.0)
    t.set_ledger({"cpuCores": 0.5})
    t.set_standby(backlogBytes=3)
    return t.snapshot()


def test_snapshot_record_is_the_reference_shape():
    """The same feeds give the same record, the clock fields aside."""
    clocks = {"startedAt", "advancedAt", "updatedAt", "rateBps",
              "avgRateBps", "etaSeconds", "streams"}
    got, want = _fill(progress), _fill(ref_progress)
    assert list(got) == list(want)
    assert {k: v for k, v in got.items() if k not in clocks} == \
        {k: v for k, v in want.items() if k not in clocks}
    assert got["streams"]["wire-0"]["bytes"] == \
        want["streams"]["wire-0"]["bytes"] == 1024


# -- the sampler (twins of TestSampler) ------------------------------------------


def test_sample_refreshes_gauges(pkg):
    t = pkg.progress.configure("ck", pkg.progress.ROLE_SOURCE)
    t.add_bytes(777)
    s = pkg.sampler.Sampler(period_s=60.0)
    s.register("progress", pkg.sampler._sample_progress)
    s.sample_once()
    assert pkg.metrics.PROGRESS_BYTES_SHIPPED.value(role="source") == 777
    assert pkg.metrics.PROGRESS_ETA_SECONDS.value(role="source") == -1.0


def test_failing_callback_does_not_kill_the_rest(pkg):
    calls = []

    def bad():
        raise RuntimeError("boom")

    s = pkg.sampler.Sampler(period_s=60.0)
    s.register("a-bad", bad)
    s.register("b-good", lambda: calls.append(1))
    s.sample_once()
    s.sample_once()
    assert len(calls) == 2


def test_start_stop_is_clean_and_bounded(pkg):
    ticks = []
    s = pkg.sampler.Sampler(period_s=0.05)
    s.register("tick", lambda: ticks.append(1))
    s.start()
    assert any(t.name == "grit-obs-sampler" for t in threading.enumerate())
    time.sleep(0.2)
    t0 = time.monotonic()
    s.stop(timeout=2.0)
    assert time.monotonic() - t0 < 2.5
    assert not s.running
    assert ticks
    n = len(ticks)
    time.sleep(0.15)
    assert len(ticks) <= n + 1


def test_default_sampler_registers_the_reference_callbacks():
    assert list(sampler.default_sampler()._callbacks) == \
        list(ref_sampler.default_sampler()._callbacks)


def test_codec_queue_depth_sampled(pkg):
    pkg.codec.shared_pool()
    s = pkg.sampler.default_sampler()
    s.sample_once()
    assert pkg.codec.queue_depth() is not None


# -- the codec pool's probes -----------------------------------------------------


@pytest.fixture
def no_pool(monkeypatch):
    """Each package's codec module with no pool created yet."""
    for mod in (codec, ref_codec):
        monkeypatch.setattr(mod, "_pool", None)
        monkeypatch.setattr(mod, "_pool_workers", 0)


def test_codec_probes_never_create_the_pool(pkg, no_pool):
    c = pkg.codec
    assert c.queue_depth() is None
    assert c.pool_saturation() is None
    assert c.active_jobs() == 0
    c.sample_queue_depth()
    pkg.sampler.default_sampler().sample_once()
    assert c._pool is None


def test_codec_saturation_counts_running_jobs(pkg, no_pool, monkeypatch):
    monkeypatch.setenv("GRIT_CODEC_WORKERS", "2")
    c = pkg.codec
    gate, started = threading.Event(), threading.Event()

    def job():
        started.set()
        gate.wait(10)
        return 1

    fut = c.pool_submit(job)
    try:
        assert started.wait(10)
        assert c.active_jobs() == 1
        assert c.queue_depth() == 0
        assert c.pool_saturation() == pytest.approx(0.5)
    finally:
        gate.set()
    assert fut.result(10) == 1
    deadline = time.monotonic() + 5
    while c.active_jobs() and time.monotonic() < deadline:
        time.sleep(0.01)
    assert c.active_jobs() == 0 and c.pool_saturation() == 0.0
    c.sample_queue_depth()
    assert pkg.metrics.CODEC_QUEUE_DEPTH.value() == 0


# -- the workload's server (twins of TestWorkloadMetricsServer) -------------------


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_workload_server_disabled_by_default(pkg, monkeypatch):
    monkeypatch.delenv("GRIT_WORKLOAD_METRICS_PORT", raising=False)
    monkeypatch.setattr(pkg.server, "_workload_srv", None)
    assert pkg.server.start_workload_metrics_server() is None
    assert pkg.sampler._sampler is None


def test_workload_server_serves_progress_and_starts_the_sampler(
        pkg, monkeypatch):
    monkeypatch.setattr(pkg.server, "_workload_srv", None)
    port = _free_port()
    monkeypatch.setenv("GRIT_WORKLOAD_METRICS_PORT", str(port))
    monkeypatch.setenv("GRIT_OBS_SAMPLE_S", "0.05")
    pkg.progress.configure("ck", pkg.progress.ROLE_WORKLOAD).add_bytes(4242)
    srv = pkg.server.start_workload_metrics_server()
    try:
        assert srv is not None
        assert pkg.server.start_workload_metrics_server() is srv
        assert pkg.sampler.default_sampler().running
        want = b'grit_progress_bytes_shipped{role="workload"} 4242'
        deadline = time.monotonic() + 10
        while True:
            with urllib.request.urlopen(
                    f"http://127.0.0.1:{port}/metrics", timeout=5) as r:
                body = r.read()
            if want in body or time.monotonic() > deadline:
                break
            time.sleep(0.05)
        assert b"grit_place_chunk_seconds" in body
        assert want in body
    finally:
        srv.shutdown()
        srv.server_close()


# -- the port's feeders ------------------------------------------------------------

STATE = {"w": np.arange(3 * 1024, dtype=np.float32).reshape(3, 1024),
         "b": np.linspace(-1, 1, 512, dtype=np.float32),
         "step": np.array(7, np.int32)}


def _port_restore(d: str, case: str) -> None:
    from grit_tpu_torch.device.snapshot import (
        restore_snapshot,
        restore_snapshot_postcopy,
    )

    like = {k: torch.zeros(v.shape, dtype=torch.from_numpy(v).dtype)
            for k, v in STATE.items()}
    if case == "blocking":
        restore_snapshot(d, like=like)
    else:
        restore_snapshot_postcopy(d, like=like).wait(timeout=60)


def _ref_restore(d: str, case: str) -> None:
    from grit_tpu.device.snapshot import (
        restore_snapshot,
        restore_snapshot_postcopy,
    )

    like = {k: jnp.asarray(v) for k, v in STATE.items()}
    if case == "blocking":
        restore_snapshot(d, like=like)
    else:
        restore_snapshot_postcopy(d, like=like).wait(timeout=60)


# Post-copy cuts: every array in the tail (0 MB), and a hot set of the two
# small arrays with the 12 KiB one in the tail (0.005 MB).
CASES = {"blocking": None, "postcopy-all-tail": "0",
         "postcopy-hot-and-tail": "0.005"}


@pytest.mark.parametrize("case", sorted(CASES))
def test_place_progress_equals_the_snapshot_and_the_reference(
        case, tmp_path, monkeypatch):
    """The ``workload`` tracker of a restore reads the snapshot's bytes,
    shipped and total, in its ``place`` phase and stream. The reference's
    restore of the same state reads the same through its place loop; its
    post-copy tail feeds no tracker (``grit_tpu/device/snapshot.py``'s
    ``_tail_parented``), so there it reads the hot set alone, and the
    port's tail adds the rest."""
    from grit_tpu.device.snapshot import write_snapshot as ref_write
    from grit_tpu_torch.device.snapshot import snapshot_nbytes, write_snapshot

    monkeypatch.setenv("GRIT_IO_NATIVE", "0")
    monkeypatch.setenv("GRIT_TPU_NATIVE", "0")
    cut = CASES[case]
    if cut is not None:
        monkeypatch.setenv("GRIT_RESTORE_POSTCOPY_HOT_MB", cut)
    port_dir = write_snapshot(str(tmp_path / "port"),
                              {k: torch.from_numpy(v.copy())
                               for k, v in STATE.items()})
    ref_dir = str(tmp_path / "ref")
    ref_write(ref_dir, {k: jnp.asarray(v) for k, v in STATE.items()})
    _port_restore(port_dir, case)
    _ref_restore(ref_dir, case)
    got = progress.get(progress.ROLE_WORKLOAD).snapshot()
    want = ref_progress.get(ref_progress.ROLE_WORKLOAD).snapshot()
    n = snapshot_nbytes(port_dir)
    hot = n if cut is None else sum(
        v.nbytes for v in STATE.values() if v.nbytes <= float(cut) * 1e6)
    assert got["uid"] == os.path.abspath(port_dir)
    assert (got["phase"], got["bytesShipped"], got["totalBytes"]) == \
        ("place", n, n)
    assert got["streams"]["place"]["bytes"] == n and got["etaSeconds"] == 0.0
    assert (want["phase"], want["bytesShipped"], want["totalBytes"]) == \
        ("place", hot, hot)


def _raw_blocks() -> list[np.ndarray]:
    rng = np.random.default_rng(3)
    return [np.tile(np.arange(256, dtype=np.uint8), 64),
            rng.integers(0, 256, 10_000, np.uint8),
            np.zeros(5000, np.uint8)]


@pytest.mark.parametrize("codec_name", ["none", "zlib"])
def test_wire_sender_counts_raw_bytes_per_stream(codec_name, tmp_path):
    """Every frame the port's sender puts on a socket counts its RAW bytes
    on the ``source`` tracker, in its stream ``wire-<k>``: a zlib session
    reads its raw total, not its payload."""
    from grit_tpu.agent.copy import StageJournal, WireReceiver
    from grit_tpu_torch.wire import WireSender

    tracker = progress.configure("ck", progress.ROLE_SOURCE)
    dst = str(tmp_path / "dst")
    recv = WireReceiver(dst, journal=StageJournal(dst))
    try:
        sender = WireSender(recv.endpoint, streams=2)
        off = 0
        for block in _raw_blocks():
            if codec_name == "none":
                sender.send_chunk("f", off, block.tobytes())
            else:
                used, payload, raw_n, crc = codec.compress_block(
                    block, codec.CODEC_ZLIB)
                sender.send_record("f", off, payload, used, raw_n, crc)
            off += block.nbytes
        sender.eof("f", off)
        sender.close()
        snap = tracker.snapshot()
        assert snap["bytesShipped"] == off
        assert set(snap["streams"]) == {"wire-0", "wire-1"}
        assert sum(s["bytes"] for s in snap["streams"].values()) == off
        if codec_name == "zlib":
            assert sender.sent_bytes < off  # the payload was smaller
    finally:
        recv.close()


@pytest.mark.parametrize("wire", [False, True], ids=["mirror", "mirror+wire"])
def test_mirror_counts_source_bytes_only_without_a_wire(wire, tmp_path):
    """The mirror tee's drained raw bytes count on the ``source`` tracker
    (stream ``mirror``) when it has no wire; with one, the sender counts
    them, once."""
    from grit_tpu.agent.copy import StageJournal, WireReceiver
    from grit_tpu_torch.device.snapshot import write_snapshot
    from grit_tpu_torch.wire import WireDumpSink, WireSender

    tracker = progress.configure("ck", progress.ROLE_SOURCE)
    state = {k: torch.from_numpy(v.copy()) for k, v in STATE.items()}
    src = str(tmp_path / "src" / "main" / "hbm")
    mirror = str(tmp_path / "mirror" / "main" / "hbm")
    recv = sender = None
    sink = None
    if wire:
        dst = str(tmp_path / "dst")
        recv = WireReceiver(dst, journal=StageJournal(dst))
        sender = WireSender(recv.endpoint, streams=2)
        sink = WireDumpSink(sender, os.path.join("main", "hbm",
                                                 "data-h0000.bin"))
    try:
        d = write_snapshot(src, state, mirror=mirror, wire=sink)
    finally:
        if sender is not None:
            sender.close()
        if recv is not None:
            recv.close()
    data = os.path.getsize(os.path.join(d, "data-h0000.bin"))
    snap = tracker.snapshot()
    assert snap["bytesShipped"] == data
    assert set(snap["streams"]) == ({"wire-0", "wire-1"} if wire
                                    else {"mirror"})


def test_progress_file_is_the_reference_reader_s(tmp_path):
    """The port's ``.grit-progress.json`` reads back through the
    reference's reader, which ``gritscope watch`` shares."""
    t = progress.ProgressTracker("ck", "workload", publish_dir=str(tmp_path))
    t.set_total(10)
    t.add_bytes(10, stream="place")
    assert t.publish()
    rec = ref_progress.read_progress_file(str(tmp_path / ".grit-progress.json"))
    assert rec == json.loads((tmp_path / ".grit-progress.json").read_text())
    assert (rec["bytesShipped"], rec["totalBytes"], rec["etaSeconds"]) == \
        (10, 10, 0.0)
