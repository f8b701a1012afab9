"""The port's wire (``grit_tpu_torch/wire.py``) against the JAX package's
receiver: the dump's tee streams a snapshot's data file, raw or as codec
records, over 1, 2 and 4 streams into the reference ``WireReceiver``,
whose committed tree restores bitwise through both packages; bounded
backpressure; a dropped receiver and a bad endpoint leave the dump ok; the
reference ``ToggleClient`` dumps the port agentlet with a wire spec; and
the reference harness migrates the port's MNIST workload over the wire
(the port's twins of ``tests/test_wire_migration.py``'s e2e cases)."""

from __future__ import annotations

import json
import os
import socket
import threading
import time

import numpy as np
import pytest
import torch

from grit_tpu import codec as jcodec
from grit_tpu import harness as ref_harness
from grit_tpu.agent.copy import StageJournal, WireReceiver
from grit_tpu.agent.copy import WireSender as RefSender
from grit_tpu.device import snapshot as jsnap
from grit_tpu.device.agentlet import ToggleClient as RefClient
from grit_tpu.device.hook import HBM_SUBDIR
from grit_tpu.harness import MigrationHarness, read_losses
from grit_tpu_torch.device import hook as phook
from grit_tpu_torch.device import snapshot as psnap
from grit_tpu_torch.device.agentlet import Agentlet
from grit_tpu_torch.wire import (
    _WIRE_QUEUE_FRAMES,
    WIRE_FRAME_BYTES,
    WireDumpSink,
    WireError,
    WireSender,
)
from tests.test_torch_hook import PORT_MNIST_WORKLOAD

REL = f"main/{HBM_SUBDIR}/{psnap.DATA_FILE}"


def _state(seed: int = 0) -> dict:
    """Random (raw-shipped), zero (elided) and compressible bytes, over
    several 4 MiB frames."""
    gen = torch.Generator().manual_seed(seed)
    return {"w": torch.randn(1280, 1024, generator=gen),
            "z": torch.zeros(3 << 20, dtype=torch.uint8),
            "r": torch.linspace(0, 1, 700_000),
            "h": torch.randn(33, 7, generator=gen).to(torch.bfloat16),
            "n": torch.tensor(seed, dtype=torch.int32)}


def _assert_restores(d: str, want: dict) -> None:
    """``d`` restores bitwise through the port and the JAX package."""
    got = psnap.restore_snapshot(d)
    jgot = jsnap.restore_snapshot(d)
    for k, v in want.items():
        assert torch.equal(got[f"['{k}']"], v), k
        raw = (v.view(torch.uint8) if v.dtype == torch.bfloat16 else v
               ).numpy().tobytes()
        assert np.asarray(jgot[f"['{k}']"]).tobytes() == raw, k


def _receiver(tmp_path) -> tuple[str, WireReceiver]:
    dst = str(tmp_path / "dst")
    return dst, WireReceiver(dst, host="127.0.0.1", journal=StageJournal(dst))


def _ship_rest(agent: RefSender, src: str, files: dict) -> None:
    """What the agent sends after the dump: the tree's other files over its
    own wire session, then the commit listing everything."""
    for name in sorted(os.listdir(src)):
        rel = f"main/{HBM_SUBDIR}/{name}"
        if rel not in files:
            files[rel] = agent.send_file(rel, os.path.join(src, name))
    agent.commit(files)


@pytest.mark.parametrize("streams", [1, 2, 4])
@pytest.mark.parametrize("codec", ["none", "zlib"])
def test_dump_streams_into_the_reference_receiver(tmp_path, monkeypatch, codec,
                                                  streams):
    monkeypatch.setenv("GRIT_SNAPSHOT_CODEC", codec)
    dst, recv = _receiver(tmp_path)
    agent = RefSender(recv.endpoint, streams=1)  # dialled first, as the agent
    try:
        sender = WireSender(recv.endpoint, streams=streams)
        sink = WireDumpSink(sender, REL)
        src = str(tmp_path / "src" / "hbm")
        mirror = str(tmp_path / "pvc" / "hbm")
        psnap.write_snapshot(src, _state(), wire=sink, mirror=mirror)
        sender.close()
        raw = os.path.getsize(os.path.join(src, psnap.DATA_FILE))
        assert sink.ok and sink.nbytes == raw
        assert 0 <= sink.bytes_during_dump <= sender.sent_bytes
        if codec == "none":
            assert sink.comp_bytes == raw
        else:  # the wire carries the codec's records: the mirror's payloads
            index = jcodec.load_container_index(
                os.path.join(mirror, psnap.DATA_FILE))
            assert sink.comp_bytes == index.comp_size < raw
        _ship_rest(agent, src, {REL: sink.nbytes})
        stats = recv.wait(timeout=60)
        assert stats.bytes > 0
    finally:
        agent.close()
        recv.close()
    assert not os.path.exists(os.path.join(
        dst, REL + jcodec.SIDECAR_SUFFIX))  # the wire lands raw bytes
    _assert_restores(os.path.join(dst, "main", HBM_SUBDIR), _state())
    _assert_restores(mirror, _state())


class _Sink:
    """A TCP peer that accepts and then reads only when told to."""

    def __init__(self, close_after: int | None = None) -> None:
        self.srv = socket.socket()
        self.srv.setsockopt(socket.SOL_SOCKET, socket.SO_RCVBUF, 1 << 16)
        self.srv.bind(("127.0.0.1", 0))
        self.srv.listen(8)
        self.endpoint = f"127.0.0.1:{self.srv.getsockname()[1]}"
        self.reading = threading.Event()
        self.close_after = close_after
        self.got = 0
        self.conns: list[socket.socket] = []
        threading.Thread(target=self._accept, daemon=True).start()

    def _accept(self) -> None:
        while True:
            try:
                conn, _ = self.srv.accept()
            except OSError:
                return
            self.conns.append(conn)
            threading.Thread(target=self._read, args=(conn,),
                             daemon=True).start()

    def _read(self, conn: socket.socket) -> None:
        if self.close_after is None:
            self.reading.wait()
        try:
            while True:
                data = conn.recv(1 << 20)
                if not data:
                    return
                self.got += len(data)
                if self.close_after is not None and self.got > self.close_after:
                    conn.shutdown(socket.SHUT_RDWR)
                    conn.close()
                    return
        except OSError:
            return

    def close(self) -> None:
        self.reading.set()
        self.srv.close()
        for c in self.conns:
            c.close()


def test_backpressure_bounds_what_the_source_buffers():
    """A destination that does not read: the producer blocks once each
    stream's queue holds its frames (stall accrues), and goes on once the
    destination reads."""
    peer = _Sink()
    sender = WireSender(peer.endpoint, streams=2)
    payload = bytes(WIRE_FRAME_BYTES)
    sent = []

    def produce():
        for k in range(40):
            sender.send_chunk(REL, k * len(payload), payload)
            sent.append(k)

    t = threading.Thread(target=produce, daemon=True)
    t.start()
    time.sleep(1.5)
    try:
        assert t.is_alive()  # blocked on the full queues
        queued = sum(q.qsize() for q in sender._queues)
        assert queued <= 2 * _WIRE_QUEUE_FRAMES
        # Queued, plus one frame in each worker's hands, plus what the
        # sockets' buffers took.
        assert len(sent) < 40
        peer.reading.set()
        t.join(timeout=60)
        assert not t.is_alive() and len(sent) == 40
        assert sender.stall_s > 0.5
    finally:
        sender.close()
        peer.close()
    assert sender.sent_bytes >= 40 * len(payload)


def test_dropped_receiver_leaves_the_dump_ok(tmp_path, monkeypatch):
    """A destination that hangs up mid-stream: the wire's ``ok`` turns
    false with the error, the dump and its mirror commit all the same."""
    monkeypatch.setenv("GRIT_SNAPSHOT_CODEC", "none")
    peer = _Sink(close_after=2 * WIRE_FRAME_BYTES)
    sender = WireSender(peer.endpoint, streams=1)
    sink = WireDumpSink(sender, REL)
    src, mirror = str(tmp_path / "hbm"), str(tmp_path / "pvc")
    big = {"w": torch.randn(8 << 20)}  # 32 MiB, far past what the peer takes
    try:
        psnap.write_snapshot(src, big, wire=sink, mirror=mirror)
    finally:
        sender.close()
        peer.close()
    assert not sink.ok and sink.error
    assert psnap.snapshot_exists(src) and psnap.snapshot_exists(mirror)
    assert torch.equal(psnap.restore_snapshot(mirror)["['w']"], big["w"])


@pytest.mark.parametrize("endpoint", ["127.0.0.1:1", "no-port-here"])
def test_bad_endpoint_raises_wire_error(endpoint):
    with pytest.raises(WireError, match="wire connect"):
        WireSender(endpoint)


def test_a_flipped_byte_fails_the_session(tmp_path):
    """A frame whose payload does not match its crc: the reference
    receiver fails the whole session (journal poisoned)."""
    dst, recv = _receiver(tmp_path)
    sender = WireSender(recv.endpoint, streams=1)
    try:
        good = np.arange(4096, dtype=np.uint8).tobytes()
        sender.send_chunk(REL, 0, good)
        bad = bytearray(good)
        bad[7] ^= 1
        sender._enqueue({"t": "chunk", "rel": REL, "off": len(good),
                         "n": len(bad), "crc": jcodec.zlib.crc32(good)},
                        bytes(bad))
        deadline = time.monotonic() + 10
        while recv.poll() is None and time.monotonic() < deadline:
            time.sleep(0.05)
        assert recv.poll() == "failed" and "CRC" in recv._error
    finally:
        sender.close()
        recv.close()
    journal = open(os.path.join(dst, ".grit-stage-journal")).read()
    assert '"failed"' in journal


class _BigLoop:
    """A loop whose state spans several wire frames, with an agentlet."""

    def __init__(self) -> None:
        self.state = _state()
        self.agentlet = Agentlet(lambda: self.state,
                                 step_fn=lambda: int(self.state["n"])).start()
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self) -> None:
        while not self._stop.is_set():
            self.state = dict(self.state, n=self.state["n"] + 1)
            self.agentlet.checkpoint_point()
            time.sleep(0.002)

    def close(self) -> None:
        self._stop.set()
        self.agentlet.stop()
        self._thread.join(timeout=10)


@pytest.mark.parametrize("codec", ["none", "zlib"])
def test_reference_client_dumps_the_port_agentlet_over_the_wire(
        tmp_path, monkeypatch, codec):
    monkeypatch.setenv("GRIT_TPU_SOCKET_DIR", str(tmp_path))
    monkeypatch.setenv("GRIT_SNAPSHOT_CODEC", codec)
    loop = _BigLoop()
    dst, recv = _receiver(tmp_path)
    agent = RefSender(recv.endpoint, streams=1)
    c = RefClient(0, path=loop.agentlet.path, timeout=60)
    try:
        d = str(tmp_path / "host" / "hbm")
        step = c.quiesce(dump_spec={"dir": d})
        resp = c.dump(d, wire={"endpoint": recv.endpoint,
                               "prefix": f"main/{HBM_SUBDIR}", "streams": 2})
        state = dict(loop.state)
        c.resume()
        wire = resp["wire"]
        raw = os.path.getsize(os.path.join(d, psnap.DATA_FILE))
        assert wire["ok"] is True and wire["files"] == {REL: raw}
        # What reached a socket before the tee's end is a race with the
        # send threads; all of it has by the response.
        assert wire["sent_bytes"] > 0
        assert 0 <= wire["dump_overlap_bytes"] <= wire["sent_bytes"]
        assert wire["send_s"] >= 0 and wire["stall_s"] >= 0
        assert resp["speculative"]["outcome"] == "validated"
        # The validated re-ship references its -spec sibling: the agent
        # ships that tree too.
        spec = d + psnap.SPEC_SUFFIX
        files = dict(wire["files"])
        for name in os.listdir(spec):
            rel = f"main/{HBM_SUBDIR}{psnap.SPEC_SUFFIX}/{name}"
            files[rel] = agent.send_file(rel, os.path.join(spec, name))
        _ship_rest(agent, d, files)
        recv.wait(timeout=60)
    finally:
        c.close()
        agent.close()
        recv.close()
        loop.close()
    assert int(state["n"]) == step
    _assert_restores(os.path.join(dst, "main", HBM_SUBDIR), state)


def test_agentlet_answers_a_dead_wire_and_still_dumps(tmp_path, monkeypatch):
    monkeypatch.setenv("GRIT_TPU_SOCKET_DIR", str(tmp_path))
    loop = _BigLoop()
    c = RefClient(0, path=loop.agentlet.path, timeout=60)
    try:
        c.quiesce()
        d = str(tmp_path / "hbm")
        resp = c.dump(d, mirror=str(tmp_path / "pvc"),
                      wire={"endpoint": "127.0.0.1:1", "prefix": "main/hbm"})
        c.resume()
    finally:
        c.close()
        loop.close()
    assert resp["ok"] is True
    assert resp["wire"]["ok"] is False and "connect" in resp["wire"]["error"]
    assert psnap.snapshot_exists(d) and psnap.snapshot_exists(
        str(tmp_path / "pvc"))


@pytest.mark.parametrize("pre_copy", [False, True], ids=["blackout", "pre-copy"])
def test_reference_harness_migrates_the_mnist_twin_over_the_wire(
        tmp_path, monkeypatch, pre_copy):
    """``stage_wire()`` + ``checkpoint(migration_path="wire")`` through the
    port's hook: the dump streams straight to the destination, which
    restores and continues bit-identically; with pre-copy, the prestaged
    base never crosses the wire and the blackout dump is a delta."""
    monkeypatch.setattr(ref_harness, "AutoDeviceHook", phook.AutoDeviceHook)
    h = MigrationHarness(str(tmp_path), workload_src=PORT_MNIST_WORKLOAD)
    src = h.spawn(n_steps=10 ** 9)
    try:
        h.wait_ready(src)
        h.wait_until_step(src, 3)
        threading.Thread(target=src.stdout.read, daemon=True).start()
        runtime = h.make_source_runtime(src.pid)
        shipped = h.precopy(runtime) if pre_copy else None
        handle = h.stage_wire(prestage=pre_copy)
        h.checkpoint(runtime, pre_copy=pre_copy, preshipped=shipped,
                     migration_path="wire")
        stats = handle.wait(timeout=120)
    finally:
        src.kill()
        src.wait()
    assert stats.bytes > 0
    hbm_rel = os.path.join("main", HBM_SUBDIR, psnap.DATA_FILE)
    assert hbm_rel in handle.receiver._done  # streamed by the dump
    delta_dir = os.path.join(h.dst_host, "main", HBM_SUBDIR)
    cut = json.load(open(os.path.join(delta_dir, "MANIFEST.json")))["meta"]["step"]
    assert cut >= 3
    if pre_copy:
        base_rel = os.path.join("main-precopy", HBM_SUBDIR, psnap.DATA_FILE)
        assert base_rel not in handle.receiver._done
        assert os.path.isfile(os.path.join(h.dst_host, base_rel))

    ref = h.spawn(n_steps=cut + 5)
    ref_losses = read_losses(ref.stdout.read().splitlines())
    assert ref.wait() == 0 and len(ref_losses) == cut + 5
    spec = h.shim_restore_spec()
    dst = h.spawn(extra_env=h.restore_env(spec), n_steps=cut + 5, cache="dst")
    out = dst.stdout.read().splitlines()
    assert dst.wait() == 0
    assert f"RESTORED {cut}" in out
    got = read_losses(out)
    assert len(got) == 5 and got == {s: x for s, x in ref_losses.items()
                                     if s > cut}
