"""The port's staged, pipelined restore against the reference's stager:
twins of ``tests/test_restore_pipeline.py::TestStageJournalWaterline`` and
``::TestStreamedRestore``. The journal is written by the reference's
``StageJournal`` and ``run_restore_streamed``; the port's
``restore_snapshot`` consumes the tree while it is still being staged,
bit-identically to a serial restore, and fails loudly on a failed stage,
a corrupt late chunk or a stage that stalls. Every case runs with
``GRIT_RESTORE_PIPELINE`` 0 and 1."""

from __future__ import annotations

import json
import os
import shutil
import threading
import time

import numpy as np
import pytest
import torch

from grit_tpu.agent.copy import StageJournal
from grit_tpu.agent.restore import RestoreOptions, run_restore, run_restore_streamed
from grit_tpu.metadata import DOWNLOAD_STATE_FILE, STAGE_JOURNAL_FILE
from grit_tpu_torch import metadata
from grit_tpu_torch.device import snapshot as psnap


@pytest.fixture(autouse=True, params=["0", "1"], ids=["serial", "pipelined"])
def pipeline(request, monkeypatch):
    monkeypatch.setenv("GRIT_RESTORE_PIPELINE", request.param)
    return request.param


def _state() -> dict:
    gen = torch.Generator().manual_seed(7)
    return {"w": torch.randn(256, 64, generator=gen),
            "b": torch.arange(1000, dtype=torch.int32),
            "h": torch.randn(32, 48, generator=gen).to(torch.bfloat16),
            "s": torch.tensor(3, dtype=torch.int64)}


def _assert_matches(restored: dict, state: dict) -> None:
    for name, want in state.items():
        assert torch.equal(restored[f"['{name}']"], want), name


def _stage_metadata(snap: str, dst: str) -> StageJournal:
    """COMMIT and MANIFEST staged with ``done`` lines; the data file
    preallocated as a chunked transfer leaves it (an ungated read would
    see zeros, not a missing file)."""
    os.makedirs(dst)
    journal = StageJournal(dst)
    for name in (psnap.COMMIT_FILE, psnap.MANIFEST_FILE):
        shutil.copyfile(os.path.join(snap, name), os.path.join(dst, name))
        journal.note_file(name, os.path.getsize(os.path.join(dst, name)))
    size = os.path.getsize(os.path.join(snap, psnap.DATA_FILE))
    with open(os.path.join(dst, psnap.DATA_FILE), "wb") as f:
        f.truncate(size)
    return journal


def _restore_in_thread(d: str, box: dict) -> threading.Thread:
    def run():
        try:
            box["out"] = psnap.restore_snapshot(d)
        except BaseException as exc:  # noqa: BLE001 — inspected by the test
            box["err"] = exc
    t = threading.Thread(target=run, daemon=True)
    t.start()
    return t


class TestStageJournalWaterline:
    """The port's monitor reading the reference writer's journal."""

    def test_waterline_gates_only_the_contiguous_prefix(self, tmp_path):
        j = StageJournal(str(tmp_path))
        mon = psnap._StageMonitor.find(str(tmp_path / "sub" / "hbm"))
        assert mon is not None and mon.root == str(tmp_path)
        path = str(tmp_path / "f")
        j.note_chunk("f", 16, 8, 32)  # hole at 0..16: nothing ready
        assert not mon._ready_locked("f", 1)
        j.note_chunk("f", 0, 16, 32)  # waterline 24
        mon.wait_ready(path, 24)
        mon._poll_locked()
        assert not mon._ready_locked("f", 25)
        j.note_chunk("f", 24, 8, 32)
        mon.wait_ready(path)  # done
        # Paths outside the staging root are not part of the transfer.
        mon.wait_ready(str(tmp_path.parent / "elsewhere"), 10 ** 9)

    def test_torn_trailing_line_stays_buffered(self, tmp_path):
        journal = os.path.join(tmp_path, STAGE_JOURNAL_FILE)
        line = json.dumps({"file": "f", "staged": 10, "done": True}) + "\n"
        with open(journal, "w") as f:
            f.write(line[:9])
        mon = psnap._StageMonitor.find(str(tmp_path))
        mon._poll_locked()
        assert not mon._ready_locked("f", None)
        with open(journal, "a") as f:
            f.write(line[9:])
        mon.wait_ready(str(tmp_path / "f"))

    def test_terminal_markers(self, tmp_path, monkeypatch):
        monkeypatch.setenv("GRIT_TPU_STAGE_TIMEOUT_S", "5")
        j = StageJournal(str(tmp_path / "a"))
        j.complete()
        psnap._StageMonitor.find(str(tmp_path / "a")).wait_ready(
            str(tmp_path / "a" / "anything"), 10 ** 9)
        j = StageJournal(str(tmp_path / "b"))
        j.fail("boom")
        with pytest.raises(psnap.SnapshotIntegrityError, match="boom"):
            psnap._StageMonitor.find(str(tmp_path / "b")).wait_ready(
                str(tmp_path / "b" / "f"), 1)


class TestStreamedRestore:
    def test_bit_identity_streamed_vs_serial_stage(self, tmp_path):
        state = _state()
        src = os.path.join(tmp_path, "pvc")
        psnap.write_snapshot(os.path.join(src, "main", "hbm"), state)

        serial_dst = os.path.join(tmp_path, "dst-serial")
        run_restore(RestoreOptions(src_dir=src, dst_dir=serial_dst))
        serial = psnap.restore_snapshot(os.path.join(serial_dst, "main", "hbm"))

        stream_dst = os.path.join(tmp_path, "dst-stream")
        handle = run_restore_streamed(RestoreOptions(src_dir=src,
                                                     dst_dir=stream_dst))
        # The sentinel is down when the handle exists: the restore may
        # start at once, mid-transfer.
        assert os.path.exists(os.path.join(stream_dst, DOWNLOAD_STATE_FILE))
        streamed = psnap.restore_snapshot(os.path.join(stream_dst, "main", "hbm"))
        handle.wait(timeout=60.0)
        assert psnap.last_restore_pipeline()["streamed"] is True
        _assert_matches(serial, state)
        _assert_matches(streamed, state)

    def test_streamed_delta_and_base_restore(self, tmp_path):
        """A pre-copy layout (base sibling, delta referencing it) staged by
        the reference's streamed stage: the restore waits on the base's
        COMMIT and follows the references."""
        src = os.path.join(tmp_path, "pvc")
        base = os.path.join(src, "main-precopy", "hbm")
        psnap.write_snapshot(base, _state(), hashes=True)
        state = dict(_state(), w=_state()["w"] * 2)
        psnap.write_snapshot(os.path.join(src, "main", "hbm"), state, base=base)
        dst = os.path.join(tmp_path, "dst")
        handle = run_restore_streamed(RestoreOptions(src_dir=src, dst_dir=dst))
        got = psnap.restore_snapshot(os.path.join(dst, "main", "hbm"))
        handle.wait(timeout=60.0)
        _assert_matches(got, state)

    def test_pipelined_matches_serial_restore_path(self, tmp_path, monkeypatch,
                                                   pipeline):
        state = _state()
        snap = psnap.write_snapshot(os.path.join(tmp_path, "snap"), state)
        got = psnap.restore_snapshot(snap)
        assert psnap.last_restore_pipeline()["pipelined"] is (pipeline == "1")
        monkeypatch.setenv("GRIT_RESTORE_PIPELINE", "0")
        serial = psnap.restore_snapshot(snap)
        for key in serial:
            assert torch.equal(serial[key], got[key]), key
        like = {k: torch.empty_like(v, device="meta") for k, v in state.items()}
        monkeypatch.setenv("GRIT_TPU_RESTORE_WORKERS", "3")
        monkeypatch.setenv("GRIT_RESTORE_PIPELINE", pipeline)
        placed = psnap.restore_snapshot(snap, like=like, device="cpu")
        assert psnap.last_restore_pipeline()["workers"] == \
            (3 if pipeline == "1" else 0)
        assert all(torch.equal(placed[k], state[k]) for k in state)

    def test_late_data_gates_restore_until_staged(self, tmp_path):
        """Metadata staged, bulk data still in flight: the restore blocks,
        never consuming the preallocated zeros, and completes once the
        bytes land — in pieces, with waterline lines."""
        state = _state()
        snap = psnap.write_snapshot(os.path.join(tmp_path, "snap"), state)
        dst = os.path.join(tmp_path, "staged")
        journal = _stage_metadata(snap, dst)
        box: dict = {}
        t = _restore_in_thread(dst, box)
        time.sleep(0.5)
        assert t.is_alive(), "restore consumed a half-staged snapshot"
        data = open(os.path.join(snap, psnap.DATA_FILE), "rb").read()
        piece = len(data) // 3 + 1
        with open(os.path.join(dst, psnap.DATA_FILE), "r+b") as f:
            for off in range(0, len(data), piece):
                f.seek(off)
                f.write(data[off:off + piece])
                f.flush()
                journal.note_chunk(psnap.DATA_FILE, off,
                                   len(data[off:off + piece]), len(data))
                time.sleep(0.05)
        journal.complete()
        t.join(timeout=60.0)
        assert not t.is_alive()
        assert "err" not in box, box.get("err")
        _assert_matches(box["out"], state)
        rec = psnap.last_restore_pipeline()
        assert rec["streamed"] and rec["stage_wait"] > 0

    def test_late_base_commit_gates_the_delta(self, tmp_path):
        """Under a journal, a delta's base whose COMMIT has not landed yet
        is waited for, not reported missing."""
        src = os.path.join(tmp_path, "src")
        base = os.path.join(src, "base", "hbm")
        psnap.write_snapshot(base, _state())
        psnap.write_snapshot(os.path.join(src, "main", "hbm"),
                             dict(_state(), s=torch.tensor(4)), base=base)
        dst = os.path.join(tmp_path, "dst")
        shutil.copytree(src, dst)
        os.unlink(os.path.join(dst, "base", "hbm", psnap.COMMIT_FILE))
        journal = StageJournal(dst)
        for rel in ("main/hbm/COMMIT", "main/hbm/MANIFEST.json",
                    "main/hbm/data-h0000.bin", "base/hbm/MANIFEST.json",
                    "base/hbm/data-h0000.bin"):
            journal.note_file(rel, os.path.getsize(os.path.join(dst, rel)))
        box: dict = {}
        t = _restore_in_thread(os.path.join(dst, "main", "hbm"), box)
        time.sleep(0.3)
        assert t.is_alive() and "err" not in box
        shutil.copyfile(os.path.join(base, psnap.COMMIT_FILE),
                        os.path.join(dst, "base", "hbm", psnap.COMMIT_FILE))
        journal.note_file("base/hbm/COMMIT", 1)
        t.join(timeout=60.0)
        assert not t.is_alive() and "err" not in box, box.get("err")
        assert int(box["out"]["['s']"]) == 4

    def test_fully_staged_tree_waits_on_nothing(self, tmp_path):
        """A restore that starts after the stage has ended is streamed
        (a journal governs it) but counts no stage wait: the leg shows
        only reads that found their bytes not yet staged."""
        state = _state()
        snap = psnap.write_snapshot(os.path.join(tmp_path, "snap"), state)
        dst = os.path.join(tmp_path, "staged")
        journal = _stage_metadata(snap, dst)
        shutil.copyfile(os.path.join(snap, psnap.DATA_FILE),
                        os.path.join(dst, psnap.DATA_FILE))
        journal.note_file(psnap.DATA_FILE,
                          os.path.getsize(os.path.join(dst, psnap.DATA_FILE)))
        journal.complete()
        _assert_matches(psnap.restore_snapshot(dst), state)
        rec = psnap.last_restore_pipeline()
        assert rec["streamed"] and rec["stage_wait"] == 0.0

    def test_stager_failure_fails_restore_loudly(self, tmp_path):
        snap = psnap.write_snapshot(os.path.join(tmp_path, "snap"), _state())
        dst = os.path.join(tmp_path, "staged")
        journal = _stage_metadata(snap, dst)
        box: dict = {}
        t = _restore_in_thread(dst, box)
        time.sleep(0.2)
        # Half the data lands, then the stager dies.
        data = open(os.path.join(snap, psnap.DATA_FILE), "rb").read()
        with open(os.path.join(dst, psnap.DATA_FILE), "r+b") as f:
            f.write(data[:len(data) // 2])
        journal.note_chunk(psnap.DATA_FILE, 0, len(data) // 2, len(data))
        journal.fail("PVC read error mid-stream")
        t.join(timeout=60.0)
        assert not t.is_alive()
        assert isinstance(box.get("err"), psnap.SnapshotIntegrityError)
        assert "mid-transfer" in str(box["err"])

    def test_corrupt_late_chunk_fails_loudly(self, tmp_path):
        """Bytes that landed torn fail the crc on both paths: the journal
        saying 'done' is a liveness signal, never an integrity proof."""
        snap = psnap.write_snapshot(os.path.join(tmp_path, "snap"), _state())
        dst = os.path.join(tmp_path, "staged")
        shutil.copytree(snap, dst)
        journal = StageJournal(dst)
        data = os.path.join(dst, psnap.DATA_FILE)
        with open(data, "r+b") as f:
            f.seek(os.path.getsize(data) - 3)  # the last array's bytes
            raw = f.read(1)
            f.seek(-1, os.SEEK_CUR)
            f.write(bytes([raw[0] ^ 0xFF]))
        for rel in os.listdir(dst):
            if rel != STAGE_JOURNAL_FILE:
                journal.note_file(rel, os.path.getsize(os.path.join(dst, rel)))
        journal.complete()
        with pytest.raises(psnap.SnapshotIntegrityError, match="crc mismatch"):
            psnap.restore_snapshot(dst)

    def test_timeout_on_never_arriving_chunk(self, tmp_path, monkeypatch):
        monkeypatch.setenv("GRIT_TPU_STAGE_TIMEOUT_S", "0.5")
        snap = psnap.write_snapshot(os.path.join(tmp_path, "snap"), _state())
        _stage_metadata(snap, os.path.join(tmp_path, "staged"))
        # The journal stays open: no data, no terminal line.
        t0 = time.monotonic()
        with pytest.raises(psnap.SnapshotIntegrityError, match="timed out"):
            psnap.restore_snapshot(os.path.join(tmp_path, "staged"))
        assert time.monotonic() - t0 < 30

    def test_overlap_legs_recorded(self, tmp_path, pipeline):
        """The legs partition the serial work: each is non-negative, the
        overlap fraction lies in [0, 1], and a fully staged snapshot
        waits on nothing."""
        snap = psnap.write_snapshot(os.path.join(tmp_path, "snap"), _state())
        psnap.restore_snapshot(snap)
        rec = psnap.last_restore_pipeline()
        assert rec["stage_wait"] == 0.0 and not rec["streamed"]
        assert rec["read"] >= 0 and rec["place"] >= 0 and rec["wall"] > 0
        assert 0.0 <= rec["overlap_fraction"] <= 1.0
        assert rec["pipelined"] is (pipeline == "1")
        assert rec["bytes"] == psnap.snapshot_nbytes(snap)
        if pipeline == "0":
            assert rec["overlap_fraction"] == pytest.approx(0.0, abs=0.05)


def test_workers_knob(monkeypatch):
    monkeypatch.setenv("GRIT_TPU_RESTORE_WORKERS", "-7")
    assert psnap._restore_workers() == 0
    monkeypatch.setenv("GRIT_TPU_RESTORE_WORKERS", "2")
    assert psnap._restore_workers() == 2
    monkeypatch.setenv("GRIT_TPU_RESTORE_WORKERS", "junk")
    monkeypatch.setattr(os, "cpu_count", lambda: 8)
    assert psnap._restore_workers() == 4
    monkeypatch.delenv("GRIT_TPU_RESTORE_WORKERS")
    monkeypatch.setattr(os, "cpu_count", lambda: 1)
    assert psnap._restore_workers() == 1
    assert metadata.STAGE_JOURNAL_FILE == STAGE_JOURNAL_FILE


def test_many_readers_under_a_tight_switch_interval(tmp_path, monkeypatch):
    """More readers than cores, 64 arrays arriving piecewise from a
    stager thread, the interpreter switching threads every 10 µs: the
    restore is still bit-identical and waits only on the stream."""
    import sys

    monkeypatch.setenv("GRIT_TPU_RESTORE_WORKERS", str((os.cpu_count() or 1) + 4))
    gen = torch.Generator().manual_seed(11)
    state = {f"a{i:02d}": torch.randn(64 + i, 33, generator=gen)
             for i in range(64)}
    snap = psnap.write_snapshot(os.path.join(tmp_path, "snap"), state)
    dst = os.path.join(tmp_path, "staged")
    journal = _stage_metadata(snap, dst)
    data = open(os.path.join(snap, psnap.DATA_FILE), "rb").read()

    def stage():
        with open(os.path.join(dst, psnap.DATA_FILE), "r+b") as f:
            for off in range(0, len(data), 4096):
                f.seek(off)
                f.write(data[off:off + 4096])
                f.flush()
                journal.note_chunk(psnap.DATA_FILE, off,
                                   len(data[off:off + 4096]), len(data))
        journal.complete()

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        stager = threading.Thread(target=stage, daemon=True)
        box: dict = {}
        t = _restore_in_thread(dst, box)
        stager.start()
        t.join(timeout=120.0)
        stager.join(timeout=120.0)
    finally:
        sys.setswitchinterval(old)
    assert not t.is_alive() and not stager.is_alive()
    assert "err" not in box, box.get("err")
    _assert_matches(box["out"], state)
    assert psnap.last_restore_pipeline()["streamed"] is True


class TestPinnedBlocks:
    """The restore's pinned staging on the CPU, over pageable memory (the
    card's page-locked allocation is the only difference)."""

    @pytest.fixture(autouse=True)
    def small_pageable_blocks(self, monkeypatch):
        monkeypatch.setattr(psnap, "_PIECE_BYTES", 1024)
        monkeypatch.setattr(psnap, "_pinned",
                            lambda n: torch.empty(n, dtype=torch.uint8))

    def test_blocks_are_reserved_in_array_order(self):
        pool = psnap._PinnedBlocks(4)
        got: list = []

        def reader(order):
            blocks = pool.reserve(order, 2)
            got.append((order, blocks))

        threads = [threading.Thread(target=reader, args=(k,), daemon=True)
                   for k in (2, 1, 0)]
        for t in threads:
            t.start()
        deadline = time.monotonic() + 30
        while len(got) < 2 and time.monotonic() < deadline:
            time.sleep(0.01)
        time.sleep(0.2)
        # Arrays 0 and 1 hold all four blocks; array 2 waits for one of
        # them to be placed, though it asked first.
        assert sorted(o for o, _ in got) == [0, 1]
        pool.release(dict(got)[0])
        for t in threads:
            t.join(timeout=10)
        assert not any(t.is_alive() for t in threads)
        assert [o for o, _ in got][-1] == 2
        assert sorted(b for _, bs in got[:2] for b in bs) == [0, 1, 2, 3]

    def test_blocks_are_pinned_on_first_need_and_reused(self):
        pool = psnap._PinnedBlocks(8)
        first = pool.reserve(0, 3)
        assert len(pool.tensors) == 3 and pool.pin_s >= 0
        pool.release(first)
        assert sorted(pool.reserve(1, 2)) != [] and len(pool.tensors) == 3
        # One free block left: the next array pins only what it lacks.
        pool.reserve(2, 4)
        assert len(pool.tensors) == 6 and pool.cap == 8
        assert all(len(h) == psnap._PIECE_BYTES for h in pool.host)

    def test_abort_wakes_every_waiter(self):
        pool = psnap._PinnedBlocks(2)
        box: dict = {}

        def reader():
            try:
                pool.reserve(1, 1)  # turn 0 never comes
            except RuntimeError as exc:
                box["err"] = exc

        t = threading.Thread(target=reader, daemon=True)
        t.start()
        time.sleep(0.1)
        pool.abort()
        t.join(timeout=10)
        assert not t.is_alive() and "aborted" in str(box["err"])

    def test_read_into_blocks_waits_per_piece_and_checks_crc(self, tmp_path):
        state = {"x": torch.arange(1300, dtype=torch.int32)}  # 6 pieces
        snap = psnap.write_snapshot(os.path.join(tmp_path, "snap"), state)
        chunk = psnap.SnapshotManifest.load(snap).arrays[0]["chunks"][0]
        dst = os.path.join(tmp_path, "staged")
        journal = _stage_metadata(snap, dst)
        data = open(os.path.join(snap, psnap.DATA_FILE), "rb").read()
        with open(os.path.join(dst, psnap.DATA_FILE), "r+b") as f:
            f.write(data[:2048])
        journal.note_chunk(psnap.DATA_FILE, 0, 2048, len(data))
        pool = psnap._PinnedBlocks(6)
        blocks = pool.reserve(0, 6)
        views = pool.pieces(blocks, chunk["nbytes"], host=True)
        mon = psnap._StageMonitor.find(dst)
        box: dict = {}

        def read():
            try:
                psnap._read_chunk_into(dst, chunk, views, verify=True,
                                       monitor=mon)
            except BaseException as exc:  # noqa: BLE001 — inspected below
                box["err"] = exc

        t = threading.Thread(target=read, daemon=True)
        t.start()
        deadline = time.monotonic() + 30
        while (bytes(np.concatenate(views[:2])) != data[:2048]
               and time.monotonic() < deadline):
            time.sleep(0.01)
        time.sleep(0.2)
        # The first two pieces are read; the third waits for its bytes.
        assert t.is_alive() and "err" not in box, box.get("err")
        assert bytes(np.concatenate(views[:2])) == data[:2048]
        with open(os.path.join(dst, psnap.DATA_FILE), "r+b") as f:
            f.seek(2048)
            f.write(data[2048:])
        journal.note_chunk(psnap.DATA_FILE, 2048, len(data) - 2048, len(data))
        t.join(timeout=30)
        assert not t.is_alive() and "err" not in box, box.get("err")
        assert bytes(np.concatenate(views)) == data
        # A flipped byte fails the running crc.
        with open(os.path.join(dst, psnap.DATA_FILE), "r+b") as f:
            f.seek(len(data) - 1)
            f.write(bytes([data[-1] ^ 1]))
        with pytest.raises(psnap.SnapshotIntegrityError, match="crc mismatch"):
            psnap._read_chunk_into(dst, chunk, views, verify=True, monitor=None)
