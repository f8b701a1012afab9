"""``chip_smoke.py``'s parked sources: phases 8, 9 and 10 start their
workloads together and park each at its first checkpoint point
(``park_all``) until its phase resumes it. Rehearsed on the CPU: a
failure while parking kills every source at once, and phase 10 runs its
raw and zlib wire migrations from two sources parked together, as the
card runs them at the flagship's width."""

from __future__ import annotations

import threading
import time

import torch

import chip_smoke


class _Source:
    """A stand-in for a spawned ``Workload``: ``wait_for`` fails at once
    (``fails``) or blocks until the source is killed."""

    def __init__(self, fails: bool) -> None:
        self.fails = fails
        self.killed = threading.Event()

    def wait_for(self, pattern: str):
        if self.fails:
            raise RuntimeError("workload exited (rc 1)")
        if not self.killed.wait(60):
            raise AssertionError("never killed")
        raise RuntimeError("workload exited (rc -9)")

    def kill(self) -> None:
        self.killed.set()


def test_a_failed_park_kills_every_source_at_once(tmp_path):
    """One source that dies before ``READY`` fails ``park_all`` at once,
    and every source is killed before it returns: the others' waits do
    not run to their own timeouts."""
    started = {k: (_Source(k == "bad"), str(tmp_path)) for k in
               ("a", "bad", "b", "c")}
    t0 = time.perf_counter()
    try:
        chip_smoke.park_all(started)
    except RuntimeError as exc:
        assert "rc 1" in str(exc)
    else:
        raise AssertionError("park_all did not raise")
    assert time.perf_counter() - t0 < 10
    assert all(src.killed.is_set() for src, _ in started.values())


def test_wire_phase_from_sources_parked_together(tmp_path, monkeypatch):
    """Phase 10 on the CPU (the tiny config at 2 layers): both sources
    spawned together and parked by ``park_all`` short of the cut, then
    the raw and the zlib wire migrations from them, each destination's
    losses against its source's, the receiver that hangs up and the
    flipped byte refused."""
    monkeypatch.setattr(chip_smoke, "KERNELS", {})  # no launches on the CPU
    monkeypatch.setattr(chip_smoke, "WORKLOAD_ARGS", [
        "--config", "tiny", "--device", "cpu", "--seq", "128",
        "--layers", "2"])
    monkeypatch.setattr(chip_smoke, "WIRE_LAYERS", 2)
    work = str(tmp_path)
    started = chip_smoke.spawn_wire_sources(work, chip_smoke.WIRE_RUNS)
    try:
        parked = chip_smoke.park_all({label: (src, socks) for label,
                                      (src, _env, socks) in started.items()})
        for label, (_src, client) in parked.items():
            assert client.status()["step"] < chip_smoke.MIGRATE_CUT, label
        sources = {label: (*parked[label], started[label][1])
                   for label in started}
        got = chip_smoke.phase_wire(torch, work, "cpu", sources,
                                    dev=torch.device("cpu"))
    finally:
        for src, _env, _socks in started.values():
            src.kill()
    assert set(got) >= {"raw", "zlib", "flip", "launches"}
    assert got["zlib"]["codec"] == "zlib"
