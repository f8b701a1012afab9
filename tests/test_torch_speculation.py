"""Validated speculation (the quiesce-free dump) in the port, driven by the
unchanged reference: twins of ``tests/test_concurrent_dump.py`` against the
port's agentlet, through the reference's ``ToggleClient`` and the port's,
and through both packages' device hooks. A quiesce that pre-announces its
dump clones the state at a step boundary and writes it while the loop
steps; the parked dump validates the live state against the clone, byte
for byte, and re-ships only what changed. Every cell stays bit-identical:
clean, fully dirty, partially dirty, over a rolling delta base, a failed
launch, pass or validation (loud degrade to the parked dump), speculation
off, the non-parking probe, and a speculative dump racing live in-place
steps of the MNIST and a small llama Trainer."""

from __future__ import annotations

import logging
import os
import threading
import time

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from grit_tpu.device import snapshot as rsnap
from grit_tpu.device.agentlet import ToggleClient as RefClient
from grit_tpu.device.hook import HBM_SUBDIR
from grit_tpu.device.hook import TpuDeviceCheckpointHook as RefHook
from grit_tpu_torch.device import agentlet as pagentlet
from grit_tpu_torch.device import hook as phook
from grit_tpu_torch.device import snapshot as psnap
from grit_tpu_torch.device.agentlet import Agentlet, ToggleClient
from grit_tpu_torch.device.quiesce import clone_generation, clone_live_generation
from grit_tpu_torch.device.snapshot import (
    SPEC_SUFFIX,
    SnapshotManifest,
    restore_snapshot,
    snapshot_delta_nbytes,
    snapshot_exists,
    snapshot_nbytes,
    write_snapshot,
)
from grit_tpu_torch.ops import build

pytestmark = pytest.mark.race  # concurrency suite, as its reference is

CLIENTS = {"reference": RefClient, "port": ToggleClient}


@pytest.fixture(params=sorted(CLIENTS))
def client_cls(request):
    return CLIENTS[request.param]


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread: the suite runs several workers on a few cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _loop_thread(agentlet, stop, period_s=0.001):
    """Offer a checkpoint point every ``period_s``, as a training loop
    does: speculation harvests its clone at one of these boundaries, the
    loop parks at a later one."""
    def run():
        while not stop.is_set():
            agentlet.checkpoint_point()
            time.sleep(period_s)
    t = threading.Thread(target=run, daemon=True)
    t.start()
    return t


class _Served:
    """An agentlet over ``state`` with a loop thread offering boundaries."""

    def __init__(self, state: dict, tmp_path, **kw) -> None:
        self.state = state
        self.path = str(tmp_path / "a.sock")
        kw.setdefault("step_fn", lambda: int(self.state.get("step", 0)))
        self.agentlet = Agentlet(lambda: self.state, path=self.path, **kw)
        self._stop = threading.Event()

    def __enter__(self) -> "_Served":
        self.agentlet.start()
        self._thread = _loop_thread(self.agentlet, self._stop)
        return self

    def __exit__(self, *exc) -> None:
        self._stop.set()
        self._thread.join(timeout=5)
        self.agentlet.stop()
        assert not self._thread.is_alive()


def _like(state: dict) -> dict:
    return {k: (torch.empty_like(v) if isinstance(v, torch.Tensor) else 0)
            for k, v in state.items()}


def _data(d: str) -> bytes:
    with open(os.path.join(d, psnap.DATA_FILE), "rb") as f:
        return f.read()


# -- the validated-speculation matrix ------------------------------------------------


class TestValidatedSpeculation:
    def test_clean_validation_ships_zero_redump_bytes(self, tmp_path,
                                                      client_cls):
        """Nothing touched between the clone and the park: every leaf is
        clean, the parked dump is all references into the ``-spec`` pass,
        and it restores bit-identically."""
        state = {"w": torch.arange(64.0), "b": torch.ones(16),
                 "step": torch.tensor(3, dtype=torch.int32)}
        d = str(tmp_path / "snap")
        with _Served(state, tmp_path) as srv:
            with client_cls(0, path=srv.path) as client:
                client.quiesce(dump_spec={"dir": d})
                assert srv.agentlet.paused
                resp = client.dump(d)
                client.resume()
        spec = resp["speculative"]
        assert spec["outcome"] == "validated", spec
        assert spec["dirty_bytes"] == 0
        assert spec["clean_bytes"] == snapshot_nbytes(d)
        assert spec["overlap_s"] >= 0 and spec["validate_s"] >= 0
        assert snapshot_exists(d + SPEC_SUFFIX)
        assert snapshot_delta_nbytes(d) == 0
        out = restore_snapshot(d, like=_like(state))
        for k in state:
            assert torch.equal(out[k], state[k]), k

    def test_fully_dirty_validation_reships_everything(self, tmp_path,
                                                       client_cls):
        """Every leaf changed in place after the clone: nothing is clean,
        every byte is re-shipped, and the snapshot is the parked state."""
        state = {"w": torch.arange(64.0), "b": torch.ones(16),
                 "step": torch.tensor(3, dtype=torch.int32)}
        d = str(tmp_path / "snap")
        with _Served(state, tmp_path) as srv:
            with client_cls(0, path=srv.path) as client:
                client.quiesce(dump_spec={"dir": d})
                assert srv.agentlet.paused
                state["w"].mul_(2.0).add_(1.0)  # in place, as the optimizers
                state["b"].sub_(5.0)
                state["step"].add_(1)
                resp = client.dump(d)
                client.resume()
        spec = resp["speculative"]
        assert spec["outcome"] == "validated"
        assert spec["clean_bytes"] == 0
        assert spec["dirty_bytes"] == snapshot_nbytes(d)
        assert snapshot_delta_nbytes(d) == snapshot_nbytes(d)
        out = restore_snapshot(d, like=_like(state))
        assert torch.equal(out["w"], torch.arange(64.0) * 2.0 + 1.0)
        assert torch.equal(out["b"], torch.ones(16) - 5.0)
        assert int(out["step"]) == 4

    def test_partial_dirty_reships_only_touched_arrays(self, tmp_path,
                                                       client_cls):
        state = {"w": torch.arange(64.0), "frozen": torch.ones(1024)}
        d = str(tmp_path / "snap")
        with _Served(state, tmp_path) as srv:
            with client_cls(0, path=srv.path) as client:
                client.quiesce(dump_spec={"dir": d})
                state["w"].add_(1.0)  # only w is touched
                resp = client.dump(d)
                client.resume()
        spec = resp["speculative"]
        assert spec["outcome"] == "validated"
        assert spec["dirty_bytes"] == 64 * 4 == snapshot_delta_nbytes(d)
        out = restore_snapshot(d, like=_like(state))
        assert torch.equal(out["w"], torch.arange(64.0) + 1.0)
        assert torch.equal(out["frozen"], torch.ones(1024))

    def test_speculation_rides_a_rolling_delta_base(self, tmp_path,
                                                    client_cls):
        """The pass itself deltas against a committed rolling base; the
        re-ship references through it, two hops, and restores right."""
        state = {"w": torch.arange(64.0), "frozen": torch.ones(1024)}
        base_d, d = str(tmp_path / "base"), str(tmp_path / "snap")
        with _Served(state, tmp_path) as srv:
            with client_cls(0, path=srv.path) as client:
                client.quiesce()
                client.dump(base_d, hashes=True)
                client.resume()
                state["w"].add_(1.0)
                client.quiesce(dump_spec={"dir": d, "base": base_d})
                resp = client.dump(d, base=base_d)
                client.resume()
        assert resp["speculative"]["outcome"] == "validated"
        assert snapshot_delta_nbytes(d) == 0
        # The pass wrote only w; frozen references the rolling base.
        assert snapshot_delta_nbytes(d + SPEC_SUFFIX) == 64 * 4
        out = restore_snapshot(d, like=_like(state))
        assert torch.equal(out["w"], torch.arange(64.0) + 1.0)
        assert torch.equal(out["frozen"], torch.ones(1024))


# -- loud degrade to the parked dump -------------------------------------------------


def _boom(*args, **kwargs):
    raise RuntimeError("planted failure")


@pytest.mark.parametrize("failure", ["clone", "launch", "pass", "incomparable"])
def test_a_failed_speculation_degrades_loudly_and_bit_identically(
        tmp_path, monkeypatch, caplog, failure):
    """A boundary clone that raises, a launch that raises, a concurrent
    pass that fails, a state whose structure changed under the clone: the
    quiesce still parks, the dump says ``degraded`` with the error and a
    warning, and the snapshot is byte for byte the parked dump that
    speculation off writes."""
    state = {"w": torch.arange(32.0), "step": torch.tensor(5)}
    d, plain = str(tmp_path / "snap"), str(tmp_path / "plain")
    if failure == "clone":
        monkeypatch.setattr(pagentlet, "clone_generation", _boom)
    elif failure == "launch":
        monkeypatch.setattr(pagentlet, "start_speculative_dump", _boom)
    elif failure == "pass":
        real = psnap.write_snapshot

        def failing(directory, st, **kw):
            if kw.get("speculative"):
                raise OSError("planted: the spec volume is full")
            return real(directory, st, **kw)

        monkeypatch.setattr(psnap, "write_snapshot", failing)
    with _Served(state, tmp_path) as srv:
        with RefClient(0, path=srv.path) as client:
            with caplog.at_level(logging.WARNING, logger=pagentlet.log.name):
                client.quiesce(dump_spec={"dir": d})
                assert srv.agentlet.paused
                if failure == "incomparable":
                    state["extra"] = torch.zeros(2)
                resp = client.dump(d)
            monkeypatch.setenv("GRIT_SNAP_SPECULATE", "0")
            client.dump(plain)
            client.resume()
    spec = resp["speculative"]
    assert spec["outcome"] == "degraded"
    want = {"clone": "planted failure", "launch": "planted failure",
            "pass": "spec volume is full",
            "incomparable": "structurally incomparable"}[failure]
    assert want in spec["error"], spec
    assert any("degraded to the parked full path" in r.getMessage()
               for r in caplog.records)
    assert snapshot_delta_nbytes(d) == snapshot_nbytes(d) > 0
    assert _data(d) == _data(plain)
    assert SnapshotManifest.load(d).arrays == SnapshotManifest.load(plain).arrays


def test_a_pass_outliving_the_wait_bound_degrades(tmp_path, monkeypatch):
    """``GRIT_SNAP_SPECULATE_WAIT_S`` bounds the join: a pass still
    writing degrades to the parked dump (which waits for the pass's lock,
    then writes everything)."""
    monkeypatch.setenv("GRIT_SNAP_SPECULATE_WAIT_S", "0.3")
    gate = threading.Event()
    real = psnap.write_snapshot

    def slow(directory, st, **kw):
        if kw.get("speculative"):
            assert gate.wait(timeout=30)
        return real(directory, st, **kw)

    monkeypatch.setattr(psnap, "write_snapshot", slow)
    state = {"w": torch.arange(8.0)}
    d = str(tmp_path / "snap")
    with _Served(state, tmp_path) as srv:
        with RefClient(0, path=srv.path) as client:
            client.quiesce(dump_spec={"dir": d})
            threading.Timer(0.6, gate.set).start()
            resp = client.dump(d)
            client.resume()
    assert resp["speculative"]["outcome"] == "degraded"
    assert "wait bound" in resp["speculative"]["error"]
    assert snapshot_delta_nbytes(d) == snapshot_nbytes(d)
    assert torch.equal(restore_snapshot(d)["['w']"], torch.arange(8.0))


def test_speculate_off_knob_restores_parked_path(tmp_path, monkeypatch):
    """``GRIT_SNAP_SPECULATE=0``: the quiesce's dump spec is ignored,
    no ``speculative`` field, no ``-spec`` sibling."""
    monkeypatch.setenv("GRIT_SNAP_SPECULATE", "0")
    state = {"w": torch.arange(32.0)}
    d = str(tmp_path / "snap")
    with _Served(state, tmp_path) as srv:
        with RefClient(0, path=srv.path) as client:
            client.quiesce(dump_spec={"dir": d})
            resp = client.dump(d)
            client.resume()
    assert "speculative" not in resp
    assert not os.path.exists(d + SPEC_SUFFIX + psnap.WORK_SUFFIX)
    assert not snapshot_exists(d + SPEC_SUFFIX)
    assert snapshot_exists(d)


def test_an_unconsumed_pass_is_released_on_resume(tmp_path):
    """A quiesce whose dump never comes (the agent's error path resumes):
    the resume abandons the pass, and the next round starts clean."""
    state = {"w": torch.arange(16.0)}
    d = str(tmp_path / "snap")
    with _Served(state, tmp_path) as srv:
        with RefClient(0, path=srv.path) as client:
            client.quiesce(dump_spec={"dir": d})
            spec = srv.agentlet._speculative
            assert spec is not None and spec.join(30)
            client.resume()
            assert spec.clone is None and srv.agentlet._speculative is None
            client.quiesce()
            resp = client.dump(str(tmp_path / "plain"))
            client.resume()
    assert "speculative" not in resp


# -- the non-parking probe --------------------------------------------------------


class _SteppingLoop:
    """A loop that steps (in place) and counts its parks (``parks``: the
    agentlet's pre-park hook runs once before each)."""

    def __init__(self, tmp_path=None) -> None:
        self.state = {"w": torch.arange(16.0), "step": torch.tensor(0)}
        self.parks = 0
        path = {"path": str(tmp_path / "a.sock")} if tmp_path else {}
        self.agentlet = Agentlet(lambda: self.state,
                                 step_fn=lambda: int(self.state["step"]),
                                 pre_park_fn=self._count_park, **path).start()
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self) -> None:
        while not self._stop.is_set():
            self.state["w"].add_(1.0)
            self.state["step"].add_(1)
            self.agentlet.checkpoint_point()
            time.sleep(0.001)

    def _count_park(self) -> None:
        self.parks += 1

    @property
    def step(self) -> int:
        return int(self.state["step"])

    def close(self) -> None:
        self._stop.set()
        self._thread.join(timeout=10)
        self.agentlet.stop()
        assert not self._thread.is_alive()


@pytest.fixture
def slow_spec_write(monkeypatch):
    """Hold every speculative write at its start until ``gate`` is set, so
    a test can watch the loop step while the write is in flight."""
    gate, holding = threading.Event(), threading.Event()
    real = pagentlet.write_snapshot

    def slow(directory, state, **kw):
        if kw.get("speculative"):
            holding.set()
            assert gate.wait(timeout=30)
        return real(directory, state, **kw)

    monkeypatch.setattr(pagentlet, "write_snapshot", slow)
    return gate, holding


def test_probe_dump_never_parks_the_loop(tmp_path, slow_spec_write):
    """The standby probe: the loop steps through the whole write, never
    parks, and the committed probe holds the clone's step and bytes."""
    gate, holding = slow_spec_write
    lp = _SteppingLoop(tmp_path)
    d = str(tmp_path / "snap")
    try:
        box: dict = {}

        def probe():
            with RefClient(0, path=lp.agentlet.path) as c:
                box["resp"] = c.dump(d, hashes=True, speculative=True)

        t = threading.Thread(target=probe, daemon=True)
        t.start()
        assert holding.wait(timeout=30)
        before = lp.step
        deadline = time.monotonic() + 5
        while lp.step <= before + 3 and time.monotonic() < deadline:
            time.sleep(0.01)
        assert lp.step > before + 3  # stepping while the write is held
        gate.set()
        t.join(timeout=30)
        assert not t.is_alive()
    finally:
        lp.close()
    assert box["resp"]["speculative"] == {"outcome": "probe"}
    assert lp.parks == 0, "the probe parked the loop"
    meta_step = SnapshotManifest.load(d).meta["step"]
    got = restore_snapshot(d)
    assert int(got["['step']"]) == meta_step <= before
    assert torch.equal(got["['w']"], torch.arange(16.0) + meta_step)
    assert all("sha256" in c for rec in SnapshotManifest.load(d).arrays
               for c in rec["chunks"])


@pytest.mark.parametrize("hook_cls", [phook.TpuDeviceCheckpointHook, RefHook],
                         ids=["port_hook", "reference_hook"])
def test_hook_predump_probes_without_parking(tmp_path, monkeypatch,
                                             slow_spec_write, hook_cls):
    """Through the node agent's hook (the port's and the reference's): a
    predump on a speculating workload is the probe; the loop steps
    straight through it."""
    gate, holding = slow_spec_write
    monkeypatch.setenv("GRIT_TPU_SOCKET_DIR", str(tmp_path))
    lp = _SteppingLoop()
    try:
        def release():
            assert holding.wait(timeout=30)
            time.sleep(0.3)
            gate.set()

        threading.Thread(target=release, daemon=True).start()
        before = lp.step
        hook_cls(timeout=30.0).predump(os.getpid(), str(tmp_path / "round"))
        assert lp.step > before + 3, "the loop did not step through the probe"
    finally:
        lp.close()
    assert lp.parks == 0, "the predump parked the loop"
    assert snapshot_exists(str(tmp_path / "round" / HBM_SUBDIR))


def test_failed_probe_falls_back_loudly_to_the_parked_pass(
        tmp_path, monkeypatch, caplog):
    """A probe whose boundary clone fails: the port's hook warns and runs
    the parked pass, which commits the same hashed layout."""
    monkeypatch.setenv("GRIT_TPU_SOCKET_DIR", str(tmp_path))
    monkeypatch.setattr(pagentlet, "clone_generation", _boom)
    lp = _SteppingLoop()
    try:
        with caplog.at_level(logging.WARNING, logger=phook.log.name):
            phook.TpuDeviceCheckpointHook(timeout=30).predump(
                os.getpid(), str(tmp_path / "round"))
    finally:
        lp.close()
    fell_back = [r.getMessage() for r in caplog.records
                 if "speculative predump probe failed" in r.getMessage()]
    assert len(fell_back) == 1 and "planted failure" in fell_back[0]
    assert lp.parks == 1  # the fallback's parked pass
    snap = str(tmp_path / "round" / HBM_SUBDIR)
    assert all("sha256" in c for rec in SnapshotManifest.load(snap).arrays
               for c in rec["chunks"])


def test_probe_of_a_parked_loop_clones_on_the_dispatch_thread(tmp_path):
    state = {"w": torch.arange(8.0)}
    with _Served(state, tmp_path) as srv:
        with ToggleClient(0, path=srv.path) as client:
            client.quiesce()
            resp = client.dump(str(tmp_path / "p"), speculative=True)
            client.resume()
    assert resp["speculative"] == {"outcome": "probe"}
    assert torch.equal(restore_snapshot(str(tmp_path / "p"))["['w']"],
                       torch.arange(8.0))


# -- the writer's pieces -------------------------------------------------------------


def test_clean_names_reference_the_base_without_device_reads(tmp_path,
                                                             monkeypatch):
    """``write_snapshot(clean_names=)`` never reads a clean leaf; a clean
    name the base lacks falls through to the read-and-compare path."""
    base = str(tmp_path / "base")
    state = {"a": torch.arange(10.0), "b": torch.ones(5), "c": torch.zeros(3)}
    write_snapshot(base, {k: v for k, v in state.items() if k != "c"},
                   hashes=True)
    read: list = []
    real = psnap._DeviceToHost.pieces

    def spy(self, t):
        read.append(t.data_ptr())
        return real(self, t)

    monkeypatch.setattr(psnap._DeviceToHost, "pieces", spy)
    d = str(tmp_path / "snap")
    write_snapshot(d, state, base=base,
                   clean_names=frozenset({"['a']", "['c']"}))
    ptrs = {k: v.data_ptr() for k, v in state.items()}
    assert ptrs["a"] not in read
    assert ptrs["b"] in read and ptrs["c"] in read  # b compared, c written
    chunks = {r["name"]: r["chunks"][0] for r in SnapshotManifest.load(d).arrays}
    assert chunks["['a']"]["ref_dir"] == "../base"
    assert chunks["['b']"]["ref_dir"] == "../base"
    assert not chunks["['c']"].get("ref_dir")
    got = restore_snapshot(d, like=_like(state))
    for k in state:
        assert torch.equal(got[k], state[k])


def test_speculative_pass_skips_the_kernel_carry(tmp_path, monkeypatch):
    cache = str(tmp_path / "cache")
    os.makedirs(cache)
    for stem in build.SOURCES:
        with open(os.path.join(cache, build.library_path(stem).name), "wb") as f:
            f.write(b"\x7fELF library")
    monkeypatch.setenv("GRIT_TPU_COMPILE_CACHE", cache)
    spec, parked = str(tmp_path / "spec"), str(tmp_path / "parked")
    write_snapshot(spec, {"w": torch.ones(3)}, speculative=True)
    write_snapshot(parked, {"w": torch.ones(3)})
    assert not os.path.exists(os.path.join(spec, build.COMPILE_CACHE_SUBDIR))
    assert len(os.listdir(os.path.join(parked, build.COMPILE_CACHE_SUBDIR))) \
        == len(build.SOURCES)


def test_speculative_dump_handle(tmp_path):
    """``start_speculative_dump``: clones (a callable through
    ``clone_live_generation``), commits ``<dir>-spec`` with sha256 and a
    ``-spec`` mirror, holds the dump lock while writing, survives an early
    ``release``; a failing pass surfaces on ``error``."""
    state = {"w": torch.arange(6.0)}
    lock = threading.Lock()
    lock.acquire()
    d, mirror = str(tmp_path / "snap"), str(tmp_path / "pvc")
    h = psnap.start_speculative_dump(d, lambda: state, meta={"step": 7},
                                     mirror=mirror, dump_lock=lock)
    state["w"].add_(100.0)  # the clone was taken at the call
    h.release()  # the pass keeps its own reference
    assert not h.join(0.2)  # waiting for the lock
    lock.release()
    assert h.join(30) and h.ok and h.error is None and h.seconds > 0
    assert h.directory == d + SPEC_SUFFIX and h.final_dir == d
    assert snapshot_exists(mirror + SPEC_SUFFIX)
    assert SnapshotManifest.load(h.directory).meta == {"step": 7}
    assert torch.equal(restore_snapshot(h.directory)["['w']"], torch.arange(6.0))
    assert h.legs["speculative"] is True

    bad = psnap.start_speculative_dump(str(tmp_path / "bad"),
                                       {"w": torch.ones(2), "x": object()})
    assert bad.join(30) and not bad.ok and bad.error is not None


def test_clone_generation_copies_tensors_and_passes_the_rest():
    w = torch.arange(12.0).reshape(3, 4).t()  # not contiguous
    state = {"w": w, "n": 3, "cfg": object()}
    clone = clone_generation(state)
    assert clone["n"] == 3 and clone["cfg"] is state["cfg"]
    assert torch.equal(clone["w"], w) and clone["w"].is_contiguous()
    w.add_(1.0)
    assert torch.equal(clone["w"], torch.arange(12.0).reshape(3, 4).t())
    live = clone_live_generation(lambda: state)
    assert torch.equal(live["w"], w)
    with pytest.raises(RuntimeError, match="planted"):
        clone_live_generation(_boom)


# -- validation parity with the reference -------------------------------------------


def _bf16(x) -> tuple:
    a = np.asarray(x, np.float32).astype(ml_dtypes.bfloat16)
    return a, torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)


def _pair(kind: str):
    """(reference state, its clone, port state, its clone) built from the
    same numpy arrays."""
    rng = np.random.default_rng(0)
    base = {"w": rng.standard_normal((4, 8)).astype(np.float32),
            "ids": rng.integers(0, 9, (6,)).astype(np.int32),
            "mask": rng.random(5) > 0.5,
            "h": rng.standard_normal(7)}
    live = {k: v.copy() for k, v in base.items()}
    if kind == "one_changed":
        live["w"][1, 2] += 1.0
    elif kind == "all_changed":
        live = {"w": base["w"] + 1, "ids": base["ids"] + 1,
                "mask": ~base["mask"], "h": base["h"] * 2}
    elif kind == "nan_identical":
        base["w"][0, 0] = np.nan
        live["w"][0, 0] = np.nan
    elif kind == "shape":
        live["w"] = live["w"].reshape(8, 4)
    elif kind == "dtype":
        live["w"] = live["w"].astype(np.float16)
    elif kind == "tree":
        live["extra"] = np.zeros(2, np.float32)
    elif kind == "neg_zero":
        base["w"][0, 0] = 0.0
        live["w"][0, 0] = -0.0
    ref = tuple({k: jnp.asarray(v) for k, v in t.items()} for t in (live, base))
    port = tuple({k: torch.from_numpy(np.array(v)) for k, v in t.items()}
                 for t in (live, base))
    return (*ref, *port)


@pytest.mark.parametrize("kind", ["identical", "one_changed", "all_changed",
                                  "shape", "dtype", "tree"])
def test_validated_clean_names_matches_the_reference(kind):
    r_state, r_clone, p_state, p_clone = _pair(kind)
    want = rsnap.validated_clean_names(r_state, r_clone)
    got = psnap.validated_clean_names(p_state, p_clone)
    assert got == want
    if kind in ("shape", "dtype", "tree"):
        assert got is None


def test_validated_clean_names_compares_bytes():
    """Where the two differ, by design: the port compares bytes, so a
    planted -0.0 where the clone holds +0.0 is dirty (the reference's value
    equality calls it clean and would re-ship stale bytes), and a NaN with
    identical bytes is clean (the reference calls it dirty, which is only
    slower). bf16 leaves compare through int16."""
    r_state, r_clone, p_state, p_clone = _pair("neg_zero")
    assert "['w']" in rsnap.validated_clean_names(r_state, r_clone)
    assert "['w']" not in psnap.validated_clean_names(p_state, p_clone)
    r_state, r_clone, p_state, p_clone = _pair("nan_identical")
    assert "['w']" not in rsnap.validated_clean_names(r_state, r_clone)
    assert "['w']" in psnap.validated_clean_names(p_state, p_clone)
    (ra, pa), (rb, pb) = _bf16([0.0, 1.5]), _bf16([-0.0, 1.5])
    assert rsnap.validated_clean_names({"x": jnp.asarray(ra)},
                                       {"x": jnp.asarray(rb)}) == {"['x']"}
    assert psnap.validated_clean_names({"x": pa}, {"x": pb}) == set()
    assert psnap.validated_clean_names({"x": pa, "n": 3},
                                       {"x": pa.clone(), "n": 3}) \
        == {"['x']", "['n']"}


# -- a speculative dump racing live in-place steps ------------------------------------


def _mnist_trainer():
    from grit_tpu_torch.workload import mnist_trainer  # noqa: PLC0415

    return mnist_trainer(device="cpu")


def _llama_trainer():
    from grit_tpu_torch.models import llama  # noqa: PLC0415
    from grit_tpu_torch.workload import llama_trainer  # noqa: PLC0415

    cfg = llama.LlamaConfig.tiny(param_dtype=torch.float32,
                                 dtype=torch.float32)
    return llama_trainer(cfg, batch=2, seq=32, device="cpu")


@pytest.mark.parametrize("make", [_mnist_trainer, _llama_trainer],
                         ids=["mnist", "llama_adam"])
def test_speculative_dump_racing_live_steps_bit_identical(tmp_path, make):
    """The clone is harvested at a live step boundary while Adam updates
    the parameters in place; the pass races the steps that follow, the
    park validates it, and a fresh Trainer restored from the snapshot
    continues with the source's losses bit for bit."""
    tr = make()
    tr.run(2)
    step_loss: dict = {}
    cur = [tr.step]
    stop = threading.Event()
    path, d = str(tmp_path / "a.sock"), str(tmp_path / "snap")
    with Agentlet(lambda: tr.state, step_fn=lambda: tr.step,
                  path=path) as agentlet:

        def loop():
            while not stop.is_set():
                (loss,) = tr.run(1)
                step_loss[tr.step] = loss
                cur[0] = tr.step
                agentlet.checkpoint_point()

        t = threading.Thread(target=loop, daemon=True)
        t.start()
        try:
            with RefClient(0, path=path, timeout=120) as client:
                client.quiesce(dump_spec={"dir": d})
                resp = client.dump(d)
                client.resume()
            spec = resp["speculative"]
            assert spec["outcome"] == "validated", spec
            cut = SnapshotManifest.load(d).meta["step"]
            deadline = time.time() + 120
            while cur[0] < cut + 4 and time.time() < deadline:
                time.sleep(0.01)
        finally:
            stop.set()
            t.join(timeout=60)
    assert not t.is_alive() and cur[0] >= cut + 4
    cont = [step_loss[s] for s in range(cut + 1, cut + 5)]
    tr2 = make()
    assert tr2.restore(d) == cut
    assert tr2.run(4) == cont, "the restored trajectory diverged"


# -- the serving agentlet ---------------------------------------------------------


def test_serving_agentlet_speculates_on_the_tagged_state(tmp_path):
    """``ServingAgentlet`` inherits speculation; its clone reads the tagged
    state its dumps read, and the validated snapshot restores into an
    engine that continues bit-identically."""
    from grit_tpu_torch.models import llama  # noqa: PLC0415
    from grit_tpu_torch.models.serving import (  # noqa: PLC0415
        BatchingConfig,
        ContinuousBatchingEngine,
    )
    from grit_tpu_torch.serving import ServingAgentlet  # noqa: PLC0415

    cfg = llama.LlamaConfig.tiny(dtype=torch.float32)
    params = llama.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    bcfg = BatchingConfig(n_slots=3, max_seq_len=128, temperature=1.0)

    def engine():
        return ContinuousBatchingEngine(cfg, params, bcfg, device="cpu")

    adapter = ServingAgentlet(engine(), path=str(tmp_path / "s.sock"))
    d = str(tmp_path / "snap")
    tokens: list = []
    stop = threading.Event()
    with adapter:
        slot = adapter.submit([3, 17, 42, 7])

        def serve():
            while not stop.is_set():
                tokens.append(adapter.step())
                adapter.batch_boundary()

        t = threading.Thread(target=serve, daemon=True)
        t.start()
        try:
            with RefClient(0, path=adapter.agentlet.path) as client:
                cut = client.quiesce(dump_spec={"dir": d})
                resp = client.dump(d)
                want = [adapter.engine.step() for _ in range(3)]
                client.resume()
        finally:
            stop.set()
            t.join(timeout=30)
    assert not t.is_alive()
    assert resp["speculative"]["outcome"] == "validated", resp
    assert SnapshotManifest.load(d).meta["step"] == cut
    dst = engine()
    dst.restore(d)
    assert [dst.step() for _ in range(3)] == want
    assert slot in want[0]
