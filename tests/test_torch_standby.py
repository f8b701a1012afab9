"""The reference agent's preemption-armed standby over the port's hook.

``grit_tpu.agent.standby.run_standby_checkpoint`` runs unchanged with the
port's ``AutoDeviceHook`` against a live port workload (the tiny llama
fine-tuned with ``--optimizer frozen-trunk``), in both probe modes: the
non-parking speculative probe (``GRIT_SNAP_SPECULATE=1``) and the
momentary-quiesce probe (``=0``). Every case of the reference's
``TestStandbyLoop`` and ``TestStandbyFaultPoints``
(``tests/test_standby.py``, whose hook is a fake that writes snapshot
files) has a twin here over the real workload. Beyond those: a base the
agent has flattened (``grit_tpu.deltachain``: ``base``/``dirty`` dropped,
``data-h0000.r<k>.bin`` names, a stale index) restores bitwise through the
port's blocking, post-copy and prefetched restores and through the JAX
package, and merges as a leg; a rebase's renamed files restore; a
frozen-trunk governed round ships only the trainable leaves; and the twins
of the reference's two end-to-end cases: a fired standby migrates
bit-identically, and a SIGKILL mid-standby restores from the last
flattened base.

One live workload serves the loop's cases (each with its own work and PVC
dirs; a fired case leaves it parked, and the fixture resumes it); the
end-to-end cases spawn their own sources, beside one uninterrupted run.
"""

from __future__ import annotations

import hashlib
import json
import os
import re
import subprocess
import sys
import textwrap
import threading
import time

import numpy as np
import pytest

from grit_tpu import deltachain, faults
from grit_tpu.agent import standby as standby_mod
from grit_tpu.agent.checkpoint import CheckpointOptions
from grit_tpu.agent.standby import (
    STANDBY_PHASE,
    FireSignal,
    run_standby_checkpoint,
    write_fire_file,
)
from grit_tpu.device import snapshot as jsnap
from grit_tpu.harness import MigrationHarness, read_losses
from grit_tpu.obs import flight, progress
from grit_tpu_torch import prefetch
from grit_tpu_torch.device import hook as phook
from grit_tpu_torch.device import snapshot as psnap
from grit_tpu_torch.device.agentlet import ToggleClient, socket_path
from grit_tpu_torch.tree import flatten_with_names
from tests.test_torch_agentlet import REPO

HBM = phook.HBM_SUBDIR

# The tiny llama fine-tuned with a frozen trunk: only lm_head and the final
# norm train, so every step dirties those leaves and the step counter.
FROZEN_WORKLOAD = textwrap.dedent("""
    import runpy, sys
    import torch
    torch.set_num_threads(1)  # several test workers share a few cores
    sys.path.insert(0, {repo!r})
    sys.argv = ["grit_tpu_torch.workload", "--config", "tiny", "--device",
                "cpu", "--seq", "128", "--batch", "2", "--optimizer",
                "frozen-trunk"]
    runpy.run_module("grit_tpu_torch.workload", run_name="__main__")
""").format(repo=REPO)

TRAINABLE = ("['params']['lm_head']", "['params']['final_norm']", "['step']")


def _trainable_nbytes(hbm: str) -> int:
    manifest = psnap.SnapshotManifest.load(hbm)
    return sum(int(c["nbytes"]) for rec in manifest.arrays
               if rec["name"] in TRAINABLE for c in rec["chunks"])


@pytest.fixture(params=["speculative", "parked"])
def probe_mode(request, monkeypatch):
    """The probe mode the standby's governed rounds run in: the hook's
    non-parking probe, or the momentary quiesce of
    ``GRIT_SNAP_SPECULATE=0``."""
    monkeypatch.setenv("GRIT_SNAP_SPECULATE",
                       "1" if request.param == "speculative" else "0")
    return request.param


class _Live:
    """A port workload training on, its stdout drained on a thread (the
    last step it printed in ``step``)."""

    def __init__(self, base: str) -> None:
        self.h = MigrationHarness(base, workload_src=FROZEN_WORKLOAD)
        # The workload serves both probe modes: the probe is the agent's
        # choice, and the speculative one needs the workload's knob on.
        self.proc = self.h.spawn(n_steps=10**7,
                                 extra_env={"GRIT_SNAP_SPECULATE": "1"})
        self.h.wait_ready(self.proc)
        self.h.wait_until_step(self.proc, 3)
        self.step = 3
        threading.Thread(target=self._drain, daemon=True).start()

    def _drain(self) -> None:
        for line in self.proc.stdout:
            if line.startswith("STEP "):
                self.step = int(line.split()[1])

    @property
    def pid(self) -> int:
        return self.proc.pid

    def client(self) -> ToggleClient:
        return ToggleClient(0, path=os.path.join(
            self.h.sockdir, os.path.basename(socket_path(self.pid))),
            timeout=120)

    def resume_if_parked(self) -> None:
        with self.client() as c:
            if c.status()["paused"]:
                c.resume()

    def assert_trains_on(self, timeout: float = 60.0) -> None:
        """The workload's step advances by two: it is not parked. (The
        status's ``paused`` can still read True for a moment after a
        resume, until the loop thread wakes.)"""
        start = self.step
        deadline = time.monotonic() + timeout
        while self.step <= start + 1:
            assert self.proc.poll() is None, "the workload died"
            assert time.monotonic() < deadline, "the workload stopped training"
            time.sleep(0.02)


@pytest.fixture(scope="module")
def live(tmp_path_factory):
    lv = _Live(str(tmp_path_factory.mktemp("live")))
    yield lv
    lv.proc.kill()
    lv.proc.wait()


@pytest.fixture
def node(live, tmp_path, monkeypatch):
    """The live workload as a pod on a fake runtime, and the options of
    one standby checkpoint (its own work and PVC dirs). Leaves the
    workload running."""
    monkeypatch.setenv("GRIT_TPU_SOCKET_DIR", live.h.sockdir)
    monkeypatch.delenv(faults.FAULT_POINTS_ENV, raising=False)
    faults.reset()
    rt = live.h.make_source_runtime(live.pid)
    opts = CheckpointOptions(
        pod_name=live.h.pod, pod_namespace=live.h.namespace, pod_uid="uid1",
        work_dir=str(tmp_path / "work"), dst_dir=str(tmp_path / "pvc"),
        pre_copy=True, leave_running=False)
    yield rt, opts
    monkeypatch.delenv(faults.FAULT_POINTS_ENV, raising=False)
    faults.reset()
    live.resume_if_parked()


def _hook():
    return phook.AutoDeviceHook(timeout=120)


def _fast_knobs(monkeypatch, min_i="0.01", max_i="0.1", min_delta="0.0001"):
    monkeypatch.setenv("GRIT_STANDBY_MIN_INTERVAL_S", min_i)
    monkeypatch.setenv("GRIT_STANDBY_MAX_INTERVAL_S", max_i)
    monkeypatch.setenv("GRIT_STANDBY_MIN_DELTA_MB", min_delta)
    monkeypatch.setenv("GRIT_STANDBY_FIRE_POLL_S", "0.01")


class FireAfterRounds:
    """Fires once the loop's info dict records ``n`` shipped rounds."""

    def __init__(self, n, info, reason="test-fire"):
        self.n = n
        self.info = info
        self.reason = reason
        self._fired = None

    def check(self):
        if self._fired is None and \
                self.info.get("rounds_shipped", 0) >= self.n:
            self._fired = self.reason
        return self._fired


@pytest.fixture
def responses(monkeypatch):
    """Every dump request the port's hook sends, with its response, and
    the quiesces it sends (``("quiesce", None)``)."""
    seen: list = []
    dump, quiesce = ToggleClient.dump, ToggleClient.quiesce

    def spy_dump(self, directory, *args, **kw):
        resp = dump(self, directory, *args, **kw)
        seen.append(("dump", dict(kw, dir=directory), resp))
        return resp

    def spy_quiesce(self, *args, **kw):
        seen.append(("quiesce", kw, None))
        return quiesce(self, *args, **kw)

    monkeypatch.setattr(ToggleClient, "dump", spy_dump)
    monkeypatch.setattr(ToggleClient, "quiesce", spy_quiesce)
    return seen


def _pvc_base(opts) -> str:
    return os.path.join(opts.dst_dir, "main-precopy", HBM)


def _leaf_bytes(tree: dict) -> dict:
    out = {}
    for name, t in tree.items():
        arr = t.detach().cpu().numpy() if hasattr(t, "detach") \
            else np.asarray(t)
        out[name] = arr
    return out


def _nested(flat: dict) -> dict:
    """``{"['a']['b']": x}`` → ``{"a": {"b": x}}`` (the workload's state is
    nested dicts)."""
    out: dict = {}
    for name, leaf in flat.items():
        keys = re.findall(r"\['([^']*)'\]", name)
        node = out
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        node[keys[-1]] = leaf
    return out


def _assert_restores_alike(directory: str) -> dict:
    """The port's restore and the JAX package's give the same leaves, byte
    for byte (the JAX package reads an int64 leaf as int32: by value);
    returns the port's."""
    port = _leaf_bytes(psnap.restore_snapshot(directory))
    ref = _leaf_bytes(jsnap.restore_snapshot(directory))
    assert set(port) == set(ref)
    for name, a in port.items():
        b = ref[name]
        if a.dtype == np.int64:
            assert a.tolist() == b.tolist(), name
        else:
            assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), name
    return port


# -- twins of the reference's TestStandbyLoop --------------------------------------


class TestStandbyLoop:
    def test_arm_governed_rounds_then_fire_ships_only_final_delta(
            self, node, probe_mode, monkeypatch, responses):
        from grit_tpu.agent.lease import HeartbeatLease

        rt, opts = node
        _fast_knobs(monkeypatch)
        monkeypatch.setenv("GRIT_FLIGHT", "1")
        info: dict = {}
        beats = []
        lease = HeartbeatLease(lambda ts: beats.append(ts))
        fire = FireAfterRounds(4, info)  # round 0 + 3 governed ships
        stats = run_standby_checkpoint(rt, opts, _hook(), fire=fire,
                                       lease=lease, info=info)
        assert stats is not None
        assert info["probe_mode"] == probe_mode
        assert info["fired"] == "test-fire"
        assert info["rounds_shipped"] >= 4
        assert info["staleness_at_fire_s"] >= 0.0
        assert len(beats) >= info["rounds_shipped"]

        base, final = _pvc_base(opts), os.path.join(opts.dst_dir, "main", HBM)
        # A flat warm base and a final delta that resolves against it.
        assert deltachain.chain_depth(base) == 0
        assert deltachain.chain_depth(final) == 1
        # Only the trainable leaves rode the blackout: the final delta
        # holds at most their bytes, out of the whole tree.
        trainable = _trainable_nbytes(base)
        assert 0 < deltachain.manifest_physical_nbytes(final) <= trainable
        assert psnap.snapshot_nbytes(final) == psnap.snapshot_nbytes(base)
        # The probes: non-parking in the speculative mode (no quiesce
        # before the fire's), momentary quiesces in the parked mode.
        dumps = [(kw, r) for op, kw, r in responses if op == "dump"]
        probes = [(kw, r) for kw, r in dumps if kw.get("hashes")]
        quiesces = [i for i, (op, _, _) in enumerate(responses)
                    if op == "quiesce"]
        assert len(probes) >= 4
        if probe_mode == "speculative":
            assert all(r.get("speculative", {}).get("outcome") == "probe"
                       for _, r in probes)
            assert len(quiesces) == 1  # the fire's
            # The blackout dump validated its -spec sibling against the
            # base the loop flattened several times.
            kw, resp = dumps[-1]
            assert resp["speculative"]["outcome"] == "validated", resp
            spec = json.load(open(final + psnap.SPEC_SUFFIX + "/" +
                                  psnap.MANIFEST_FILE))
            assert spec["base"] == os.path.join("..", "..", "main-precopy",
                                                HBM)
        else:
            assert len(quiesces) == len(probes) + 1
        # Flight log: standby.round brackets + the standby.fire point.
        events = flight.read_flight_file(
            os.path.join(opts.work_dir, flight.FLIGHT_LOG_FILE))
        evs = [e["ev"] for e in events]
        assert "standby.round.start" in evs
        assert "standby.round.end" in evs
        fire_ev = [e for e in events if e.get("ev") == "standby.fire"][0]
        assert fire_ev["reason"] == "test-fire"
        assert "staleness_s" in fire_ev

    def test_quiet_workload_backs_off_and_never_ships(self, node, probe_mode,
                                                      monkeypatch):
        """Below the ship threshold (the tiny trunk's trainable slice is
        under 1 MB, the threshold here 100 MB) every probe is carried as
        backlog and nothing new reaches the destination."""
        rt, opts = node
        _fast_knobs(monkeypatch, min_delta="100.0")
        info: dict = {}
        res = run_standby_checkpoint(rt, opts, _hook(),
                                     fire=FireSignal(opts.work_dir),
                                     info=info, max_rounds=4)
        assert res is None  # disarmed by the round budget, never fired
        assert info["rounds_shipped"] == 1  # round 0 only
        assert info["rounds_skipped"] == 4
        assert info["fired"] is None
        names = {n for n in os.listdir(_pvc_base(opts))
                 if n.startswith("data-")}
        assert names == {psnap.DATA_FILE}

    def test_dirty_rate_denominator_is_time_since_shipped_base(
            self, node, probe_mode, monkeypatch):
        rt, opts = node
        _fast_knobs(monkeypatch, min_i="0.05", max_i="0.05",
                    min_delta="100.0")
        captured: list[float] = []
        real = standby_mod.standby_governor

        def spy(dirty_bytes, interval_s, link_bps, **kw):
            captured.append(interval_s)
            return real(dirty_bytes, interval_s, link_bps, **kw)

        monkeypatch.setattr(standby_mod, "standby_governor", spy)
        run_standby_checkpoint(rt, opts, _hook(),
                               fire=FireSignal(opts.work_dir), max_rounds=4)
        assert len(captured) == 4
        # Base-anchored: each round's interval runs from the round-0 base,
        # so it is the last one plus at least the cadence's wait (and the
        # probe in between); probe-anchored (the regression) they would
        # all read one wait and one probe. The reference's fake probe
        # costs nothing; this one costs the real dump, so the test holds
        # the increments, not a ratio to the first interval, which the
        # round-0 pass and a loaded host inflate.
        assert captured == sorted(captured)
        assert all(b - a >= 0.05 for a, b in zip(captured, captured[1:])), \
            captured

    def test_staleness_and_backlog_ride_progress_snapshot(
            self, node, probe_mode, monkeypatch):
        rt, opts = node
        _fast_knobs(monkeypatch, min_delta="100.0")  # nothing ships
        info: dict = {}
        run_standby_checkpoint(rt, opts, _hook(),
                               fire=FireSignal(opts.work_dir), info=info,
                               max_rounds=2)
        # Each probe found the trainable leaves dirty, below the 100 MB
        # threshold: carried as backlog.
        trainable = _trainable_nbytes(os.path.join(
            opts.work_dir, "main-precopy", HBM))
        assert info["backlog_bytes"] == trainable
        snap = progress.read_progress_file(
            os.path.join(opts.work_dir, ".grit-progress.json"))
        assert snap["phase"] == STANDBY_PHASE
        sb = snap["standby"]
        assert sb["backlogBytes"] == trainable
        assert sb["roundsShipped"] == 1
        assert sb["roundsSkipped"] >= 1
        assert sb["stalenessSeconds"] >= 0.0
        assert sb["tickAt"] > 0
        from grit_tpu.obs.metrics import (
            STANDBY_DELTA_BACKLOG_BYTES,
            STANDBY_STALENESS_SECONDS,
        )
        assert STANDBY_DELTA_BACKLOG_BYTES.value() == trainable
        assert STANDBY_STALENESS_SECONDS.value() >= 0.0

    def test_rebase_round_never_rewrites_dst_referenced_files(
            self, node, probe_mode, monkeypatch):
        rt, opts = node
        _fast_knobs(monkeypatch)
        info: dict = {}
        probes = {"n": 0}

        def bloat_second_round(o, r, f):
            probes["n"] += 1
            return probes["n"] == 2

        monkeypatch.setattr(standby_mod, "_base_bloat_exceeded",
                            bloat_second_round)
        dst_base = _pvc_base(opts)
        violations: list[str] = []
        real_ship = standby_mod._ship_round_ordered

        def checked_ship(o, shipped):
            before = {}
            if os.path.isfile(os.path.join(dst_base, "MANIFEST.json")):
                for nm in deltachain.referenced_files(dst_base):
                    with open(os.path.join(dst_base, nm), "rb") as f:
                        before[nm] = hashlib.md5(f.read()).hexdigest()
            out = real_ship(o, shipped)
            for nm, digest in before.items():
                p = os.path.join(dst_base, nm)
                if os.path.isfile(p):
                    with open(p, "rb") as f:
                        if hashlib.md5(f.read()).hexdigest() != digest:
                            violations.append(nm)
            return out

        monkeypatch.setattr(standby_mod, "_ship_round_ordered", checked_ship)
        run_standby_checkpoint(rt, opts, _hook(),
                               fire=FireSignal(opts.work_dir), info=info,
                               max_rounds=3)
        assert info["rebases"] == 1
        assert violations == [], violations
        assert deltachain.is_committed(dst_base)
        assert deltachain.chain_depth(dst_base) == 0
        for nm in deltachain.referenced_files(dst_base):
            assert os.path.isfile(os.path.join(dst_base, nm))
        _assert_restores_alike(dst_base)

    def test_stop_event_disarms_cleanly(self, node, probe_mode, monkeypatch):
        rt, opts = node
        _fast_knobs(monkeypatch, min_i="5", max_i="10")
        stop = threading.Event()
        box: dict = {}

        def run():
            box["res"] = run_standby_checkpoint(
                rt, opts, _hook(), fire=FireSignal(opts.work_dir), stop=stop)

        t = threading.Thread(target=run, daemon=True)
        t.start()
        deadline = time.monotonic() + 60.0
        while not os.path.isfile(os.path.join(opts.work_dir,
                                              ".grit-progress.json")):
            assert time.monotonic() < deadline
            time.sleep(0.02)
        stop.set()
        t.join(timeout=60.0)
        assert not t.is_alive()
        assert box["res"] is None

    def test_fire_file_fires_armed_loop(self, node, probe_mode, monkeypatch):
        rt, opts = node
        _fast_knobs(monkeypatch, min_i="60", max_i="60")  # park idle-armed
        os.makedirs(opts.work_dir, exist_ok=True)
        info: dict = {}
        box: dict = {}

        def run():
            box["stats"] = run_standby_checkpoint(
                rt, opts, _hook(), fire=FireSignal(opts.work_dir), info=info)

        t = threading.Thread(target=run, daemon=True)
        t.start()
        deadline = time.monotonic() + 60.0
        while info.get("rounds_shipped", 0) < 1:
            assert time.monotonic() < deadline, info
            time.sleep(0.02)
        write_fire_file(opts.work_dir, "NodeReclaim:taint")
        t.join(timeout=60.0)
        assert not t.is_alive()
        assert box["stats"] is not None
        assert info["fired"] == "NodeReclaim:taint"
        assert psnap.snapshot_exists(os.path.join(opts.dst_dir, "main", HBM))


# -- twins of the reference's TestStandbyFaultPoints -------------------------------


class TestStandbyFaultPoints:
    def test_standby_round_fault_fails_arm_loudly(self, node, live,
                                                  probe_mode, monkeypatch):
        rt, opts = node
        monkeypatch.setenv(faults.FAULT_POINTS_ENV, "standby.round:raise")
        faults.reset()
        with pytest.raises(faults.FaultInjected):
            run_standby_checkpoint(rt, opts, _hook(),
                                   fire=FireSignal(opts.work_dir))
        assert faults.hits("standby.round") == 1
        live.assert_trains_on()

    def test_standby_governor_fault_raises_out_of_armed_loop(
            self, node, live, probe_mode, monkeypatch):
        rt, opts = node
        _fast_knobs(monkeypatch)
        info: dict = {}

        class ArmThenFault(FireSignal):
            def check(self):
                if info.get("rounds_shipped", 0) >= 1 and \
                        not os.environ.get(faults.FAULT_POINTS_ENV):
                    monkeypatch.setenv(faults.FAULT_POINTS_ENV,
                                       "standby.governor:raise")
                return super().check()

        with pytest.raises(faults.FaultInjected):
            run_standby_checkpoint(rt, opts, _hook(),
                                   fire=ArmThenFault(opts.work_dir),
                                   info=info)
        assert faults.hits("standby.governor") >= 1
        # The probe before the governor left the workload training, and
        # the warm base stands.
        live.assert_trains_on()
        assert deltachain.is_committed(_pvc_base(opts))

    def test_standby_fire_fault_fails_the_fire_path(self, node, live,
                                                    probe_mode, monkeypatch):
        rt, opts = node
        _fast_knobs(monkeypatch)
        monkeypatch.setenv(faults.FAULT_POINTS_ENV, "standby.fire:raise")
        faults.reset()
        os.makedirs(opts.work_dir, exist_ok=True)
        write_fire_file(opts.work_dir, "pre-armed-fire")
        with pytest.raises(faults.FaultInjected):
            run_standby_checkpoint(rt, opts, _hook(),
                                   fire=FireSignal(opts.work_dir))
        assert faults.hits("standby.fire") == 1
        live.assert_trains_on()  # the fault struck before the blackout

    def test_standby_chaos_round_fault_leaves_base_warm(
            self, node, live, probe_mode, monkeypatch):
        rt, opts = node
        _fast_knobs(monkeypatch)
        info: dict = {}

        class FaultAfterShips(FireSignal):
            def check(self):
                if info.get("rounds_shipped", 0) >= 3 and \
                        not os.environ.get(faults.FAULT_POINTS_ENV):
                    monkeypatch.setenv(faults.FAULT_POINTS_ENV,
                                       "standby.round:raise")
                return super().check()

        with pytest.raises(faults.FaultInjected):
            run_standby_checkpoint(rt, opts, _hook(),
                                   fire=FaultAfterShips(opts.work_dir),
                                   info=info)
        assert info["rounds_shipped"] >= 3
        base = _pvc_base(opts)
        assert deltachain.is_committed(base)
        assert deltachain.chain_depth(base) == 0
        for name in deltachain.referenced_files(base):
            assert os.path.isfile(os.path.join(base, name))
        # Restorable as it stands, and the workload trains on.
        _assert_restores_alike(base)
        live.assert_trains_on()


# -- what the reference's fake hook cannot show ------------------------------------


def test_a_failed_round_resumes_the_workload(node, live, probe_mode,
                                             monkeypatch):
    """A governed round whose dump fails raises out of the loop, loudly;
    the probe's parked fallback resumed the workload (``hook.py``'s
    ``finally``), so it trains on, and the warm base stands."""
    rt, opts = node
    _fast_knobs(monkeypatch)
    info: dict = {}
    dump = ToggleClient.dump

    def failing(self, directory, *args, base=None, **kw):
        if base is not None:  # a governed round's delta
            raise RuntimeError("agentlet dump failed: planted")
        return dump(self, directory, *args, base=base, **kw)

    monkeypatch.setattr(ToggleClient, "dump", failing)
    with pytest.raises(RuntimeError, match="planted"):
        run_standby_checkpoint(rt, opts, _hook(),
                               fire=FireSignal(opts.work_dir), info=info)
    assert info["rounds_shipped"] == 1
    live.assert_trains_on()
    assert deltachain.is_committed(_pvc_base(opts))


def test_flattened_base_restores_everywhere_bitwise(node, probe_mode,
                                                    monkeypatch):
    """A base the agent flattened over several shipped rounds (no
    ``base``/``dirty`` keys, ``.r<k>`` data files, the round-0 index left
    stale) restores byte for byte through the port's blocking restore, its
    post-copy restore, after its prefetch, and through the JAX package;
    its sizes read as the tree's; and it merges as one process's leg."""
    rt, opts = node
    _fast_knobs(monkeypatch)
    info: dict = {}
    run_standby_checkpoint(rt, opts, _hook(), fire=FireSignal(opts.work_dir),
                           info=info, max_rounds=3)
    assert info["rounds_shipped"] == 4
    for base in (os.path.join(opts.work_dir, "main-precopy", HBM),
                 _pvc_base(opts)):
        raw = json.load(open(os.path.join(base, psnap.MANIFEST_FILE)))
        assert set(raw) == {"format", "process_count", "meta", "arrays"}
        files = {c["file"] for r in raw["arrays"] for c in r["chunks"]}
        assert any(".r" in f for f in files) and \
            all(psnap.data_file_process(f) == 0 for f in files)
        index = json.load(open(os.path.join(base, psnap.INDEX_FILE)))
        assert {c["file"] for r in index for c in r["chunks"]} == \
            {psnap.DATA_FILE}  # stale: the round-0 dump's

        want = _assert_restores_alike(base)
        assert psnap.snapshot_nbytes(base) == sum(a.nbytes
                                                  for a in want.values())
        assert psnap.snapshot_delta_nbytes(base) == \
            deltachain.manifest_physical_nbytes(base)

        monkeypatch.setenv("GRIT_RESTORE_POSTCOPY_HOT_MB", "0.001")
        like = _nested(psnap.restore_snapshot(base))
        got = dict(flatten_with_names(psnap.restore_snapshot_postcopy(
            base, like=like, device="cpu").wait()))
        assert {n: a.tobytes() for n, a in _leaf_bytes(got).items()} == \
            {n: a.tobytes() for n, a in want.items()}

        warmed: list[str] = []
        monkeypatch.setattr(prefetch, "_warm_file", warmed.append)
        t = prefetch.start_restore_prefetch(base)
        t.join(timeout=30)
        assert files <= {os.path.basename(p) for p in warmed}

    merged = str(os.path.join(opts.work_dir, "merged"))
    psnap.merge_legs(merged, [_pvc_base(opts)])
    got = _leaf_bytes(psnap.restore_snapshot(merged))
    assert {n: a.tobytes() for n, a in got.items()} == \
        {n: a.tobytes() for n, a in _leaf_bytes(
            psnap.restore_snapshot(_pvc_base(opts))).items()}


def test_rebase_rounds_leave_renamed_files_that_restore(node, probe_mode,
                                                        monkeypatch):
    """``GRIT_STANDBY_REBASE_FACTOR`` set low: the loop re-dumps the base
    whenever its disk bytes pass the tree's, and renames the fresh dump's
    files into the flatten namespace before the ship; the destination's
    base holds only renamed files and restores bitwise."""
    rt, opts = node
    _fast_knobs(monkeypatch)
    monkeypatch.setenv("GRIT_STANDBY_REBASE_FACTOR", "1.01")
    info: dict = {}
    run_standby_checkpoint(rt, opts, _hook(), fire=FireSignal(opts.work_dir),
                           info=info, max_rounds=4)
    assert info["rebases"] >= 1
    base = _pvc_base(opts)
    names = deltachain.referenced_files(base)
    assert names and all(".r" in n for n in names), names
    assert deltachain.chain_depth(base) == 0
    _assert_restores_alike(base)


def test_frozen_trunk_round_ships_only_the_trainable_leaves(
        node, probe_mode, monkeypatch):
    """Against a flattened base the next round's delta matches every
    frozen leaf by its sha256 in the folded chunks: each governed round
    ships the trainable leaves' bytes, not the tree's."""
    rt, opts = node
    _fast_knobs(monkeypatch)
    shipped: list[int] = []
    real_ship = standby_mod._ship_round_ordered

    def counted(o, prev):
        stats, state = real_ship(o, prev)
        shipped.append(stats.bytes)
        return stats, state

    monkeypatch.setattr(standby_mod, "_ship_round_ordered", counted)
    info: dict = {}
    run_standby_checkpoint(rt, opts, _hook(), fire=FireSignal(opts.work_dir),
                           info=info, max_rounds=4)
    base = _pvc_base(opts)
    trainable = _trainable_nbytes(base)
    full = psnap.snapshot_nbytes(base)
    assert info["round_deltas"][0] == full
    assert info["round_deltas"][1:] == [trainable] * 4
    assert trainable < full / 10
    # What each round's upload moved: the delta's data file plus the
    # manifests, never the frozen trunk.
    manifest_bytes = os.path.getsize(os.path.join(base, psnap.MANIFEST_FILE))
    assert len(shipped) == 4
    for n in shipped:
        assert trainable <= n <= trainable + 4 * manifest_bytes


# -- twins of the reference's end-to-end cases -------------------------------------

_REFERENCE: dict = {}


def _reference_losses(h: MigrationHarness, n: int) -> dict:
    """Losses of an uninterrupted run of at least ``n`` steps (one run
    serves every case that needs no more)."""
    if _REFERENCE.get("n", 0) < n:
        ref = h.spawn(n_steps=max(n, 2 * _REFERENCE.get("n", 0), 120))
        losses = read_losses(ref.stdout.read().splitlines())
        assert ref.wait() == 0
        _REFERENCE.update(n=len(losses), losses=losses)
    return _REFERENCE["losses"]


@pytest.fixture
def e2e(tmp_path, monkeypatch):
    """A fresh source, trained to step 3."""
    monkeypatch.setenv("GRIT_STANDBY_MIN_INTERVAL_S", "0.05")
    monkeypatch.setenv("GRIT_STANDBY_MAX_INTERVAL_S", "0.5")
    monkeypatch.setenv("GRIT_STANDBY_MIN_DELTA_MB", "0")
    monkeypatch.setenv("GRIT_STANDBY_FIRE_POLL_S", "0.05")
    h = MigrationHarness(str(tmp_path), workload_src=FROZEN_WORKLOAD)
    src = h.spawn(n_steps=10**7)
    try:
        yield h, src
    finally:
        src.kill()
        src.wait()


def _continues_bitwise(h: MigrationHarness, env: dict, cut: int) -> None:
    ref = _reference_losses(h, cut + 3)
    dst = h.spawn(extra_env=env, n_steps=cut + 3, cache="dst")
    out = dst.stdout.read().splitlines()
    assert dst.wait() == 0
    assert f"RESTORED {cut}" in out
    got = read_losses(out)
    assert set(got) == {cut + 1, cut + 2, cut + 3}
    for s, loss in got.items():
        assert loss == ref[s], (s, loss, ref[s])


def _wait_rounds_shipped(work_dir, n, proc=None, timeout=120.0) -> dict:
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if proc is not None and proc.poll() is not None:
            raise AssertionError(
                f"standby driver exited rc={proc.returncode}: "
                f"{proc.stderr.read() if proc.stderr else ''}")
        snap = progress.read_progress_file(
            os.path.join(work_dir, ".grit-progress.json"))
        if snap is not None and snap.get("phase") == STANDBY_PHASE and \
                snap.get("standby", {}).get("roundsShipped", 0) >= n:
            return snap["standby"]
        time.sleep(0.05)
    raise AssertionError(f"standby never shipped {n} rounds in {timeout}s")


def test_standby_fire_migrates_bit_identical(e2e, probe_mode, monkeypatch):
    """An armed standby fired by the ``.grit-fire`` vehicle pays only the
    final delta, and the restored process continues bit-identically from
    the fire cut."""
    h, src = e2e
    h.wait_ready(src)
    h.wait_until_step(src, 3)
    threading.Thread(target=lambda: src.stdout.read(), daemon=True).start()
    monkeypatch.setenv("GRIT_TPU_SOCKET_DIR", h.sockdir)
    box: dict = {}
    info: dict = {}

    def run():
        try:
            box["res"] = run_standby_checkpoint(
                h.make_source_runtime(src.pid), h._ckpt_opts(pre_copy=True),
                _hook(), fire=FireSignal(h.host_work), info=info)
        except BaseException as exc:  # noqa: BLE001 — surfaced below
            box["exc"] = exc

    t = threading.Thread(target=run, daemon=True)
    t.start()
    _wait_rounds_shipped(h.host_work, 3)
    write_fire_file(h.host_work, "test-preempt")
    t.join(timeout=120)
    assert not t.is_alive() and "exc" not in box, box
    assert box["res"] is not None and info["fired"] == "test-preempt"
    src.kill()
    src.wait()

    final = os.path.join(h.pvc, "main", HBM)
    base = os.path.join(h.pvc, "main-precopy", HBM)
    assert deltachain.chain_depth(base) == 0
    assert deltachain.chain_depth(final) <= 1
    assert psnap.snapshot_delta_nbytes(final) < psnap.snapshot_nbytes(final)
    cut = psnap.SnapshotManifest.load(final).meta["step"]
    assert cut >= 3
    h.stage()
    _continues_bitwise(h, h.restore_env(h.shim_restore_spec()), cut)


STANDBY_DRIVER = textwrap.dedent("""
    import os, sys, time
    sys.path.insert(0, {repo!r})
    from grit_tpu.agent.checkpoint import CheckpointOptions
    from grit_tpu.agent.standby import run_standby_checkpoint
    from grit_tpu.cri.runtime import (
        Container, FakeRuntime, OciSpec, Sandbox, SimProcess)
    from grit_tpu_torch.device.agentlet import socket_path
    from grit_tpu_torch.device.hook import AutoDeviceHook

    work, pvc, pid = sys.argv[1], sys.argv[2], int(sys.argv[3])
    deadline = time.monotonic() + 120
    while not os.path.exists(socket_path(pid)):
        assert time.monotonic() < deadline, "no agentlet socket"
        time.sleep(0.02)
    rt = FakeRuntime()
    rt.add_sandbox(Sandbox(id="sb1", pod_name="train", pod_namespace="ns1",
                           pod_uid="uid1"))
    rt.add_container(Container(id="c1", sandbox_id="sb1", name="main",
                               spec=OciSpec(image="img")),
                     process=SimProcess(), running=True)
    rt.tasks["c1"].pid = pid
    res = run_standby_checkpoint(rt, CheckpointOptions(
        pod_name="train", pod_namespace="ns1", pod_uid="uid1",
        work_dir=work, dst_dir=pvc, pre_copy=True, leave_running=False),
        device_hook=AutoDeviceHook())
    print("STANDBY-DONE" if res is not None else "STANDBY-DISARMED",
          flush=True)
""").format(repo=REPO)


def test_sigkill_mid_standby_restores_from_last_flattened_base(
        e2e, probe_mode):
    """SIGKILL the standby agent mid-arm, and the source with it: the
    destination restores bit-identically from the last flattened base,
    with no torn round."""
    from grit_tpu.agent.restore import RestoreOptions, run_restore

    h, src = e2e
    driver = subprocess.Popen(
        [sys.executable, "-c", STANDBY_DRIVER, h.host_work, h.pvc,
         str(src.pid)],
        env=dict(os.environ, GRIT_TPU_SOCKET_DIR=h.sockdir),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        h.wait_ready(src)
        threading.Thread(target=lambda: src.stdout.read(),
                         daemon=True).start()
        _wait_rounds_shipped(h.host_work, 4, driver)
    finally:
        driver.kill()
        driver.wait()
    src.kill()
    src.wait()

    base = os.path.join(h.pvc, "main-precopy", HBM)
    assert deltachain.is_committed(base)
    assert deltachain.chain_depth(base) == 0
    for name in deltachain.referenced_files(base):
        assert os.path.isfile(os.path.join(base, name))
    cut = psnap.SnapshotManifest.load(base).meta["step"]
    assert cut >= 1
    run_restore(RestoreOptions(src_dir=h.pvc, dst_dir=h.dst_host))
    staged = os.path.join(h.dst_host, "main-precopy", HBM)
    assert os.path.isfile(os.path.join(staged, psnap.MANIFEST_FILE))
    _continues_bitwise(h, {phook.RESTORE_ENV: staged}, cut)
