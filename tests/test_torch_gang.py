"""Gang slice migration of port workloads.

- The JAX package's ``SliceHarness`` flow, unchanged
  (``run_slice_checkpoint``, ``run_slice_restore``), migrates port hosts
  (``tests/torch_slice_workload.py``, put in place of the harness's
  ``SLICE_WORKLOAD`` at run time) through the port's node hook: one cut,
  every restored host continuing bit for bit from its rank-seeded
  reference. Two hosts here, four in the slow twin.
- ``chip_smoke.py``'s ``[gang]`` phase run on the CPU (its own code, at
  a tiny shape): four gloo ranks of a pipelined llama (one stage a rank)
  whose gates carry the ``lockstep`` collective, four port hooks' dumps
  landing staggered, one cut in every host's manifest, fresh ranks
  restoring ``host-<k>`` and continuing bit for bit.
- Through the same phase's source ranks: a gang where one rank's request
  never arrives (no rank parks, every rank trains on, every quiesce
  answers the barrier error within the barrier timeout), and a retry of
  that gang under a new nonce, which parks every rank at one step.
"""

from __future__ import annotations

import json
import os
import re
import subprocess
import sys
import textwrap
import threading
import time
from dataclasses import replace

import pytest
import torch

import chip_smoke

from grit_tpu import harness as ref_harness
from grit_tpu.harness import SliceHarness, read_losses
from grit_tpu_torch.device.hook import HBM_SUBDIR, TpuDeviceCheckpointHook
from grit_tpu_torch.device.snapshot import SnapshotManifest
from grit_tpu_torch.models import llama
from tests.torch_slice_workload import REPO, SLICE_WORKLOAD

# One host's checkpoint leg, as the per-host agent Job runs it, in a
# process of its own (the leg sets the slice env of its process), with
# the port's hook in the harness's place.
SLICE_LEG = textwrap.dedent("""
    import os, sys
    os.environ["JAX_PLATFORMS"] = "cpu"
    sys.path.insert(0, {repo!r})
    base, k, hosts, pid = (sys.argv[1], int(sys.argv[2]),
                           int(sys.argv[3]), int(sys.argv[4]))
    from grit_tpu import harness
    from grit_tpu_torch.device.hook import AutoDeviceHook

    harness.AutoDeviceHook = AutoDeviceHook
    h = harness.SliceHarness(base, hosts=hosts)
    h.checkpoint_host(k, h.make_source_runtime(k, pid))
    print("CHECKPOINT-DONE", flush=True)
""").format(repo=REPO)


def _reader(proc):
    """Continuous stdout capture: (lines, wait_step)."""
    lines: list[str] = []
    cond = threading.Condition()

    def pump():
        for line in proc.stdout:
            with cond:
                lines.append(line)
                cond.notify_all()

    threading.Thread(target=pump, daemon=True).start()

    def wait_step(step: int, timeout: float = 120.0) -> None:
        deadline = time.monotonic() + timeout
        with cond:
            while not any((m := re.match(r"STEP (\d+)", x))
                          and int(m.group(1)) >= step for x in lines):
                if proc.poll() is not None:
                    raise AssertionError(f"workload exited rc="
                                         f"{proc.returncode}: {lines}")
                if time.monotonic() > deadline:
                    raise AssertionError(f"no step {step} in {timeout}s")
                cond.wait(timeout=0.5)

    return lines, wait_step


def _reference_losses(h, k: int, n_steps: int) -> dict:
    """An uninterrupted rank-k run (a rendezvous of its own: it must not
    join the gang's barriers)."""
    ref = h.spawn(k, n_steps=n_steps, extra_env={
        "SLICE_RDV_DIR": os.path.join(h.base, f"ref-rdv-{k}"),
        "SLICE_WORLD": "1"})
    out = ref.stdout.read().splitlines()
    assert ref.wait() == 0
    return read_losses(out)


def _gang_migration(tmp_path, monkeypatch, hosts: int) -> None:
    from grit_tpu.agent.slicerole import GangLedger  # noqa: PLC0415
    from grit_tpu.api import config as ref_config  # noqa: PLC0415
    from grit_tpu.metadata import DOWNLOAD_STATE_FILE  # noqa: PLC0415

    monkeypatch.setattr(ref_harness, "SLICE_WORKLOAD", SLICE_WORKLOAD)
    h = SliceHarness(str(tmp_path), hosts=hosts)
    procs = [h.spawn(k, n_steps=10 ** 6) for k in range(hosts)]
    try:
        readers = [_reader(p) for p in procs]
        for _lines, wait_step in readers:
            wait_step(3)
        legs = [subprocess.Popen(
            [sys.executable, "-c", SLICE_LEG, h.base, str(k), str(hosts),
             str(p.pid)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True, env=dict(os.environ, JAX_PLATFORMS="cpu"), cwd=REPO)
            for k, p in enumerate(procs)]
        for k, d in enumerate(legs):
            try:
                out, _ = d.communicate(timeout=240)
            except subprocess.TimeoutExpired:
                for q in legs:
                    q.kill()
                pytest.fail(f"host {k}'s agent leg timed out")
            assert d.returncode == 0 and "CHECKPOINT-DONE" in out, (k, out)
        cuts = {json.load(open(os.path.join(
            h.pvc_dir(k), "main", HBM_SUBDIR, "MANIFEST.json")))["meta"]["step"]
            for k in range(hosts)}
        assert len(cuts) == 1, cuts  # one gang-consistent cut
        cut = cuts.pop()
        assert GangLedger(h.shared_pvc, h.role(0)).hosts_in("dumped") == \
            list(range(hosts))
    finally:
        for p in procs:
            p.kill()
            p.wait()

    outcomes: list = [None] * hosts

    def restore(k):
        try:
            h.restore_host(k)
            outcomes[k] = "ok"
        except Exception as exc:  # noqa: BLE001 — reported below
            outcomes[k] = exc

    threads = [threading.Thread(target=restore, args=(k,))
               for k in range(hosts)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=180)
    assert outcomes == ["ok"] * hosts, outcomes
    assert GangLedger(h.shared_pvc, h.role(0)).committed()
    for k in range(hosts):
        assert os.path.exists(os.path.join(h.dst_host(k), DOWNLOAD_STATE_FILE))
        restored = h.spawn(k, n_steps=cut + 5, extra_env={
            ref_config.TPU_RESTORE_DIR.name: os.path.join(
                h.dst_host(k), "main", HBM_SUBDIR),
            "SLICE_RDV_DIR": os.path.join(h.base, f"restored-rdv-{k}"),
            "SLICE_WORLD": "1"})
        out = restored.stdout.read().splitlines()
        assert restored.wait() == 0
        assert f"RESTORED {cut}" in out, out
        got = read_losses(out)
        ref = _reference_losses(h, k, cut + 5)
        assert sorted(got) == list(range(cut + 1, cut + 6))
        for step in got:
            assert got[step] == ref[step], (k, step)


def test_slice_harness_migrates_two_port_hosts(tmp_path, monkeypatch):
    _gang_migration(tmp_path, monkeypatch, hosts=2)


@pytest.mark.slow
def test_slice_harness_migrates_four_port_hosts(tmp_path, monkeypatch):
    _gang_migration(tmp_path, monkeypatch, hosts=4)


# -- four pipeline ranks --------------------------------------------------------------

RANKS = chip_smoke.N_RANKS
CFG = replace(llama.LlamaConfig.tiny(n_layers=4), dtype=torch.float32)
SHAPE = {"batch": 4, "seq": 32, "micro": 2}


def _sources(tmp_path, monkeypatch) -> chip_smoke.GangSources:
    """Phase 17's source ranks at the tiny shape on the CPU, the hook's
    socket dir set to theirs."""
    gwork = str(tmp_path / "g")
    os.makedirs(gwork)
    spec = chip_smoke.gang_spec(gwork, CFG, seed=3, device="cpu", **SHAPE)
    monkeypatch.setenv("GRIT_TPU_SOCKET_DIR", spec["sockdir"])
    return chip_smoke.GangSources(spec, timeout=300)


def test_pipeline_gang_cuts_at_one_step_and_restores_bitwise(tmp_path):
    """``chip_smoke.py``'s ``[gang]`` phase on the CPU: four pipeline
    stages whose hooks' slice quiesces land 0.15 s apart (a step or more
    here) cut at one step in every host's manifest; the sources resume to
    cut + 3, and four fresh ranks each restoring ``host-<k>`` continue bit
    for bit (losses and final state). The phase raises on any check."""
    out = chip_smoke.phase_gang(torch, str(tmp_path), "CPU", seed=3,
                                device="cpu", cfg=CFG, stagger_s=0.15,
                                **SHAPE)
    assert len(out["request_steps"]) == RANKS
    assert all(s is not None and s <= out["cut"]
               for s in out["request_steps"])
    assert all(w is not None for w in out["barrier_wait_s"])
    assert out["blackout_s"] >= 0.15 * (RANKS - 1)


def _failed_round(src, hook, pids, timeout: float) -> None:
    """Ranks 0-2's slice quiesces land; rank 3's never does. Every quiesce
    answers the barrier error within the timeout plus 2 s, no rank parks,
    every gate is latched and all four train on in step."""
    dumps = chip_smoke.gang_dumps(hook, pids, src.spec["work"], [0, 1, 2],
                                  stagger_s=0.1)
    for k in range(3):
        t0, t1, exc = dumps[k]
        assert "slice quiesce barrier failed" in str(exc), (k, exc)
        assert t1 - t0 < timeout + 2.0, (k, t1 - t0)
    statuses = [src.status(p) for p in pids]
    assert not any(s["paused"] for s in statuses)
    assert all(s["slice"]["failed"] for s in statuses)
    before = [s["step"] for s in statuses]
    after = src.wait_steps(max(before) + 3, timeout=120)
    assert min(a - b for a, b in zip(after, before)) >= 2
    for p in pids[:3]:  # the agent's error path
        hook.resume(p)


def test_pipeline_gang_without_one_request_never_parks(tmp_path, monkeypatch):
    """Rank 3's request never arrives (``GRIT_SLICE_BARRIER_TIMEOUT_S=5``):
    every other rank's quiesce answers the barrier error within the
    timeout plus 2 s, no rank parks, and all four train on in step."""
    timeout = 5.0
    monkeypatch.setenv("GRIT_SLICE_HOSTS", str(RANKS))
    monkeypatch.setenv("GRIT_SLICE_BARRIER_TIMEOUT_S", str(timeout))
    src = _sources(tmp_path, monkeypatch)
    try:
        pids = src.pids(timeout=180)
        src.wait_steps(2, timeout=120)
        hook = TpuDeviceCheckpointHook(timeout=120)
        _failed_round(src, hook, pids, timeout)
        src.stop_at(max(src.wait_steps(0)) + 4)
        sources = src.join(timeout=300)
    finally:
        src.close()
    assert all(s["losses"] == sources[0]["losses"] for s in sources)
    assert [s["failed"] is not None for s in sources] == \
        [False, False, False, True]
    assert all(s["foreign"] == [] for s in sources)
    assert not any(os.path.exists(os.path.join(src.spec["work"], f"host-{k}",
                                               HBM_SUBDIR))
                   for k in range(RANKS))


def test_pipeline_gang_retry_after_a_failed_round_parks_at_one_step(
        tmp_path, monkeypatch):
    """A round fails (rank 3's request never arrives, so its hold latches
    its gate); the agent resumes the others and retries the gang under a
    new nonce, rank 3's request again landing after its peers'. Its latch
    belongs to the finished round: it holds for its request, and every
    rank parks at one step, the same in every host's manifest."""
    timeout = 5.0
    monkeypatch.setenv("GRIT_SLICE_HOSTS", str(RANKS))
    monkeypatch.setenv("GRIT_SLICE_BARRIER_TIMEOUT_S", str(timeout))
    monkeypatch.setenv("GRIT_SLICE_NONCE", "1")
    src = _sources(tmp_path, monkeypatch)
    try:
        pids = src.pids(timeout=180)
        src.wait_steps(2, timeout=120)
        hook = TpuDeviceCheckpointHook(timeout=120)
        _failed_round(src, hook, pids, timeout)
        monkeypatch.setenv("GRIT_SLICE_NONCE", "2")
        dumps = chip_smoke.gang_dumps(hook, pids, src.spec["work"],
                                      range(RANKS), stagger_s=0.15,
                                      prefix="retry")
        assert {k: v[2] for k, v in dumps.items()} == \
            {k: None for k in range(RANKS)}
        cuts = {SnapshotManifest.load(os.path.join(
            src.spec["work"], f"retry-{k}", HBM_SUBDIR)).meta["step"]
            for k in range(RANKS)}
        assert len(cuts) == 1, cuts
        cut = cuts.pop()
        statuses = [src.status(p) for p in pids]
        assert all(s["paused"] for s in statuses)
        assert [s["slice"] for s in statuses] == \
            [{"cut": cut, "failed": None}] * RANKS
        src.stop_at(cut + 1)
        for p in pids:
            hook.resume(p)
        sources = src.join(timeout=300)
    finally:
        src.close()
    assert all(s["losses"] == sources[0]["losses"] for s in sources)
    assert [s["failed"] for s in sources] == [None] * RANKS
