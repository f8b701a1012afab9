"""The gang cut of a sharded port job through the port's node hooks.

``python -m grit_tpu_torch.workload --mesh 1,2,2`` trains the tiny llama
on four gloo CPU ranks, one process a rank, each serving its own
agentlet with a slice gate (a file rendezvous and the lockstep
collective). Four ``TpuDeviceCheckpointHook`` under
``GRIT_SLICE_HOSTS=4`` dump one rank each into ``host-<k>``, from four
threads at once: every rank parks at one agreed step, and each leg's
manifest records it. The source resumes and runs on; then

- four fresh ranks on (1,2,2), each restoring its own leg
  (``GRIT_TPU_RESTORE_DIR`` naming ``{rank}``) by post-copy, continue
  with the source's losses bit for bit;
- four fresh ranks on (2,1,2) restore the legs' merged view
  (``merge_legs``) and continue within 1e-2 of them (the JAX Trainer's
  re-layout bound).
"""

from __future__ import annotations

import os
import re
import subprocess
import sys
import threading
import time

import pytest
import torch

from grit_tpu_torch.device.hook import HBM_SUBDIR, TpuDeviceCheckpointHook
from grit_tpu_torch.device.snapshot import (
    SnapshotIntegrityError,
    SnapshotManifest,
    merge_legs,
    restore_snapshot,
    write_snapshot,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N = 4
N_STEPS = 10
RELAYOUT_BOUND = 1e-2  # tests/test_trainer.py:80-96
ARGS = ["--config", "tiny", "--device", "cpu", "--seq", "64", "--layers", "2"]


class Job:
    """A ``--mesh`` workload and the lines it prints, read on a thread."""

    def __init__(self, mesh: str, env: dict) -> None:
        self.lines: list[str] = []
        self.proc = subprocess.Popen(
            [sys.executable, "-m", "grit_tpu_torch.workload", *ARGS,
             "--mesh", mesh], cwd=REPO, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.DEVNULL, text=True)
        self._reader = threading.Thread(target=self._read, daemon=True)
        self._reader.start()

    def _read(self) -> None:
        for line in self.proc.stdout:
            self.lines.append(line.strip())

    def wait_for(self, pred, timeout: float = 180.0) -> None:
        deadline = time.monotonic() + timeout
        while not pred(self.lines):
            assert self.proc.poll() is None or pred(self.lines), self.lines
            assert time.monotonic() < deadline, self.lines
            time.sleep(0.05)

    def finish(self, timeout: float = 180.0) -> dict[int, str]:
        """The exit (0) and rank 0's ``{step: loss}``, as printed."""
        assert self.proc.wait(timeout) == 0, self.lines
        self._reader.join(10)
        assert self.lines[-1] == "DONE", self.lines
        return {int(x.split()[1]): x.split()[2] for x in self.lines
                if x.startswith("STEP ")}

    @property
    def pids(self) -> list[int]:
        got = dict(map(int, x.split()[1:]) for x in self.lines
                   if x.startswith("PID "))
        return [got[k] for k in range(N)]


def _env(sockdir: str, **extra) -> dict:
    env = dict(os.environ, GRIT_TPU_SOCKET_DIR=sockdir,
               N_STEPS=str(N_STEPS), PYTHONPATH=REPO)
    for key in ("GRIT_TPU_RESTORE_DIR", "GRIT_RESTORE_POSTCOPY",
                "GRIT_SLICE_HOSTS"):
        env.pop(key, None)
    env.update(extra)
    return env


@pytest.fixture(scope="module")
def gang(tmp_path_factory):
    work = str(tmp_path_factory.mktemp("sharded-gang"))
    sockdir = os.path.join(work, "s")
    os.makedirs(sockdir)
    src = Job("1,2,2", _env(sockdir))
    src.wait_for(lambda ls: sum(x.startswith("PID ") for x in ls) == N
                 and "STEP 2" in " ".join(ls))
    pids = src.pids
    hook = TpuDeviceCheckpointHook(timeout=120)
    errors: dict = {}
    saved = {k: os.environ.get(k) for k in (
        "GRIT_TPU_SOCKET_DIR", "GRIT_SLICE_HOSTS", "GRIT_SLICE_NONCE")}
    os.environ.update(GRIT_TPU_SOCKET_DIR=sockdir, GRIT_SLICE_HOSTS=str(N),
                      GRIT_SLICE_NONCE="gang")
    try:
        def dump(k: int) -> None:
            try:
                hook.dump(pids[k], os.path.join(work, f"host-{k}"))
            except Exception as exc:  # noqa: BLE001 — the test reads it
                errors[k] = exc

        threads = [threading.Thread(target=dump, args=(k,))
                   for k in range(N)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(180)
        legs = [os.path.join(work, f"host-{k}", HBM_SUBDIR) for k in range(N)]
        manifests = ([SnapshotManifest.load(d) for d in legs]
                     if not errors else [])
        for p in pids:
            hook.resume(p)
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    source = src.finish()
    assert not errors, errors
    cut = manifests[0].meta["step"]
    same = Job("1,2,2", _env(sockdir, GRIT_RESTORE_POSTCOPY="1",
                             GRIT_TPU_RESTORE_DIR=os.path.join(
                                 work, "host-{rank}", HBM_SUBDIR)))
    same_losses = same.finish()
    merged = merge_legs(os.path.join(work, "merged"), legs)
    other = Job("2,1,2", _env(sockdir, GRIT_TPU_RESTORE_DIR=merged))
    other_losses = other.finish()
    return {"manifests": manifests, "cut": cut, "source": source,
            "same": (same.lines, same_losses),
            "other": (other.lines, other_losses)}


def test_every_leg_records_one_cut(gang):
    cut = gang["cut"]
    assert 2 <= cut < N_STEPS
    for k, m in enumerate(gang["manifests"]):
        assert m.meta["step"] == cut
        assert m.process_count == N
        assert {c["file"] for rec in m.arrays for c in rec["chunks"]} == {
            f"data-h{k:04d}.bin"}
        assert all(rec["sharding"]["type"] == "named" for rec in m.arrays)


def test_same_mesh_postcopy_restore_is_bitwise(gang):
    lines, losses = gang["same"]
    cut = gang["cut"]
    assert f"RESTORED {cut}" in lines
    assert any(x.startswith("RESTORE_POSTCOPY ") for x in lines)
    assert sorted(losses) == list(range(cut + 1, N_STEPS + 1))
    for step, loss in losses.items():
        assert loss == gang["source"][step], step


def test_other_mesh_restore_within_the_relayout_bound(gang):
    lines, losses = gang["other"]
    cut = gang["cut"]
    assert f"RESTORED {cut}" in lines, (cut, lines)
    assert sorted(losses) == list(range(cut + 1, N_STEPS + 1)), (cut, lines)
    for step, loss in losses.items():
        want = float(gang["source"][step])
        assert abs(float(loss) - want) / max(1.0, abs(want)) < \
            RELAYOUT_BOUND, (f"step {step} after the cut at {cut}: (2,1,2) "
                             f"loss {loss}, the source's {want}")


def test_ranks_protocol_lines_never_interleave():
    """Ranks of a ``--mesh`` workload share one stdout. Under
    ``PYTHONUNBUFFERED`` a ``print`` writes its text and its newline
    apart, so two ranks' lines could merge (``PID 0 5104PID 2 5106``) and
    the reader miss a ``PID``, ``RESTORED`` or ``STEP`` line: the
    workload's :func:`emit` writes each line at once."""
    code = ("import sys; from grit_tpu_torch.workload import emit\n"
            "for i in range(3000): emit(f'PID {sys.argv[1]} {i}')\n")
    env = dict(os.environ, PYTHONUNBUFFERED="1", PYTHONPATH=REPO)
    read, write = os.pipe()
    procs = [subprocess.Popen([sys.executable, "-c", code, str(k)], cwd=REPO,
                              env=env, stdout=write) for k in range(N)]
    os.close(write)
    with os.fdopen(read) as f:
        lines = f.read().splitlines()
    assert [p.wait(120) for p in procs] == [0] * N
    bad = [x for x in lines if not re.fullmatch(r"PID \d \d+", x)]
    assert not bad, bad[:5]
    assert len(lines) == 3000 * N


def test_chip_smoke_gang_mesh_phase_rehearsal(tmp_path):
    """``chip_smoke.phase_mesh(gang=True)``, the card's phases 18 and 20,
    on four CPU ranks at a tiny f32 width: the hooks' cut of the sharded
    flagship into legs of one step, the post-copy restore of each leg
    (bitwise) and of the merged legs onto (2,1,2); the phase's own
    checks raise on any miss."""
    import torch  # noqa: PLC0415

    import chip_smoke  # noqa: PLC0415
    from grit_tpu_torch.models import llama as pllama  # noqa: PLC0415

    cfg = pllama.LlamaConfig.tiny(dim=128, n_layers=4, n_heads=8,
                                  n_kv_heads=4, dtype=torch.float32,
                                  vocab_size=32000)
    got = chip_smoke.phase_mesh(torch, str(tmp_path), "cpu", seed=0,
                                device="cpu", cfg=cfg, shape=(2, 64),
                                gang=True)["gang"]
    assert got["cut"] > chip_smoke.GANG_MESH_READY
    assert len(got["postcopy"]["tail_s"]) == chip_smoke.N_RANKS
    assert max(max(g) for g in got["other_gaps"]) < \
        chip_smoke.MESH_RELAYOUT_BOUND


def _stage(seed: int) -> dict:
    """A pipeline rank's stage tree: the same names, dtypes and shapes on
    every rank, its own layers' values."""
    gen = torch.Generator().manual_seed(seed)
    return {"layers": {"wq": torch.randn(2, 8, 8, generator=gen)},
            "norm": torch.ones(8)}


def _legs(tmp_path, states: list, *, leg: bool = True) -> list[str]:
    """Each state written as its rank's leg of one cut (``leg=False``: as
    a rank's own single-process tree, the pipelined gang's layout)."""
    out = []
    for k, state in enumerate(states):
        d = str(tmp_path / f"host-{k}" / "hbm")
        kw = (dict(process_index=k, process_count=len(states), leg=True)
              if leg else {})
        write_snapshot(d, state, meta={"step": 3}, **kw)
        out.append(d)
    return out


def test_merge_legs_joins_legs_that_agree(tmp_path):
    legs = _legs(tmp_path, [_stage(0), _stage(0)])
    merged = merge_legs(str(tmp_path / "merged"), legs)
    got = restore_snapshot(merged, device="cpu")
    assert torch.equal(got["['layers']['wq']"], _stage(0)["layers"]["wq"])
    assert SnapshotManifest.load(merged).process_count == 2


@pytest.mark.parametrize("case", ["pipelined_trees", "legs_that_differ",
                                  "one_process_twice"])
def test_merge_legs_refuses_what_is_not_one_cut(tmp_path, case):
    """Per-rank trees of a pipelined gang (each a whole single-process
    tree, same names, different layers), legs whose copies of a
    replicated shard differ, and one process's leg given twice raise;
    nothing is committed."""
    if case == "pipelined_trees":
        legs = _legs(tmp_path, [_stage(0), _stage(1)], leg=False)
    elif case == "legs_that_differ":
        legs = _legs(tmp_path, [_stage(0), _stage(1)])
    else:
        legs = _legs(tmp_path, [_stage(0), _stage(0)])
        legs[1] = legs[0]
    target = str(tmp_path / "merged")
    with pytest.raises(SnapshotIntegrityError):
        merge_legs(target, legs)
    assert not os.path.exists(target)
