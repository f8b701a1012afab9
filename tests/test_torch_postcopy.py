"""Post-copy (lazy) restore in the port: twins of
``tests/test_restore_pipeline.py::TestPostcopyRestore``, fully staged and
streamed through the reference's ``StageJournal``, with every case under
``GRIT_RESTORE_PIPELINE`` 0 and 1. The hot set is placed before
``restore_snapshot_postcopy`` returns, the cold bulk lands through the
tail in the order its bytes are staged, a failed stage falls back to the
blocking restore, and the Trainer's lazy resume continues bit-identically.
Then the workload's post-copy restore after the reference agent's
speculative checkpoint, and snapshot trees holding a ``-spec`` pass and
its validated re-ship cross-restored between the two packages."""

from __future__ import annotations

import json
import os
import shutil
import threading
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from grit_tpu.agent.copy import StageJournal
from grit_tpu.device import snapshot as jsnap
from grit_tpu.device.agentlet import Agentlet as RefAgentlet
from grit_tpu.device.agentlet import ToggleClient as RefClient
from grit_tpu.device.hook import HBM_SUBDIR
from grit_tpu.harness import MigrationHarness, read_losses
from grit_tpu.metadata import STAGE_JOURNAL_FILE
from grit_tpu_torch.device import snapshot as psnap
from grit_tpu_torch.device.agentlet import Agentlet
from tests.test_torch_agentlet import TORCH_LLAMA_WORKLOAD
from tests.test_torch_restore_pipeline import _stage_metadata


@pytest.fixture(autouse=True, params=["0", "1"], ids=["serial", "pipelined"])
def pipeline(request, monkeypatch):
    monkeypatch.setenv("GRIT_RESTORE_PIPELINE", request.param)
    return request.param


def _state() -> dict:
    """b (4 KB), h (3 KB) and s (8 B) are written before w (64 KB)."""
    gen = torch.Generator().manual_seed(7)
    return {"w": torch.randn(256, 64, generator=gen),
            "b": torch.arange(1000, dtype=torch.int32),
            "h": torch.randn(32, 48, generator=gen).to(torch.bfloat16),
            "s": torch.tensor(3, dtype=torch.int64)}


def _assert_same(got: dict, want: dict) -> None:
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        assert torch.equal(got[k].view(torch.uint8) if got[k].dim() else got[k],
                           want[k].view(torch.uint8) if want[k].dim()
                           else want[k]), k


def _stage_data(snap: str, dst: str, journal: StageJournal,
                upto: int | None = None) -> None:
    """The data file's first ``upto`` bytes (all of it by default)."""
    size = os.path.getsize(os.path.join(snap, psnap.DATA_FILE))
    n = size if upto is None else upto
    with open(os.path.join(snap, psnap.DATA_FILE), "rb") as fin, \
            open(os.path.join(dst, psnap.DATA_FILE), "r+b") as fout:
        fout.write(fin.read(n))
    if n == size:
        journal.note_file(psnap.DATA_FILE, size)
    else:
        journal.note_chunk(psnap.DATA_FILE, 0, n, size)


class TestPostcopyRestore:
    def test_postcopy_bit_identical_fully_staged(self, tmp_path, monkeypatch):
        monkeypatch.setenv("GRIT_RESTORE_POSTCOPY_HOT_MB", "0")
        state = _state()
        snap = psnap.write_snapshot(str(tmp_path / "snap"), state)
        handle = psnap.restore_snapshot_postcopy(snap, like=state)
        lazy = handle.wait(timeout=60.0)  # a zero hot cut: all four cold
        assert handle.done and handle.placed == 4
        assert handle.hot_s > 0 and handle.tail_s > 0
        _assert_same(lazy, psnap.restore_snapshot(snap, like=state))
        _assert_same(lazy, state)

    def test_hot_set_places_before_cold_bytes_land(self, tmp_path,
                                                   monkeypatch):
        """The handle comes back once metadata and the hot arrays are
        staged, with the cold one still in flight; its first touch waits
        until the tail has placed it."""
        monkeypatch.setenv("GRIT_RESTORE_POSTCOPY_HOT_MB", "0.01")  # 10 KB
        monkeypatch.setenv("GRIT_TPU_STAGE_TIMEOUT_S", "30")
        state = _state()
        snap = psnap.write_snapshot(str(tmp_path / "snap"), state)
        recs = {r["name"]: r for r in psnap.SnapshotManifest.load(snap).arrays}
        w = recs["['w']"]["chunks"][0]
        assert w["offset"] == sum(recs[n]["chunks"][0]["nbytes"]
                                  for n in ("['b']", "['h']", "['s']"))
        dst = str(tmp_path / "staged")
        journal = _stage_metadata(snap, dst)
        _stage_data(snap, dst, journal, upto=w["offset"])  # the hot prefix
        handle = psnap.restore_snapshot_postcopy(dst, like=state)
        assert handle.placed == 3 and not handle.done
        assert set(handle.placed_leaves()) == {"['b']", "['h']", "['s']"}
        assert torch.equal(handle.placed_leaves()["['b']"], state["b"])
        time.sleep(0.2)
        assert not handle.done  # w has nowhere to come from yet
        _stage_data(snap, dst, journal)
        journal.complete()
        _assert_same(handle.wait(timeout=30.0), state)

    def test_tail_places_in_readiness_order(self, tmp_path, monkeypatch):
        """A delta tree whose chunks live in two files: with the delta's
        file staged and the base's not, the tail places the arrays whose
        bytes have landed first, not in manifest order."""
        monkeypatch.setenv("GRIT_RESTORE_POSTCOPY_HOT_MB", "0")
        monkeypatch.setenv("GRIT_TPU_STAGE_TIMEOUT_S", "30")
        state = _state()
        base = psnap.write_snapshot(str(tmp_path / "src" / "base"), state)
        state["w"] = state["w"] + 1.0  # w (last in the manifest) changes
        delta = psnap.write_snapshot(str(tmp_path / "src" / "delta"), state,
                                     base=base)
        # One journal over both trees, as the agent stages them: both
        # metadata sets and the delta's data staged, the base's data
        # preallocated and not yet staged.
        root = str(tmp_path / "dst")
        journal = StageJournal(root)
        for tree in ("delta", "base"):
            src = os.path.join(str(tmp_path / "src"), tree)
            os.makedirs(os.path.join(root, tree))
            for name in (psnap.COMMIT_FILE, psnap.MANIFEST_FILE,
                         psnap.DATA_FILE):
                shutil.copyfile(os.path.join(src, name),
                                os.path.join(root, tree, name))
                if name != psnap.DATA_FILE or tree == "delta":
                    journal.note_file(f"{tree}/{name}", os.path.getsize(
                        os.path.join(src, name)))
        base_data = os.path.join(root, "base", psnap.DATA_FILE)
        with open(base_data, "r+b") as f:
            f.write(bytes(os.path.getsize(base_data)))  # not yet crossed
        handle = psnap.restore_snapshot_postcopy(os.path.join(root, "delta"),
                                                 like=state)
        deadline = time.monotonic() + 10
        while "['w']" not in handle.placed_leaves():
            assert time.monotonic() < deadline, "the tail did not place w"
            time.sleep(0.01)
        assert set(handle.placed_leaves()) == {"['w']"}
        shutil.copyfile(os.path.join(base, psnap.DATA_FILE), base_data)
        journal.complete()
        _assert_same(handle.wait(timeout=30.0), state)

    def test_poisoned_stage_falls_back_to_blocking_restore(self, tmp_path,
                                                           monkeypatch,
                                                           caplog):
        """A stage that fails under the tail (a wire dropped mid-stream),
        then the agent's re-stage: ``wait`` recovers through the blocking
        restore, with a warning, instead of hanging or handing over
        partial state."""
        monkeypatch.setenv("GRIT_RESTORE_POSTCOPY_HOT_MB", "0")
        monkeypatch.setenv("GRIT_TPU_STAGE_TIMEOUT_S", "30")
        state = _state()
        snap = psnap.write_snapshot(str(tmp_path / "snap"), state)
        dst = str(tmp_path / "staged")
        journal = _stage_metadata(snap, dst)
        handle = psnap.restore_snapshot_postcopy(dst, like=state)
        time.sleep(0.3)  # the tail is blocked on the bulk
        journal.fail("wire dropped mid-stream")
        time.sleep(0.3)
        shutil.copyfile(os.path.join(snap, psnap.DATA_FILE),
                        os.path.join(dst, psnap.DATA_FILE))
        os.unlink(os.path.join(dst, STAGE_JOURNAL_FILE))
        _assert_same(handle.wait(timeout=30.0), state)
        assert any("falling back to the blocking restore" in r.getMessage()
                   for r in caplog.records)

    def test_wait_times_out_on_a_tail_that_cannot_land(self, tmp_path,
                                                       monkeypatch):
        monkeypatch.setenv("GRIT_RESTORE_POSTCOPY_HOT_MB", "0")
        monkeypatch.setenv("GRIT_TPU_STAGE_TIMEOUT_S", "30")
        state = _state()
        snap = psnap.write_snapshot(str(tmp_path / "snap"), state)
        dst = str(tmp_path / "staged")
        journal = _stage_metadata(snap, dst)
        handle = psnap.restore_snapshot_postcopy(dst, like=state)
        with pytest.raises(TimeoutError, match="still placing"):
            handle.wait(timeout=0.3)
        _stage_data(snap, dst, journal)
        journal.complete()
        _assert_same(handle.wait(timeout=30.0), state)

    def test_postcopy_requires_like(self, tmp_path):
        snap = psnap.write_snapshot(str(tmp_path / "snap"), _state())
        with pytest.raises(ValueError, match="like"):
            psnap.restore_snapshot_postcopy(snap, like=None)

    @pytest.mark.parametrize("staging", ["staged", "streamed"])
    def test_trainer_postcopy_resume_bit_identical(self, tmp_path,
                                                   monkeypatch, staging):
        """``restore`` returns the cut step without the bulk, the step
        probe answers from the manifest without joining, and the first
        ``train_step`` joins the tail: the losses continue exactly, from
        a staged tree or one whose data streams in after the restore."""
        from grit_tpu_torch.workload import mnist_trainer  # noqa: PLC0415

        tr = mnist_trainer(device="cpu")
        tr.run(3)
        snap = tr.snapshot(str(tmp_path / "snap"))
        cont = tr.run(2)

        monkeypatch.setenv("GRIT_RESTORE_POSTCOPY", "1")
        monkeypatch.setenv("GRIT_RESTORE_POSTCOPY_HOT_MB", "0")
        monkeypatch.setenv("GRIT_TPU_STAGE_TIMEOUT_S", "30")
        journal, where = None, snap
        if staging == "streamed":
            where = str(tmp_path / "staged")
            journal = _stage_metadata(snap, where)
        tr2 = mnist_trainer(device="cpu")
        assert tr2.restore(where) == 3
        assert tr2.postcopy is not None  # the bulk is still landing
        assert tr2.step == 3  # from the manifest, without the tail
        assert tr2.postcopy is not None
        if journal is not None:
            assert not tr2.postcopy.done
            threading.Timer(0.2, lambda: (_stage_data(snap, where, journal),
                                          journal.complete())).start()
        assert tr2.run(2) == cont
        assert tr2.postcopy is None

    def test_a_failed_join_stays_loud(self, tmp_path, monkeypatch):
        """The Trainer drops the handle only after ``wait`` succeeds: a
        join that fails raises on every touch, never a fresh state."""
        from grit_tpu_torch.workload import mnist_trainer  # noqa: PLC0415

        tr = mnist_trainer(device="cpu")
        tr.run(1)
        snap = tr.snapshot(str(tmp_path / "snap"))
        monkeypatch.setenv("GRIT_RESTORE_POSTCOPY", "1")
        monkeypatch.setenv("GRIT_RESTORE_POSTCOPY_HOT_MB", "0")

        def broken(*args, **kwargs):
            raise RuntimeError("planted: a placement bug")

        monkeypatch.setattr(psnap._Placer, "place", broken)
        tr2 = mnist_trainer(device="cpu")
        assert tr2.restore(snap) == 1
        for _ in range(2):
            with pytest.raises(RuntimeError, match="placement bug"):
                tr2.train_step()
        assert tr2.postcopy is not None and tr2.step == 1


# -- the workload, after the reference agent's speculative checkpoint ---------------


def test_workload_postcopy_restore_after_a_speculative_checkpoint(tmp_path):
    """The reference ``MigrationHarness`` checkpoints the port's tiny llama
    workload (speculation on: the blackout is a validated re-ship against
    its ``-spec`` pass, staged beside it), and a destination restores with
    ``GRIT_RESTORE_POSTCOPY=1``: ``READY`` follows the hot set, the first
    step joins the tail (``RESTORE_POSTCOPY`` after it), and the losses
    after the cut are the uninterrupted run's bit for bit."""
    h = MigrationHarness(str(tmp_path), workload_src=TORCH_LLAMA_WORKLOAD)
    ref = h.spawn(n_steps=7)
    ref_losses = read_losses(ref.stdout.read().splitlines())
    assert ref.wait() == 0 and len(ref_losses) == 7
    src = h.spawn(n_steps=1000)
    try:
        h.wait_ready(src)
        h.wait_until_step(src, 3)
        h.checkpoint(h.make_source_runtime(src.pid))
    finally:
        src.kill()
        src.wait()
    main = os.path.join(h.pvc, "main")
    manifest = json.load(open(os.path.join(main, HBM_SUBDIR, "MANIFEST.json")))
    cut = manifest["meta"]["step"]
    assert manifest["base"] == os.path.join("..", HBM_SUBDIR + "-spec")
    assert os.path.isfile(os.path.join(main, HBM_SUBDIR + "-spec", "COMMIT"))
    h.stage()
    env = {**h.restore_env(h.shim_restore_spec()),
           "GRIT_RESTORE_POSTCOPY": "1",
           "GRIT_RESTORE_POSTCOPY_HOT_MB": "0.01"}
    dst = h.spawn(extra_env=env, n_steps=7, cache="dst")
    out = dst.stdout.read().splitlines()
    assert dst.wait() == 0
    assert f"RESTORED {cut}" in out
    pipe = json.loads(next(x for x in out if x.startswith("RESTORE_PIPELINE "))
                      .split(" ", 1)[1])
    assert pipe["postcopy"] is True and pipe["hot_s"] > 0
    at = {tag: next(i for i, x in enumerate(out) if x.startswith(tag))
          for tag in ("READY", "STEP ", "RESTORE_POSTCOPY ")}
    assert at["READY"] < at["STEP "] < at["RESTORE_POSTCOPY "]
    tail = json.loads(out[at["RESTORE_POSTCOPY "]].split(" ", 1)[1])
    assert tail["tail_s"] > 0 and tail["hot_s"] == pipe["hot_s"]
    assert read_losses(out) == {s: x for s, x in ref_losses.items() if s > cut}


# -- cross-restore of a speculative tree between the packages -------------------------


def _speculate(agentlet, client_path: str, d: str, touch) -> dict:
    """Quiesce with a dump spec while a loop offers boundaries, apply
    ``touch`` to the parked state, dump; the dump's response."""
    stop = threading.Event()

    def run():
        while not stop.is_set():
            agentlet.checkpoint_point()
            time.sleep(0.001)

    t = threading.Thread(target=run, daemon=True)
    t.start()
    try:
        with RefClient(0, path=client_path) as client:
            client.quiesce(dump_spec={"dir": d})
            touch()
            resp = client.dump(d)
            client.resume()
    finally:
        stop.set()
        t.join(timeout=10)
    assert not t.is_alive()
    return resp


def _numpy_state() -> dict:
    rng = np.random.default_rng(3)
    return {"w": rng.standard_normal((16, 8)).astype(np.float32),
            "frozen": rng.standard_normal(300).astype(np.float32),
            "ids": np.arange(12, dtype=np.int32),
            "step": np.array(5, np.int32)}


@pytest.mark.parametrize("postcopy", [False, True], ids=["blocking", "postcopy"])
def test_jax_speculative_tree_restores_in_the_port(tmp_path, monkeypatch,
                                                   postcopy):
    """A JAX agentlet's validated re-ship and its ``-spec`` pass (the JAX
    writer on its crc32 plane) restore through the port, blocking and
    post-copy, leaf for leaf byte-identical to JAX's own restore."""
    monkeypatch.setattr(jsnap, "_chunk_writer",
                        lambda path, durable: jsnap._PyChunkWriter(path, durable))
    monkeypatch.setenv("GRIT_RESTORE_POSTCOPY_HOT_MB", "0.0001")
    state = {k: jnp.asarray(v) for k, v in _numpy_state().items()}
    path, d = str(tmp_path / "a.sock"), str(tmp_path / "snap")

    def touch():
        state["w"] = state["w"] * 2.0

    with RefAgentlet(lambda: state, path=path) as agentlet:
        resp = _speculate(agentlet, path, d, touch)
    assert resp["speculative"]["outcome"] == "validated", resp
    assert 0 < jsnap.snapshot_delta_nbytes(d) < jsnap.snapshot_nbytes(d)
    want = jsnap.restore_snapshot(d)
    like = {k: torch.from_numpy(np.array(v)) for k, v in state.items()}
    got = (psnap.restore_snapshot_postcopy(d, like=like).wait(timeout=30)
           if postcopy else psnap.restore_snapshot(d, like=like))
    for k in like:
        assert got[k].numpy().tobytes() == \
            np.asarray(want[f"[{k!r}]"]).tobytes(), k


def test_port_speculative_tree_restores_in_jax(tmp_path):
    """The port's validated re-ship and its ``-spec`` pass restore through
    ``grit_tpu.device.restore_snapshot`` byte for byte."""
    state = {k: torch.from_numpy(v) for k, v in _numpy_state().items()}
    path, d = str(tmp_path / "a.sock"), str(tmp_path / "snap")

    def touch():
        state["w"].mul_(2.0)

    with Agentlet(lambda: state, path=path) as agentlet:
        resp = _speculate(agentlet, path, d, touch)
    assert resp["speculative"]["outcome"] == "validated", resp
    assert resp["speculative"]["dirty_bytes"] == 16 * 8 * 4
    got = jsnap.restore_snapshot(
        d, like={k: jnp.zeros(v.shape, jnp.asarray(v.numpy()).dtype)
                 for k, v in state.items()})
    for k, v in state.items():
        assert np.asarray(got[k]).tobytes() == v.numpy().tobytes(), k
