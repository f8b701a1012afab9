"""The port's agentlet driven by the unchanged reference: the JAX
package's ``ToggleClient`` and node-agent device hook speak the toggle
protocol to a PyTorch workload, and the reference migration harness moves
a ``python -m grit_tpu_torch.workload`` process bit-identically."""

from __future__ import annotations

import json
import os
import textwrap
import threading
import time

import pytest
import torch

from grit_tpu.device.agentlet import ToggleClient as RefClient
from grit_tpu.device.hook import HBM_SUBDIR, RESTORE_ENV, TpuDeviceCheckpointHook
from grit_tpu.harness import REPO, MigrationHarness, read_losses
from grit_tpu_torch.device import hook as phook
from grit_tpu_torch.device.agentlet import Agentlet, ToggleClient, socket_path
from grit_tpu_torch.device.snapshot import SnapshotManifest, restore_snapshot


class _Loop:
    """A stand-in training loop: bumps a tensor state once per step and
    offers a checkpoint point after each, on its own thread. Its agentlet
    listens on :func:`socket_path` under ``$GRIT_TPU_SOCKET_DIR``; with
    ``reload``, it reloads its state from a snapshot on a ``resume`` with
    ``reload`` (the directories land in ``reloaded``)."""

    def __init__(self, reload: bool = False) -> None:
        self.state = {"w": torch.zeros(4), "step": torch.zeros((), dtype=torch.int32)}
        self.reloaded: list[str] = []
        self.agentlet = Agentlet(
            lambda: self.state, step_fn=lambda: int(self.state["step"]),
            reload_fn=self._reload if reload else None).start()
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _reload(self, directory: str) -> None:
        self.reloaded.append(directory)
        self.state = restore_snapshot(directory, like=self.state)

    def _run(self) -> None:
        while not self._stop.is_set():
            self.state = {"w": self.state["w"] + 1,
                          "step": self.state["step"] + 1}
            self.agentlet.checkpoint_point()
            time.sleep(0.002)

    def close(self) -> None:
        self._stop.set()
        self.agentlet.stop()
        self._thread.join(timeout=10)
        assert not self._thread.is_alive()


@pytest.fixture
def loop(tmp_path, monkeypatch):
    monkeypatch.setenv("GRIT_TPU_SOCKET_DIR", str(tmp_path))
    lp = _Loop()
    yield lp
    lp.close()


def test_reference_client_drives_quiesce_dump_status_resume(loop, tmp_path):
    c = RefClient(0, path=loop.agentlet.path, timeout=30)
    try:
        d = str(tmp_path / "snap")
        step = c.quiesce(dump_spec={"dir": d})
        assert c.status()["paused"] is True
        resp = c.dump(d)
        spec = resp["speculative"]
        assert spec["outcome"] == "validated", spec
        assert spec["clean_bytes"] + spec["dirty_bytes"] == 4 * 4 + 4
        assert SnapshotManifest.load(d).meta == {"step": step}
        got = restore_snapshot(d)
        assert int(got["['step']"]) == step
        assert torch.equal(got["['w']"], torch.full((4,), float(step)))
        time.sleep(0.05)
        assert int(loop.state["step"]) == step  # parked: no step ran
        c.resume()
        deadline = time.monotonic() + 10
        while int(loop.state["step"]) == step and time.monotonic() < deadline:
            time.sleep(0.01)
        assert int(loop.state["step"]) > step
        assert c.status()["paused"] is False
    finally:
        c.close()


def test_unsupported_requests_take_the_reference_failure_paths(loop, tmp_path):
    c = RefClient(0, path=loop.agentlet.path, timeout=30)
    try:
        with pytest.raises(RuntimeError, match="not quiesced"):
            c.dump(str(tmp_path / "early"))
        probe = c.dump(str(tmp_path / "probe"), speculative=True)
        assert probe["speculative"] == {"outcome": "probe"}
        assert os.path.isfile(str(tmp_path / "probe" / "COMMIT"))
        c.quiesce()
        d = str(tmp_path / "snap")
        resp = c.dump(d, mirror=str(tmp_path / "mirror"),
                      wire={"endpoint": "127.0.0.1:1", "prefix": "x"})
        assert resp["wire"]["ok"] is False
        assert "speculative" not in resp  # no dump spec was announced
        assert os.path.isfile(os.path.join(d, "COMMIT"))
        # The mirror is no longer abandoned: it commits beside the dump.
        assert os.path.isfile(str(tmp_path / "mirror" / "COMMIT"))
        with pytest.raises(RuntimeError, match="reload_fn"):
            c.resume(reload=d)
        c.resume()
    finally:
        c.close()


def test_reference_node_hook_dumps_a_torch_workload(tmp_path, monkeypatch):
    """The node agent's TPU device hook (speculation knob on: it sends a
    dump spec with the quiesce) dumps the port agentlet's state into the
    container checkpoint layout and resumes it."""
    monkeypatch.setenv("GRIT_TPU_SOCKET_DIR", str(tmp_path))
    lp = _Loop()
    try:
        assert lp.agentlet.path == socket_path() == os.path.join(
            str(tmp_path), f"grit-tpu-{os.getpid()}.sock")
        hook = TpuDeviceCheckpointHook(timeout=30)
        dest = str(tmp_path / "ckpt")
        hook.dump(os.getpid(), dest)
        manifest = SnapshotManifest.load(os.path.join(dest, HBM_SUBDIR))
        assert manifest.meta["step"] >= 1
        hook.resume(os.getpid())
        monkeypatch.setenv(RESTORE_ENV, os.path.join(dest, HBM_SUBDIR))
        assert phook.restore_dir_from_env() == os.path.join(dest, HBM_SUBDIR)
    finally:
        lp.close()


def test_port_client_and_restore_env(loop, tmp_path, monkeypatch):
    with ToggleClient(0, path=loop.agentlet.path, timeout=30) as c:
        step = c.quiesce()
        c.dump(str(tmp_path / "snap"))
        assert c.status()["step"] == step
        c.resume()
    monkeypatch.setenv(phook.RESTORE_ENV, str(tmp_path / "missing"))
    assert phook.restore_dir_from_env() is None
    monkeypatch.setenv(phook.RESTORE_ENV, str(tmp_path / "snap"))
    assert phook.restore_dir_from_env() == str(tmp_path / "snap")
    assert phook.RESTORE_ENV == RESTORE_ENV


# The port workload at the tiny llama config (head dim 128) on the CPU,
# started the way `python -m grit_tpu_torch.workload` starts it.
TORCH_LLAMA_WORKLOAD = textwrap.dedent("""
    import runpy, sys
    import torch
    torch.set_num_threads(1)  # several test workers share a few cores
    sys.path.insert(0, {repo!r})
    sys.argv = ["grit_tpu_torch.workload", "--config", "tiny", "--device",
                "cpu", "--seq", "128", "--batch", "2"]
    runpy.run_module("grit_tpu_torch.workload", run_name="__main__")
""").format(repo=REPO)


def test_harness_migrates_the_torch_llama_workload(tmp_path):
    """Checkpoint through the reference agent, kill, stage, shim restore
    env, fresh-process restore: the losses after the cut are the
    uninterrupted run's, bit for bit."""
    h = MigrationHarness(str(tmp_path), workload_src=TORCH_LLAMA_WORKLOAD)
    ref = h.spawn(n_steps=7)
    ref_losses = read_losses(ref.stdout.read().splitlines())
    assert ref.wait() == 0 and len(ref_losses) == 7

    src = h.spawn(n_steps=1000)
    h.wait_ready(src)
    h.wait_until_step(src, 3)
    h.checkpoint(h.make_source_runtime(src.pid))
    src.kill()
    src.wait()
    manifest = os.path.join(h.pvc, "main", HBM_SUBDIR, "MANIFEST.json")
    cut = json.load(open(manifest))["meta"]["step"]
    assert cut >= 3

    h.stage()
    spec = h.shim_restore_spec()
    dst = h.spawn(extra_env=h.restore_env(spec), n_steps=7, cache="dst")
    out = dst.stdout.read().splitlines()
    assert dst.wait() == 0
    assert f"RESTORED {cut}" in out
    got = read_losses(out)
    assert got == {s: x for s, x in ref_losses.items() if s > cut}
