"""The port's native device seams: the ``gpu-checkpoint`` CLI and the CRIU
GPU plugin (``grit_tpu_torch/csrc/``), built with the host compiler by
``grit_tpu_torch.device.native``, drive a live port workload over the
toggle protocol. Twins of the JAX package's ``TestTpuCheckpointCli`` and
``TestCriuPlugin`` (``tests/test_agentlet.py``), which need
``native/build/``; these need only ``cc``. The plugin refuses an fd open
on an NVIDIA device node, where the TPU plugin reopens ``/dev/accel*``
by path: its classifier is checked here on paths, its refusal on a real
``/dev/nvidiactl`` fd on the card."""

from __future__ import annotations

import ctypes
import errno
import json
import os
import re
import subprocess
import sys
import textwrap
import time

import pytest

from grit_tpu_torch.device import native
from grit_tpu_torch.device.snapshot import (
    SnapshotManifest,
    restore_snapshot,
    snapshot_delta_nbytes,
    snapshot_exists,
    snapshot_nbytes,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# A port workload: a step loop over torch state behind the port's agentlet.
WORKLOAD = textwrap.dedent("""
    import sys, time
    sys.path.insert(0, {repo!r})
    import torch
    torch.set_num_threads(1)
    from grit_tpu_torch.device.agentlet import Agentlet

    state = {{"w": torch.zeros(4), "step": torch.zeros((), dtype=torch.int32)}}
    agentlet = Agentlet(lambda: state,
                        step_fn=lambda: int(state["step"])).start()
    print("READY", flush=True)
    while True:
        state["w"] = state["w"] + 1.0
        state["step"] = state["step"] + 1
        agentlet.checkpoint_point()
        time.sleep(0.01)
""").format(repo=REPO)


@pytest.fixture(scope="module")
def cli() -> str:
    return native.cli_path()


@pytest.fixture(scope="module")
def plugin() -> str:
    return native.plugin_path()


@pytest.fixture(scope="module")
def workload(tmp_path_factory):
    """A live port workload process and its socket dir; each test leaves
    it running (resumed)."""
    sockdir = str(tmp_path_factory.mktemp("socks"))
    proc = subprocess.Popen(
        [sys.executable, "-c", WORKLOAD], stdout=subprocess.PIPE,
        stderr=subprocess.DEVNULL, text=True,
        env=dict(os.environ, GRIT_TPU_SOCKET_DIR=sockdir))
    try:
        assert proc.stdout.readline().strip() == "READY"
        yield proc, sockdir
    finally:
        proc.kill()
        proc.wait()


def _run(cli, sockdir, *args):
    return subprocess.run([cli, *args], capture_output=True, text=True,
                          timeout=120,
                          env=dict(os.environ, GRIT_TPU_SOCKET_DIR=sockdir))


@pytest.fixture
def resumed(workload, cli):
    """Hands the workload over running, and leaves it running."""
    proc, sockdir = workload
    yield proc, sockdir
    r = _run(cli, sockdir, "--status", "--pid", str(proc.pid))
    if json.loads(r.stdout)["paused"]:
        assert _run(cli, sockdir, "--resume", "--pid",
                    str(proc.pid)).returncode == 0


class TestGpuCheckpointCli:
    def test_cli_status_quiesce_dump_resume(self, resumed, cli, tmp_path):
        proc, sockdir = resumed
        pid = str(proc.pid)

        r = _run(cli, sockdir, "--status", "--pid", pid)
        assert r.returncode == 0, r.stderr
        assert json.loads(r.stdout)["paused"] is False

        r = _run(cli, sockdir, "--quiesce", "--pid", pid)
        assert r.returncode == 0, r.stderr
        step = json.loads(r.stdout)["step"]

        d = str(tmp_path / "snap")
        r = _run(cli, sockdir, "--dump", "--pid", pid, "--dir", d)
        assert r.returncode == 0, r.stderr
        assert json.loads(r.stdout)["ok"] is True
        assert snapshot_exists(d)
        assert SnapshotManifest.load(d).meta["step"] == step

        r = _run(cli, sockdir, "--resume", "--pid", pid)
        assert r.returncode == 0, r.stderr

    def test_cli_dump_restores_the_parked_state(self, resumed, cli, tmp_path):
        """The snapshot the CLI had the agentlet write is the state at the
        parked step, read back by the port's restore."""
        proc, sockdir = resumed
        pid = str(proc.pid)
        r = _run(cli, sockdir, "--quiesce", "--pid", pid)
        step = json.loads(r.stdout)["step"]
        d = str(tmp_path / "snap")
        assert _run(cli, sockdir, "--dump", "--pid", pid, "--dir",
                    d).returncode == 0
        assert _run(cli, sockdir, "--resume", "--pid", pid).returncode == 0
        got = restore_snapshot(d)
        assert int(got["['step']"]) == step
        assert got["['w']"].tolist() == [float(step)] * 4

    def test_cli_delta_dump_against_base(self, resumed, cli, tmp_path):
        """--dump --base: a pre-copy delta; in one quiesce window the state
        is unchanged, so the delta is all references."""
        proc, sockdir = resumed
        pid = str(proc.pid)
        base_d, delta_d = str(tmp_path / "base"), str(tmp_path / "delta")
        assert _run(cli, sockdir, "--quiesce", "--pid", pid).returncode == 0
        r = _run(cli, sockdir, "--dump", "--pid", pid, "--dir", base_d)
        assert r.returncode == 0, r.stderr
        r = _run(cli, sockdir, "--dump", "--pid", pid, "--dir", delta_d,
                 "--base", base_d)
        assert r.returncode == 0, r.stderr
        assert snapshot_exists(delta_d)
        assert snapshot_delta_nbytes(delta_d) == 0
        assert snapshot_nbytes(delta_d) == snapshot_nbytes(base_d)
        assert _run(cli, sockdir, "--resume", "--pid", pid).returncode == 0

    def test_cli_toggle_flips_state(self, resumed, cli):
        proc, sockdir = resumed
        pid = str(proc.pid)
        r = _run(cli, sockdir, "--toggle", "--pid", pid)
        assert r.returncode == 0, r.stderr
        r = _run(cli, sockdir, "--status", "--pid", pid)
        assert json.loads(r.stdout)["paused"] is True
        r = _run(cli, sockdir, "--toggle", "--pid", pid)
        assert r.returncode == 0
        time.sleep(0.1)
        r = _run(cli, sockdir, "--status", "--pid", pid)
        assert json.loads(r.stdout)["paused"] is False

    def test_cli_no_agentlet(self, cli, tmp_path):
        r = _run(cli, str(tmp_path), "--status", "--pid", "999999")
        assert r.returncode == 1
        assert "cannot reach agentlet" in r.stderr

    def test_cli_reports_an_agentlet_error(self, resumed, cli, tmp_path):
        """A dump the agentlet refuses (not parked) prints its error reply
        and exits 1, as the reference CLI does."""
        proc, sockdir = resumed
        r = _run(cli, sockdir, "--dump", "--pid", str(proc.pid), "--dir",
                 str(tmp_path / "snap"))
        assert r.returncode == 1
        assert json.loads(r.stdout)["ok"] is False
        assert not snapshot_exists(str(tmp_path / "snap"))

    @pytest.mark.parametrize("args", [
        [], ["--status"], ["--dump", "--pid", "7"], ["--pid", "7"],
        ["--status", "--pid", "7", "--bogus"]],
        ids=["none", "no-pid", "dump-without-dir", "no-action", "unknown"])
    def test_cli_usage_errors_exit_2(self, cli, tmp_path, args):
        r = _run(cli, str(tmp_path), *args)
        assert r.returncode == 2
        assert r.stderr.startswith("usage: gpu-checkpoint")


class _Desc(ctypes.Structure):
    _fields_ = [
        ("name", ctypes.c_char_p),
        ("init", ctypes.c_void_p),
        ("exit", ctypes.c_void_p),
        ("version", ctypes.c_int),
        ("max_hooks", ctypes.c_int),
        ("hooks", ctypes.c_void_p * 12),
    ]


def _load(path):
    lib = ctypes.CDLL(path)
    return lib, _Desc.in_dll(lib, "CR_PLUGIN_DESC")


def _hook1(desc, slot):
    return ctypes.CFUNCTYPE(ctypes.c_int, ctypes.c_int)(desc.hooks[slot])


def _hook2(desc, slot):
    return ctypes.CFUNCTYPE(ctypes.c_int, ctypes.c_int,
                            ctypes.c_int)(desc.hooks[slot])


@pytest.fixture
def plugin_env(monkeypatch, cli, tmp_path):
    """The plugin's environment: the CLI it execs and an image dir."""
    img = tmp_path / "criu-img"
    img.mkdir()
    monkeypatch.setenv("GRIT_TPU_IMAGE_DIR", str(img))
    monkeypatch.setenv("GRIT_TPU_CHECKPOINT_BIN", cli)
    return img


NVIDIA_PATHS = ["/dev/nvidia0", "/dev/nvidia7", "/dev/nvidia15",
                "/dev/nvidiactl", "/dev/nvidia-uvm", "/dev/nvidia-uvm-tools",
                "/dev/nvidia-modeset", "/dev/nvidia-nvswitchctl",
                "/dev/nvidia-caps/nvidia-cap1"]
OTHER_PATHS = ["/dev/null", "/dev/accel0", "/dev/vfio/0", "/dev/dri/card0",
               "/dev/nvidia", "/dev/nvidia-", "/dev/nvidiax", "/dev/nvidia0p1",
               "/tmp/dev/nvidia0", "nvidia0", "", "/dev/nvme0n1"]


class TestCriuGpuPlugin:
    def test_desc_shape(self, plugin):
        _, desc = _load(plugin)
        assert desc.name == b"grit_gpu_plugin"
        assert desc.version == 2
        assert desc.max_hooks == 12
        # RESUME_DEVICES_LATE (9), PAUSE_DEVICES (10), CHECKPOINT_DEVICES (11)
        assert desc.hooks[9] and desc.hooks[10] and desc.hooks[11]
        assert desc.hooks[2] and desc.hooks[3]  # the ext-file pair
        assert not any(desc.hooks[i] for i in (0, 1, 4, 5, 6, 7, 8))

    def test_pause_checkpoint_resume_hooks_drive_workload(
            self, resumed, plugin, plugin_env, monkeypatch):
        proc, sockdir = resumed
        monkeypatch.setenv("GRIT_TPU_SOCKET_DIR", sockdir)
        _, desc = _load(plugin)
        assert _hook1(desc, 10)(proc.pid) == 0  # pause
        with ToggleStatus(sockdir, proc.pid) as st:
            assert st()["paused"] is True
        assert _hook1(desc, 11)(proc.pid) == 0  # checkpoint
        snap = str(plugin_env / "tpu")
        assert snapshot_exists(snap)
        step = SnapshotManifest.load(snap).meta["step"]
        assert int(restore_snapshot(snap)["['step']"]) == step
        assert _hook1(desc, 9)(proc.pid) == 0  # resume
        with ToggleStatus(sockdir, proc.pid) as st:
            deadline = time.monotonic() + 30
            while st()["step"] <= step:
                assert time.monotonic() < deadline, "the loop did not resume"
                time.sleep(0.02)

    def test_device_hooks_pass_a_pod_without_agentlet(self, plugin,
                                                      plugin_env, tmp_path,
                                                      monkeypatch):
        """A CPU-only pod (no agentlet socket) has no device state: the
        pause, checkpoint and resume hooks return 0 and write nothing."""
        monkeypatch.setenv("GRIT_TPU_SOCKET_DIR", str(tmp_path))
        _, desc = _load(plugin)
        for slot in (10, 11, 9):
            assert _hook1(desc, slot)(999999) == 0
        assert not os.path.exists(plugin_env / "tpu")

    @pytest.mark.parametrize("kind", ["devnull", "file", "pipe"])
    def test_dump_ext_file_declines_fds_it_does_not_own(self, plugin,
                                                        plugin_env, tmp_path,
                                                        kind):
        _, desc = _load(plugin)
        dump = _hook2(desc, 2)
        if kind == "pipe":
            fd, other = os.pipe()
        else:
            path = "/dev/null" if kind == "devnull" else str(tmp_path / "f")
            fd = os.open(path, os.O_RDWR | os.O_CREAT, 0o600)
            other = None
        try:
            assert dump(fd, 1) == -errno.ENOTSUP
        finally:
            os.close(fd)
            if other is not None:
                os.close(other)
        assert os.listdir(plugin_env) == []

    def test_restore_ext_file_reopens_nothing(self, plugin, plugin_env):
        _, desc = _load(plugin)
        restore = _hook1(desc, 3)
        (plugin_env / "tpu-fd-1.img").write_text("/dev/nvidiactl 2\n")
        assert restore(1) == -errno.ENOTSUP
        assert restore(2) == -errno.ENOTSUP

    @pytest.mark.parametrize("path", NVIDIA_PATHS + OTHER_PATHS)
    def test_classifier_accepts_nvidia_device_nodes_only(self, plugin, path):
        lib, _ = _load(plugin)
        fn = getattr(lib, native.CLASSIFIER)
        fn.argtypes = [ctypes.c_char_p]
        fn.restype = ctypes.c_int
        assert fn(path.encode()) == (1 if path in NVIDIA_PATHS else 0)

    @pytest.mark.cuda
    def test_dump_ext_file_refuses_a_real_nvidia_fd(self, plugin, tmp_path):
        """On a GPU node: an fd open on /dev/nvidiactl is refused with a
        stderr line naming it, and an errno CRIU stops at (not -ENOTSUP).
        The hook runs in a child, whose stderr the test reads."""
        if not os.path.exists("/dev/nvidiactl"):
            pytest.skip("needs an NVIDIA device node (/dev/nvidiactl)")
        code = textwrap.dedent(f"""
            import ctypes, os, sys
            sys.path.insert(0, {REPO!r})
            from tests.test_torch_criu import _load, _hook2
            _, desc = _load({plugin!r})
            fd = os.open("/dev/nvidiactl", os.O_RDWR)
            print(_hook2(desc, 2)(fd, 3))
        """)
        r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                           text=True, timeout=60)
        rc = int(r.stdout.strip())
        assert rc < 0 and rc != -errno.ENOTSUP
        assert "/dev/nvidiactl" in r.stderr
        assert "agentlet's snapshot" in r.stderr


class ToggleStatus:
    """The port's toggle client, for reading a workload's status."""

    def __init__(self, sockdir: str, pid: int) -> None:
        from grit_tpu_torch.device.agentlet import ToggleClient

        self._c = ToggleClient(0, path=os.path.join(
            sockdir, f"grit-tpu-{pid}.sock"), timeout=30)

    def __enter__(self):
        return self._c.status

    def __exit__(self, *exc) -> None:
        self._c.close()


class TestNativeBuild:
    def test_outputs_are_named_by_digest_and_reused(self, cli, plugin):
        for path, stem in ((cli, "gpu-checkpoint"),
                           (plugin, "grit_gpu_plugin")):
            assert re.fullmatch(rf"{stem}-[0-9a-f]{{16}}(\.so)?",
                                os.path.basename(path)), path
            mtime = os.stat(path).st_mtime_ns
        assert native.cli_path() == cli and native.plugin_path() == plugin
        assert os.stat(plugin).st_mtime_ns == mtime

    def test_builds_into_the_build_dir_knob(self, monkeypatch, tmp_path):
        monkeypatch.setenv("GRIT_TPU_COMPILE_CACHE", str(tmp_path / "cache"))
        path = native.cli_path()
        assert os.path.dirname(path) == str(tmp_path / "cache")
        r = subprocess.run([path], capture_output=True, text=True)
        assert r.returncode == 2

    def test_a_missing_compiler_raises(self, monkeypatch, tmp_path):
        monkeypatch.setenv("GRIT_TPU_COMPILE_CACHE", str(tmp_path / "cache"))
        monkeypatch.setattr(native, "COMPILER", "no-such-cc-for-grit")
        with pytest.raises(native.NativeBuildError, match="no-such-cc"):
            native.plugin_path()
        assert not os.path.exists(tmp_path / "cache") or \
            os.listdir(tmp_path / "cache") == []

    def test_a_failed_build_raises_with_the_compiler_output(
            self, monkeypatch, tmp_path):
        csrc = tmp_path / "csrc"
        csrc.mkdir()
        (csrc / "gpu_checkpoint.c").write_text("int main(void) { return x; }\n")
        monkeypatch.setattr(native, "CSRC", csrc)
        monkeypatch.setenv("GRIT_TPU_COMPILE_CACHE", str(tmp_path / "cache"))
        with pytest.raises(native.NativeBuildError,
                           match="gpu_checkpoint.c") as info:
            native.cli_path()
        assert "error" in str(info.value)

    def test_sources_include_nothing_of_the_jax_package(self):
        for name in native.CLI_SOURCES + native.PLUGIN_SOURCES:
            text = (native.CSRC / name).read_text()
            includes = re.findall(r'#include\s+([<"][^>"]+[>"])', text)
            assert includes or name.endswith(".h"), name
            for inc in includes:
                # Only system headers, and the port's own API header.
                assert inc.startswith("<") or inc == '"criu_plugin_api.h"', \
                    (name, inc)
