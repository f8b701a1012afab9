"""The port's node-agent device hook (``grit_tpu_torch.device.hook``)
against the port's agentlet, the kernel-library carry, and the hook in
the unchanged reference agent: the reference ``MigrationHarness`` and
``grit_tpu.agent.app.run`` migrate the port's MNIST workload through it,
the latter in a process where jax cannot be imported."""

from __future__ import annotations

import json
import logging
import os
import subprocess
import sys
import textwrap
import threading
import time

import pytest
import torch

from grit_tpu import harness as ref_harness
from grit_tpu.harness import MigrationHarness, read_losses
from grit_tpu_torch.device import hook as phook
from grit_tpu_torch.device.agentlet import ToggleClient, socket_path
from grit_tpu_torch.device.snapshot import (
    SnapshotManifest,
    last_restore_pipeline,
    restore_snapshot,
    snapshot_exists,
    write_snapshot,
)
from grit_tpu_torch.ops import build
from tests.test_torch_agentlet import REPO, _Loop

HBM = phook.HBM_SUBDIR


def _step(lp: _Loop) -> int:
    return int(lp.state["step"])


def _wait_steps_past(lp: _Loop, step: int) -> None:
    deadline = time.monotonic() + 10
    while _step(lp) <= step and time.monotonic() < deadline:
        time.sleep(0.005)
    assert _step(lp) > step, "the loop did not step on"


@pytest.fixture
def sockdir(tmp_path, monkeypatch):
    monkeypatch.setenv("GRIT_TPU_SOCKET_DIR", str(tmp_path / "socks"))
    os.makedirs(tmp_path / "socks")
    return str(tmp_path / "socks")


@pytest.fixture
def loop(sockdir):
    lp = _Loop()
    yield lp
    lp.close()


@pytest.fixture
def quiesces(monkeypatch):
    """The dump specs the hook's quiesces carry."""
    seen: list = []
    orig = ToggleClient.quiesce

    def spy(self, dump_spec=None, **kw):
        seen.append(dump_spec)
        return orig(self, dump_spec=dump_spec, **kw)

    monkeypatch.setattr(ToggleClient, "quiesce", spy)
    return seen


# -- the hook against the port's agentlet ------------------------------------------


@pytest.mark.parametrize("speculate", ["1", "0"])
def test_dump_parks_dumps_and_resume_unparks(loop, tmp_path, monkeypatch,
                                             quiesces, speculate):
    """``dump`` quiesces (pre-announcing the dump spec while speculation is
    on), leaves the committed snapshot in ``<dest>/hbm`` with the workload
    parked at the cut, and ``resume`` unparks it."""
    monkeypatch.setenv("GRIT_SNAP_SPECULATE", speculate)
    hook = phook.TpuDeviceCheckpointHook(timeout=30)
    dest, base, mirror = (str(tmp_path / n) for n in ("ckpt", "base", "pvc"))
    write_snapshot(os.path.join(base, HBM), loop.state)
    assert hook.dump(os.getpid(), dest, base=os.path.join(base, HBM),
                     mirror=mirror) is None
    snap = os.path.join(dest, HBM)
    step = SnapshotManifest.load(snap).meta["step"]
    time.sleep(0.05)
    assert _step(loop) == step and loop.agentlet.paused
    assert snapshot_exists(os.path.join(mirror, HBM))
    want_spec = {"dir": snap, "base": os.path.join(base, HBM),
                 "mirror": os.path.join(mirror, HBM)}
    assert quiesces == [want_spec if speculate == "1" else None]
    got = restore_snapshot(snap)
    assert torch.equal(got["['w']"], torch.full((4,), float(step)))
    hook.resume(os.getpid())
    _wait_steps_past(loop, step)


@pytest.mark.parametrize("speculate", ["1", "0"])
def test_predump_falls_back_loudly_and_keeps_training(loop, tmp_path,
                                                      monkeypatch, caplog,
                                                      speculate):
    """``predump``: with speculation on, the non-parking probe is served
    and the hook never falls back; with it off, the parked pass runs;
    either way a hashed, mirrored pre-copy base is committed and the loop
    keeps stepping. (A failing probe's loud fallback is
    ``test_failed_probe_falls_back_loudly_to_the_parked_pass``.)"""
    monkeypatch.setenv("GRIT_SNAP_SPECULATE", speculate)
    hook = phook.TpuDeviceCheckpointHook(timeout=30)
    dest, mirror = str(tmp_path / "precopy"), str(tmp_path / "pvc")
    with caplog.at_level(logging.WARNING, logger=phook.log.name):
        hook.predump(os.getpid(), dest, mirror=mirror)
    fell_back = [r for r in caplog.records
                 if "speculative predump probe failed" in r.getMessage()]
    assert fell_back == []
    manifest = SnapshotManifest.load(os.path.join(dest, HBM))
    assert all("sha256" in c for rec in manifest.arrays for c in rec["chunks"])
    assert snapshot_exists(os.path.join(mirror, HBM))
    _wait_steps_past(loop, manifest.meta["step"])
    assert not loop.agentlet.paused


def test_reattach_reloads_while_parked_then_unparks(sockdir, tmp_path):
    """``reattach``: the parked agentlet's ``reload_fn`` reloads the state
    from ``<dir>/hbm`` before the loop steps again."""
    lp = _Loop(reload=True)
    try:
        hook = phook.TpuDeviceCheckpointHook(timeout=30)
        dest = str(tmp_path / "ckpt")
        hook.dump(os.getpid(), dest)
        step = SnapshotManifest.load(os.path.join(dest, HBM)).meta["step"]
        # What a process restore hands the loop: host state, stale device state.
        lp.state = {"w": torch.full((4,), -7.0), "step": lp.state["step"]}
        hook.reattach(os.getpid(), dest)
        assert lp.reloaded == [os.path.join(dest, HBM)]
        _wait_steps_past(lp, step)
        assert float(lp.state["w"][0]) > step  # stepped on from the reload
    finally:
        lp.close()


def test_reattach_without_reload_fn_is_refused(loop, tmp_path):
    hook = phook.TpuDeviceCheckpointHook(timeout=30)
    dest = str(tmp_path / "ckpt")
    hook.dump(os.getpid(), dest)
    with pytest.raises(RuntimeError, match="reload_fn"):
        hook.reattach(os.getpid(), dest)
    assert loop.agentlet.paused  # the refusal does not unpark
    step = _step(loop)
    hook.resume(os.getpid())
    _wait_steps_past(loop, step)


@pytest.mark.parametrize("nonce", ["", "3"])
def test_slice_hosts_send_the_gang_cut(loop, tmp_path, monkeypatch, nonce):
    """Under ``GRIT_SLICE_HOSTS=2`` the hook's quiesce asks for the slice
    cut, as the reference hook's does: ``slice``, the dest dir as
    ``flight_dir``, ``GRIT_SLICE_NONCE`` (``"0"`` when unset) and the
    dump spec. A workload without a gate parks at its next boundary."""
    monkeypatch.setenv("GRIT_SLICE_HOSTS", "2")
    monkeypatch.setenv("GRIT_SLICE_NONCE", nonce)
    sent: list = []
    orig = ToggleClient.request

    def spy(self, op, **fields):
        sent.append((op, fields))
        return orig(self, op, **fields)

    monkeypatch.setattr(ToggleClient, "request", spy)
    hook = phook.TpuDeviceCheckpointHook(timeout=30)
    dest = str(tmp_path / "c")
    hook.dump(os.getpid(), dest)
    hbm = os.path.join(dest, HBM)
    assert sent[0] == ("quiesce", {"slice": True, "flight_dir": dest,
                                   "slice_nonce": nonce or "0",
                                   "dump": {"dir": hbm}})
    assert [op for op, _ in sent] == ["quiesce", "dump"]
    assert snapshot_exists(hbm) and loop.agentlet.paused
    hook.resume(os.getpid())
    _wait_steps_past(loop, SnapshotManifest.load(hbm).meta["step"])


def test_auto_hook_skips_a_pid_without_agentlet_loudly(sockdir, tmp_path,
                                                       caplog):
    """No agentlet socket: the dump warns and returns None, the pre-copy
    pass does nothing, and the resume touches no socket."""
    hook = phook.AutoDeviceHook(timeout=5)
    pid = 2 ** 22 + 11  # above any pid_max: no such process, no socket
    with caplog.at_level(logging.WARNING, logger=phook.log.name):
        assert hook.dump(pid, str(tmp_path / "ckpt")) is None
    msg = [r.getMessage() for r in caplog.records]
    assert any(f"no agentlet socket for pid {pid}" in m
               and "incomplete" in m for m in msg), msg
    hook.predump(pid, str(tmp_path / "pre"))
    hook.resume(pid)
    assert not os.path.exists(tmp_path / "ckpt") and \
        not os.path.exists(tmp_path / "pre")


def test_auto_hook_drives_a_workload_with_an_agentlet(loop, tmp_path):
    hook = phook.AutoDeviceHook(timeout=30)
    hook.predump(os.getpid(), str(tmp_path / "pre"))
    hook.dump(os.getpid(), str(tmp_path / "ckpt"),
              base=str(tmp_path / "pre" / HBM))
    # Speculation on (the default): the blackout re-ship deltas against
    # its own -spec pass, which deltas against the pre-copy base.
    manifest = json.load(open(tmp_path / "ckpt" / HBM / "MANIFEST.json"))
    assert manifest["base"] == os.path.join("..", HBM + "-spec")
    spec = json.load(open(tmp_path / "ckpt" / (HBM + "-spec") / "MANIFEST.json"))
    assert spec["base"] == os.path.join("..", "..", "pre", HBM)
    step = _step(loop)
    hook.resume(os.getpid())
    _wait_steps_past(loop, step)


@pytest.mark.parametrize("status, want", [
    ("Name:\tpython\nNSpid:\t4242\t17\nPPid:\t1\n", 17),
    ("Name:\tpython\nPPid:\t1\n", 4242),
    ("NSpid:\tnot-a-pid\n", 4242),
    (None, 4242),
], ids=["nested", "no-nspid-line", "malformed", "no-proc-entry"])
def test_namespace_pid_from_proc_status(monkeypatch, status, want):
    import io

    def fake_open(path, *args, **kwargs):
        assert path == "/proc/4242/status"
        if status is None:
            raise FileNotFoundError(path)
        return io.StringIO(status)

    monkeypatch.setattr(phook, "open", fake_open, raising=False)
    assert phook._namespace_pid(4242) == want


@pytest.mark.parametrize("present, want", [
    ((4242, 17), 4242), ((17,), 17), ((), 4242)],
    ids=["host-socket", "namespace-socket", "none"])
def test_agentlet_pid_prefers_the_host_socket(sockdir, monkeypatch, present,
                                              want):
    monkeypatch.setattr(phook, "_namespace_pid", lambda pid: 17)
    for pid in present:
        open(socket_path(pid), "w").close()
    assert phook._agentlet_pid(4242) == want


# -- the kernel-library carry -----------------------------------------------------


def _plant(directory, names, content=b"\x7fELF library"):
    os.makedirs(directory, exist_ok=True)
    for n in names:
        with open(os.path.join(directory, n), "wb") as f:
            f.write(content)


LIBS = [build.library_path(stem).name for stem in build.SOURCES]


def test_save_copies_missing_libraries_only(tmp_path, monkeypatch):
    cache, snap = str(tmp_path / "cache"), str(tmp_path / "snap")
    monkeypatch.delenv("GRIT_TPU_COMPILE_CACHE", raising=False)
    assert build.save_compile_cache(snap) == 0
    # Beside this checkout's three: a library of older sources (another
    # digest), a ptxas report and a half-written copy, none carried.
    stale = LIBS[0].rsplit("-", 1)[0] + "-0123456789abcdef.so"
    _plant(cache, LIBS + [stale, "flash_fwd.ptxas.log", LIBS[0] + ".tmp-123"])
    monkeypatch.setenv("GRIT_TPU_COMPILE_CACHE", cache)
    carried = os.path.join(snap, build.COMPILE_CACHE_SUBDIR)
    _plant(carried, [LIBS[1]], b"already carried")
    assert build.save_compile_cache(snap) == 2
    assert sorted(os.listdir(carried)) == sorted(LIBS)
    assert open(os.path.join(carried, LIBS[1]), "rb").read() == b"already carried"
    assert build.save_compile_cache(snap) == 0


def test_seed_fills_the_cache_from_the_snapshot(tmp_path, monkeypatch):
    snap, cache = str(tmp_path / "snap"), str(tmp_path / "fresh" / "cache")
    monkeypatch.setenv("GRIT_TPU_COMPILE_CACHE", cache)
    assert build.seed_compile_cache(snap) == 0  # nothing carried
    stale = LIBS[1].rsplit("-", 1)[0] + "-0123456789abcdef.so"
    _plant(os.path.join(snap, build.COMPILE_CACHE_SUBDIR), LIBS + [stale])
    monkeypatch.delenv("GRIT_TPU_COMPILE_CACHE")
    assert build.seed_compile_cache(snap) == 0  # knob unset
    monkeypatch.setenv("GRIT_TPU_COMPILE_CACHE", cache)
    assert build.seed_compile_cache(snap) == 3
    assert sorted(os.listdir(cache)) == sorted(LIBS)
    assert build.seed_compile_cache(snap) == 0


def test_build_uses_the_knob_and_a_carried_library_spares_nvcc(
        tmp_path, monkeypatch):
    """With ``GRIT_TPU_COMPILE_CACHE`` set the build dir is the knob's; the
    three libraries present under their digest names need no nvcc; one
    missing (or carried from other sources, so under another digest) needs
    it, and without nvcc that raises."""
    cache = tmp_path / "cache"
    monkeypatch.setenv("GRIT_TPU_COMPILE_CACHE", str(cache))
    assert build.build_dir() == cache
    assert all(build.library_path(s).parent == cache for s in build.SOURCES)

    def no_nvcc():
        raise build.KernelBuildError("nvcc not found (set CUDA_HOME)")

    monkeypatch.setattr(build, "nvcc_path", no_nvcc)
    _plant(str(cache), LIBS)
    assert build.build_all() == {s: cache / n for s, n in zip(build.SOURCES, LIBS)}
    os.unlink(cache / LIBS[2])
    stale = LIBS[2].rsplit("-", 1)[0] + "-0123456789abcdef.so"
    _plant(str(cache), [stale])
    with pytest.raises(build.KernelBuildError, match="nvcc"):
        build.build_all()
    monkeypatch.delenv("GRIT_TPU_COMPILE_CACHE")
    assert build.build_dir() == build.BUILD_DIR


def test_an_unloadable_library_raises(tmp_path, monkeypatch):
    """A library that does not load is an error, never a fallback."""
    cache = tmp_path / "cache"
    monkeypatch.setenv("GRIT_TPU_COMPILE_CACHE", str(cache))
    monkeypatch.setattr(build, "_fns", {})
    _plant(str(cache), LIBS, b"not an ELF file")
    with pytest.raises(build.KernelBuildError, match="does not load"):
        build.kernel("flash_fwd")


def test_snapshot_carries_and_restore_seeds(tmp_path, monkeypatch):
    """``write_snapshot`` carries the knob's libraries after its commit;
    ``restore_snapshot`` seeds a fresh knob directory from them before it
    reads anything."""
    src = str(tmp_path / "src-cache")
    _plant(src, LIBS + ["flash_fwd.ptxas.log"])
    monkeypatch.setenv("GRIT_TPU_COMPILE_CACHE", src)
    d = str(tmp_path / "snap")
    write_snapshot(d, {"w": torch.arange(6.0)})
    assert sorted(os.listdir(os.path.join(d, build.COMPILE_CACHE_SUBDIR))) == \
        sorted(LIBS)
    dst = str(tmp_path / "dst-cache")
    monkeypatch.setenv("GRIT_TPU_COMPILE_CACHE", dst)
    got = restore_snapshot(d, like={"w": torch.empty(6)})
    assert torch.equal(got["w"], torch.arange(6.0))
    assert sorted(os.listdir(dst)) == sorted(LIBS)
    assert last_restore_pipeline()["seeded"] == 3


def test_reload_seeds_the_carried_libraries_before_reload_fn(tmp_path,
                                                             monkeypatch):
    """A ``resume`` with ``reload`` seeds ``GRIT_TPU_COMPILE_CACHE`` from
    the snapshot before ``reload_fn`` runs, so a ``reload_fn`` that never
    enters ``restore_snapshot`` finds the libraries there."""
    from grit_tpu_torch.device.agentlet import Agentlet  # noqa: PLC0415

    src, dst = str(tmp_path / "src-cache"), str(tmp_path / "dst-cache")
    _plant(src, LIBS)
    monkeypatch.setenv("GRIT_TPU_COMPILE_CACHE", src)
    snap = str(tmp_path / "snap")
    write_snapshot(snap, {"w": torch.arange(3.0)})
    monkeypatch.setenv("GRIT_TPU_COMPILE_CACHE", dst)
    seen: list = []

    def reload_fn(directory):
        seen.append(sorted(os.listdir(dst)) if os.path.isdir(dst) else [])

    state = {"w": torch.zeros(3)}
    a = Agentlet(lambda: state, path=str(tmp_path / "a.sock"),
                 reload_fn=reload_fn).start()
    stop = threading.Event()

    def run():
        while not stop.is_set():
            a.checkpoint_point()
            time.sleep(0.002)

    t = threading.Thread(target=run, daemon=True)
    t.start()
    try:
        with ToggleClient(0, path=a.path, timeout=30) as c:
            c.quiesce()
            c.resume(reload=snap)
    finally:
        stop.set()
        a.stop()
        t.join(timeout=10)
    assert seen == [sorted(LIBS)]


def test_a_failed_carry_never_fails_the_commit(tmp_path, monkeypatch, caplog):
    src = str(tmp_path / "src-cache")
    _plant(src, LIBS)
    monkeypatch.setenv("GRIT_TPU_COMPILE_CACHE", src)
    d = str(tmp_path / "snap")
    write_snapshot(d, {"w": torch.ones(3)})
    os.rename(os.path.join(d, build.COMPILE_CACHE_SUBDIR), str(tmp_path / "x"))

    def broken(*args, **kwargs):
        raise PermissionError("read-only checkpoint volume")

    monkeypatch.setattr(build.shutil, "copyfile", broken)
    with caplog.at_level(logging.WARNING):
        write_snapshot(d, {"w": torch.ones(3) * 2})
    assert snapshot_exists(d)
    assert torch.equal(restore_snapshot(d)["['w']"], torch.ones(3) * 2)
    assert any("not carried" in r.getMessage() for r in caplog.records)


# -- the hook inside the reference agent ----------------------------------------------


def _drain(stream) -> None:
    """Read a running workload's stdout to its end on a thread: a full pipe
    would block its loop in a print, short of the checkpoint point."""
    threading.Thread(target=stream.read, daemon=True).start()


# The port's MNIST workload (the harness workload's twin) on the CPU.
PORT_MNIST_WORKLOAD = textwrap.dedent("""
    import runpy, sys
    import torch
    torch.set_num_threads(1)  # several test workers share a few cores
    sys.path.insert(0, {repo!r})
    sys.argv = ["grit_tpu_torch.workload", "--model", "mnist",
                "--device", "cpu"]
    runpy.run_module("grit_tpu_torch.workload", run_name="__main__")
""").format(repo=REPO)


@pytest.mark.parametrize("pre_copy", [False, True], ids=["blackout", "pre-copy"])
def test_reference_harness_migrates_the_mnist_twin_through_the_port_hook(
        tmp_path, monkeypatch, pre_copy):
    """The reference ``MigrationHarness`` with its ``AutoDeviceHook``
    replaced by the port's: checkpoint (after a pre-copy pass, whose
    speculative probe the agentlet serves), upload, kill, stage, shim restore env,
    fresh-process restore of the MNIST twin; the losses after the cut
    are the uninterrupted run's bit for bit. Libraries planted in the
    source's kernel cache travel with the snapshot into the destination's."""
    calls: list[str] = []

    class CountingHook(phook.AutoDeviceHook):
        def dump(self, pid, dest_dir, **kw):
            calls.append("dump")
            return super().dump(pid, dest_dir, **kw)

        def predump(self, pid, dest_dir, **kw):
            calls.append("predump")
            return super().predump(pid, dest_dir, **kw)

    monkeypatch.setattr(ref_harness, "AutoDeviceHook", CountingHook)
    h = MigrationHarness(str(tmp_path), workload_src=PORT_MNIST_WORKLOAD)
    _plant(h.compile_cache_dir("src"), LIBS)
    src = h.spawn(n_steps=10 ** 9)
    try:
        h.wait_ready(src)
        h.wait_until_step(src, 3)
        _drain(src.stdout)  # a step takes about a millisecond
        runtime = h.make_source_runtime(src.pid)
        shipped = h.precopy(runtime) if pre_copy else None
        h.checkpoint(runtime, pre_copy=pre_copy, preshipped=shipped)
    finally:
        src.kill()
        src.wait()
    # The pre-copy phase's convergence loop: a full pass, then delta rounds.
    assert calls[-1] == "dump" and calls.count("dump") == 1
    assert (len(calls) > 1) is pre_copy and set(calls[:-1]) <= {"predump"}
    manifest = json.load(open(os.path.join(h.pvc, "main", HBM, "MANIFEST.json")))
    cut = manifest["meta"]["step"]
    assert cut >= 3
    # The blackout's validated re-ship deltas against its -spec pass, which
    # the agent ships with it; that pass deltas against the pre-copy base.
    assert manifest["base"] == os.path.join("..", HBM + "-spec")
    spec = json.load(open(os.path.join(h.pvc, "main", HBM + "-spec",
                                       "MANIFEST.json")))
    if pre_copy:
        assert spec["base"] == os.path.join("..", "..", "main-precopy", HBM)

    # The uninterrupted run, long enough to pass the cut (an MNIST step
    # takes about a millisecond, so the cut lands where the agent got to).
    ref = h.spawn(n_steps=cut + 5)
    ref_losses = read_losses(ref.stdout.read().splitlines())
    assert ref.wait() == 0 and len(ref_losses) == cut + 5

    h.stage()
    spec = h.shim_restore_spec()
    dst = h.spawn(extra_env=h.restore_env(spec), n_steps=cut + 5, cache="dst")
    out = dst.stdout.read().splitlines()
    assert dst.wait() == 0
    assert f"RESTORED {cut}" in out
    pipeline = [json.loads(x.split(" ", 1)[1]) for x in out
                if x.startswith("RESTORE_PIPELINE ")]
    assert len(pipeline) == 1 and pipeline[0]["seeded"] == 3
    assert sorted(os.listdir(h.compile_cache_dir("dst"))) == sorted(LIBS)
    got = read_losses(out)
    assert len(got) == 5 and got == {s: x for s, x in ref_losses.items()
                                     if s > cut}


# The reference agent's entry with the port's hook, jax made unimportable.
AGENT_WITHOUT_JAX = textwrap.dedent("""
    import importlib.abc, json, os, sys
    sys.path.insert(0, {repo!r})

    class NoJax(importlib.abc.MetaPathFinder):
        def find_spec(self, name, path, target=None):
            if name.split(".")[0] in ("jax", "jaxlib", "optax", "ml_dtypes"):
                raise ImportError(f"{{name}} is not installed on this node")
            return None

    sys.meta_path.insert(0, NoJax())
    from grit_tpu.agent.app import run
    from grit_tpu.cri.runtime import (Container, FakeRuntime, OciSpec,
                                      Sandbox, SimProcess)
    from grit_tpu_torch.device.hook import AutoDeviceHook

    pid, base = int(sys.argv[1]), sys.argv[2]
    rt = FakeRuntime(log_root=os.path.join(base, "logs"))
    rt.add_sandbox(Sandbox(id="sb1", pod_name="train", pod_namespace="ns1",
                           pod_uid="uid1"))
    rt.add_container(Container(id="c1", sandbox_id="sb1", name="main",
                               spec=OciSpec(image="img")),
                     process=SimProcess(), running=True)
    rt.tasks["c1"].pid = pid
    rc = run(["--action", "checkpoint",
              "--src-dir", os.path.join(base, "host"),
              "--dst-dir", os.path.join(base, "pvc"),
              "--host-work-path", os.path.join(base, "host"),
              "--kubelet-log-path", os.path.join(base, "logs"),
              "--target-name", "train", "--target-namespace", "ns1",
              "--target-uid", "uid1"],
             runtime=rt, device_hook=AutoDeviceHook())
    bad = sorted(m for m in sys.modules
                 if m.split(".")[0] in ("jax", "jaxlib", "optax", "ml_dtypes"))
    print(json.dumps({{"rc": rc, "jax_modules": bad}}))
""").format(repo=REPO)


def test_reference_agent_runs_the_port_hook_without_jax(tmp_path):
    """``grit_tpu.agent.app.run(argv, runtime=FakeRuntime, device_hook=)``
    checkpoints a running port workload through the port's hook in a
    process where importing jax fails: a GPU node's agent needs no jax."""
    socks = tmp_path / "socks"
    socks.mkdir()
    env = dict(os.environ, GRIT_TPU_SOCKET_DIR=str(socks), N_STEPS=str(10 ** 9))
    wl = subprocess.Popen([sys.executable, "-c", PORT_MNIST_WORKLOAD],
                          cwd=REPO, env=env, stdout=subprocess.PIPE,
                          stderr=subprocess.DEVNULL, text=True)
    try:
        assert wl.stdout.readline().strip() == "READY"
        while not wl.stdout.readline().startswith("STEP 2 "):
            pass
        _drain(wl.stdout)
        out = subprocess.run(
            [sys.executable, "-c", AGENT_WITHOUT_JAX, str(wl.pid),
             str(tmp_path)], cwd=REPO, env=env, capture_output=True,
            text=True, timeout=180)
    finally:
        wl.kill()
        wl.wait()
    assert out.returncode == 0, out.stderr[-3000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result == {"rc": 0, "jax_modules": []}, out.stderr[-3000:]
    snap = tmp_path / "pvc" / "main" / HBM
    manifest = SnapshotManifest.load(str(snap))
    assert manifest.meta["step"] >= 2
    names = {rec["name"] for rec in manifest.arrays}
    assert "['params']['w_out']" in names and \
        "['opt_state'][0].mu['w0']" in names
