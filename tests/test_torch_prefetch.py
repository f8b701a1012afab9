"""The port's restore prefetch (``grit_tpu_torch.prefetch``), tested by
what it does (the reference has no test of its own): a port workload
migrated on the CPU by the reference harness under the flight log the
unchanged agent created carries one ``restart.start`` from the restored
process, before its ``restart.end`` and ``place.start``, and gritscope
reports the ``restart`` phase; the prefetch warms the snapshot's files,
emits on the governing log and starts the workload's server; a missing
or unreadable directory returns None and raises nothing; and the
prefetch and the observability modules it starts import no torch, jax
or ``grit_tpu``, while ``workload.py`` calls it before its first torch
import."""

from __future__ import annotations

import ast
import json
import os
import socket
import subprocess
import sys
import textwrap
import threading

import pytest

from grit_tpu.obs import flight as ref_flight
from grit_tpu_torch import prefetch
from grit_tpu_torch.metadata import FLIGHT_LOG_FILE
from grit_tpu_torch.obs import flight
from grit_tpu_torch.obs import sampler as port_sampler
from grit_tpu_torch.obs import server as port_server

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    for knob in ("GRIT_TPU_RESTORE_DIR", "GRIT_WORKLOAD_METRICS_PORT",
                 "GRIT_FLIGHT_DIR"):
        monkeypatch.delenv(knob, raising=False)
    flight.reset()
    ref_flight.reset()
    port_sampler.reset()
    port_server._workload_srv = None
    yield
    if port_server._workload_srv is not None:
        port_server._workload_srv.shutdown()
        port_server._workload_srv.server_close()
    port_server._workload_srv = None
    port_sampler.reset()
    flight.reset()
    ref_flight.reset()


def test_harness_migration_opens_the_restart_window(tmp_path, monkeypatch):
    """The reference agent checkpoints and stages a port workload with
    ``GRIT_FLIGHT=1``; the restored process's prefetch emits one
    ``restart.start`` on the stage's log, before its ``restart.end`` and
    ``place.start``, and gritscope's report has the ``restart`` phase."""
    from grit_tpu.device.hook import HBM_SUBDIR
    from grit_tpu.harness import MigrationHarness
    from test_torch_agentlet import TORCH_LLAMA_WORKLOAD
    from tools.gritscope import build_report, group_migrations, load_events

    monkeypatch.setenv("GRIT_FLIGHT", "1")
    h = MigrationHarness(str(tmp_path), workload_src=TORCH_LLAMA_WORKLOAD)
    src = h.spawn(n_steps=1000)
    h.wait_ready(src)
    h.wait_until_step(src, 2)
    h.checkpoint(h.make_source_runtime(src.pid))
    src.kill()
    src.wait()
    manifest = os.path.join(h.pvc, "main", HBM_SUBDIR, "MANIFEST.json")
    cut = json.load(open(manifest))["meta"]["step"]
    h.stage()
    dst = h.spawn(extra_env=h.restore_env(h.shim_restore_spec()),
                  n_steps=cut + 1, cache="dst")
    out = dst.stdout.read().splitlines()
    assert dst.wait() == 0, out[-5:]
    assert f"RESTORED {cut}" in out

    events = flight.read_flight_file(os.path.join(h.dst_host, FLIGHT_LOG_FILE))
    mine = [e for e in events if e["pid"] == dst.pid]
    names = [e["ev"] for e in mine]
    assert names.count("restart.start") == 1, names
    assert names.index("restart.start") < names.index("restart.end") \
        < names.index("place.start")
    start = mine[names.index("restart.start")]
    assert (start["uid"], start["role"]) == ("ck", "device")
    report = build_report(
        group_migrations(load_events([h.host_work, h.dst_host]))["ck"],
        uid="ck")
    assert "restart" in report["phases"], sorted(report["phases"])


def test_prefetch_warms_emits_and_serves(tmp_path, monkeypatch):
    root = tmp_path / "ck"
    snap = root / "main" / "hbm"
    snap.mkdir(parents=True)
    for name, n in (("data-h0000.bin", 3 << 20), ("MANIFEST.json", 100)):
        (snap / name).write_bytes(os.urandom(n))
    monkeypatch.setenv("GRIT_FLIGHT", "1")
    ref_flight.configure(str(root), "destination")  # the agent's log
    monkeypatch.delenv("GRIT_FLIGHT")  # the restored pod's env predates it
    ref_flight.reset()
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    monkeypatch.setenv("GRIT_WORKLOAD_METRICS_PORT", str(port))
    monkeypatch.setenv("GRIT_TPU_RESTORE_DIR", str(snap))
    read: list[str] = []
    real = prefetch._warm_file

    def spy(path):
        read.append(os.path.basename(path))
        real(path)

    monkeypatch.setattr(prefetch, "_warm_file", spy)
    t = prefetch.start_restore_prefetch()
    assert isinstance(t, threading.Thread)
    assert (t.name, t.daemon) == ("grit-restore-prefetch", True)
    t.join(30)
    assert sorted(read) == ["MANIFEST.json", "data-h0000.bin"]
    evs = [(e["ev"], e["role"]) for e in ref_flight.read_flight_file(
        str(root / FLIGHT_LOG_FILE))]
    assert evs == [("migration.configure", "destination"),
                   ("restart.start", "device")]
    assert port_server._workload_srv is not None
    assert port_server._workload_srv.server_address[1] == port
    assert port_sampler.default_sampler().running


@pytest.mark.parametrize("case", ["unset", "missing", "a-file",
                                  "under-a-file"])
def test_missing_or_unreadable_dir_returns_none(case, tmp_path, monkeypatch):
    afile = tmp_path / "afile"
    afile.write_text("x")
    where = {"unset": None, "missing": str(tmp_path / "nope"),
             "a-file": str(afile), "under-a-file": str(afile / "hbm")}[case]
    if where is not None:
        monkeypatch.setenv("GRIT_TPU_RESTORE_DIR", where)
    monkeypatch.setenv("GRIT_WORKLOAD_METRICS_PORT", "1")
    before = {t.ident for t in threading.enumerate()}
    assert prefetch.start_restore_prefetch() is None
    assert prefetch.start_restore_prefetch(where) is None
    assert port_server._workload_srv is None
    assert {t.ident for t in threading.enumerate()} <= before


def test_prefetch_and_the_obs_it_starts_import_no_torch(tmp_path):
    """In a fresh interpreter: after the prefetch, its server and its
    sampler's first ticks (the codec probe, the ledger, the progress
    gauges) and a ``/version`` request, no torch, jax or ``grit_tpu``
    module is loaded."""
    snap = tmp_path / "snap"
    snap.mkdir()
    (snap / "data-h0000.bin").write_bytes(b"\0" * 4096)
    code = textwrap.dedent("""
        import sys, time, urllib.request
        from grit_tpu_torch.prefetch import start_restore_prefetch
        t = start_restore_prefetch()
        assert t is not None
        t.join(30)
        import grit_tpu_torch.version, grit_tpu_torch.obs.profile
        from grit_tpu_torch.obs import sampler
        assert sampler.default_sampler().running
        time.sleep(0.3)  # a few sampler ticks
        port = int(sys.argv[1])
        body = urllib.request.urlopen(
            f"http://127.0.0.1:{port}/version", timeout=10).read().decode()
        assert body.startswith("grit-tpu "), body
        bad = sorted(m for m in sys.modules
                     if m.split(".")[0] in ("torch", "jax", "jaxlib",
                                            "grit_tpu", "numpy"))
        print(repr(bad))
    """)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("GRIT_", "JAX_"))}
    env.update(GRIT_TPU_RESTORE_DIR=str(snap),
               GRIT_WORKLOAD_METRICS_PORT=str(port), GRIT_OBS_SAMPLE_S="0.05",
               PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", code, str(port)], cwd=REPO,
                          env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().splitlines()[-1] == "[]"


def test_workload_calls_the_prefetch_before_its_first_torch_import():
    """In ``workload.py`` the call of ``start_restore_prefetch`` comes
    before ``import torch`` and before every import of another
    ``grit_tpu_torch`` module, and only when it runs as a program."""
    path = os.path.join(REPO, "grit_tpu_torch", "workload.py")
    with open(path) as f:
        tree = ast.parse(f.read())
    call_line = first_import = None
    for node in tree.body:
        if isinstance(node, ast.If) and call_line is None:
            test = ast.unparse(node.test)
            for sub in ast.walk(node):
                if isinstance(sub, ast.Call) and \
                        ast.unparse(sub.func) == "start_restore_prefetch":
                    assert test == "__name__ == '__main__'", test
                    call_line = sub.lineno
        if isinstance(node, (ast.Import, ast.ImportFrom)):
            mods = ([a.name for a in node.names]
                    if isinstance(node, ast.Import) else [node.module])
            if any(m.split(".")[0] in ("torch", "grit_tpu_torch")
                   for m in mods):
                first_import = first_import or node.lineno
    assert call_line is not None and first_import is not None
    assert call_line < first_import
