"""The port's fault registry (``grit_tpu_torch.faults``) held to the
reference's (``grit_tpu.faults``): the same registry of points, the same
spec syntax and modes, a literal call site in the port for each seam it
carries, and twins of the reference chaos suite's injection-site cases
(``tests/test_faults.py``, ``tests/test_serving_restore.py``) armed with
the same specs against the port's agentlet, snapshot, wire, serving
adapter and gang gate."""

from __future__ import annotations

import ast
import dataclasses
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from grit_tpu import faults as ref
from grit_tpu_torch import faults as port
from test_torch_serving_agentlet import params  # noqa: F401 — the fixture

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT_SRC = os.path.join(REPO, "grit_tpu_torch")

# The seams the port carries, each at a literal fault_point call site.
PORT_SEAMS = (
    "device.snapshot.dump", "device.snapshot.place", "device.snapshot.mirror",
    "restore.postcopy_fault", "snap.speculate", "device.agentlet.quiesce",
    "device.agentlet.dump", "device.agentlet.resume", "codec.compress",
    "codec.decompress", "wire.send", "serve.drain", "slice.barrier",
)


@pytest.fixture(autouse=True)
def _clean_faults(monkeypatch):
    monkeypatch.delenv(port.FAULT_POINTS_ENV, raising=False)
    port.reset()
    ref.reset()
    yield
    port.reset()
    ref.reset()


def arm(monkeypatch, spec: str) -> None:
    monkeypatch.setenv(port.FAULT_POINTS_ENV, spec)


# -- the registry ---------------------------------------------------------------


def test_known_points_are_the_reference_registry():
    assert port.FAULT_POINTS_ENV == ref.FAULT_POINTS_ENV
    assert port.KNOWN_POINTS == ref.KNOWN_POINTS
    assert set(PORT_SEAMS) <= set(port.KNOWN_POINTS)


# The reference suite's parse inputs (test_parse_syntax, test_parse_rejects,
# test_validate_rejects_unknown_point) and a few more edges of the grammar.
SPECS = [
    "wire.send:raise, device.snapshot.dump:delay:0.5,"
    "agent.copy.chunk_write:truncate:7:x2",
    "",
    " , ",
    "wire.send",
    "wire.send:explode",
    "wire.send:delay:soon",
    "wire.send:raise",
    "wire.snd:raise",
    "p.x:kill:7:x3",
    "slice.barrier:hang:x1,serve.drain:raise",
]


def _outcome(mod, fn: str, raw: str):
    try:
        specs = getattr(mod, fn)(raw)
    except mod.FaultSyntaxError:
        return "FaultSyntaxError"
    return {k: dataclasses.asdict(v) for k, v in specs.items()}


@pytest.mark.parametrize("fn", ["parse_fault_points", "validate_fault_points"])
@pytest.mark.parametrize("raw", SPECS)
def test_specs_parse_or_are_refused_as_the_reference(fn, raw):
    assert _outcome(port, fn, raw) == _outcome(ref, fn, raw)


# -- modes and hit counts: one scenario, run on both packages -------------------


def _raise_fires_and_counts(mod, setenv):
    setenv("p.x:raise")
    out = []
    try:
        mod.fault_point("p.x")
    except mod.FaultInjected as exc:
        out.append(str(exc))
    mod.fault_point("p.other")
    return out + [mod.hits("p.x")]


def _hit_limit_disarms(mod, setenv):
    setenv("p.x:raise:x2")
    out = []
    for _ in range(3):
        try:
            mod.fault_point("p.x")
            out.append("ok")
        except mod.FaultInjected:
            out.append("raised")
    return out + [mod.hits("p.x")]


def _env_change_rearms(mod, setenv):
    setenv("p.x:raise:x1")
    out = []
    for point, spec in (("p.x", None), ("p.x", None), ("p.x", "p.y:raise"),
                        ("p.y", None)):
        if spec is not None:
            setenv(spec)
        try:
            mod.fault_point(point)
            out.append("ok")
        except mod.FaultInjected:
            out.append("raised")
    return out


def _delay_sleeps(mod, setenv):
    setenv("p.x:delay:0.05")
    t0 = time.monotonic()
    mod.fault_point("p.x")
    return time.monotonic() - t0 >= 0.05


def _wrap_travels_as_given_type(mod, setenv):
    setenv("p.x:raise")
    try:
        mod.fault_point("p.x", wrap=ValueError)
    except ValueError as exc:
        return [type(exc).__name__, isinstance(exc.__cause__,
                                               mod.FaultInjected), str(exc)]
    return None


def _truncate_clips_writes(mod, setenv):
    setenv("p.w:truncate:3:x1")
    return [mod.fault_write("p.w", b"abcdef"), mod.fault_write("p.w", b"abcdef"),
            mod.fault_write("p.other", b"abcdef")]


def _truncate_elsewhere_raises(mod, setenv):
    setenv("p.x:truncate:3")
    try:
        mod.fault_point("p.x")
    except mod.FaultInjected as exc:
        return exc.point
    return None


def _unarmed_and_reset(mod, setenv):
    mod.fault_point("wire.send")
    setenv("p.x:raise:x1")
    first = []
    for _ in range(2):
        try:
            mod.fault_point("p.x")
            first.append("ok")
        except mod.FaultInjected:
            first.append("raised")
    mod.reset()  # forgets the counters: the point is armed again
    try:
        mod.fault_point("p.x")
        first.append("ok")
    except mod.FaultInjected:
        first.append("raised")
    return first


SCENARIOS = [_raise_fires_and_counts, _hit_limit_disarms, _env_change_rearms,
             _delay_sleeps, _wrap_travels_as_given_type, _truncate_clips_writes,
             _truncate_elsewhere_raises, _unarmed_and_reset]


@pytest.mark.parametrize("scenario", SCENARIOS, ids=lambda f: f.__name__[1:])
def test_modes_behave_as_the_reference(scenario, monkeypatch):
    def setenv(spec):
        monkeypatch.setenv(port.FAULT_POINTS_ENV, spec)

    got = scenario(port, setenv)
    monkeypatch.delenv(port.FAULT_POINTS_ENV)
    want = scenario(ref, setenv)
    assert got == want and got not in (None, False)


@pytest.mark.parametrize("module", ["grit_tpu_torch.faults", "grit_tpu.faults"])
def test_kill_mode_exits_the_process(module):
    proc = subprocess.run(
        [sys.executable, "-c",
         f"import {module} as f; f.fault_point('p.x'); print('survived')"],
        env=dict(os.environ, GRIT_FAULT_POINTS="p.x:kill:7", PYTHONPATH=REPO,
                 JAX_PLATFORMS="cpu"),
        capture_output=True, text=True, timeout=60)
    assert proc.returncode == 7
    assert "survived" not in proc.stdout


def _fault_point_literals() -> set[str]:
    found = set()
    for root, _dirs, files in os.walk(PORT_SRC):
        for name in files:
            if not name.endswith(".py"):
                continue
            with open(os.path.join(root, name)) as f:
                tree = ast.parse(f.read())
            for node in ast.walk(tree):
                if (isinstance(node, ast.Call)
                        and isinstance(node.func, ast.Attribute)
                        and node.func.attr in ("fault_point", "fault_write")
                        and node.args
                        and isinstance(node.args[0], ast.Constant)):
                    found.add(node.args[0].value)
    return found


@pytest.mark.parametrize("point", PORT_SEAMS)
def test_each_seam_has_a_literal_call_site(point):
    assert point in _fault_point_literals()


# -- injection sites (twins of the reference chaos suite's cases) ----------------


def test_agentlet_dump_fault_is_an_error_response(tmp_path, monkeypatch):
    """Twin of ``test_agentlet_dump_fault_is_error_response``."""
    from grit_tpu_torch.device.agentlet import Agentlet, ToggleClient

    monkeypatch.setenv("GRIT_TPU_SOCKET_DIR", str(tmp_path))
    arm(monkeypatch, "device.agentlet.dump:raise")
    with Agentlet(lambda: {}, path=str(tmp_path / "a.sock")) as agentlet:
        with ToggleClient(0, path=agentlet.path, timeout=10) as client:
            with pytest.raises(RuntimeError, match="injected fault"):
                client.dump(str(tmp_path / "hbm"))
            # The error response does not wedge the agentlet.
            assert client.status()["ok"]


def test_agentlet_quiesce_and_resume_faults(tmp_path, monkeypatch):
    """Twin of ``test_agentlet_quiesce_and_resume_faults``."""
    from grit_tpu_torch.device.agentlet import Agentlet, ToggleClient

    path = str(tmp_path / "a.sock")
    with Agentlet(lambda: {"x": torch.zeros(1)}, path=path):
        with ToggleClient(0, path=path, timeout=10.0) as client:
            arm(monkeypatch, "device.agentlet.quiesce:raise:x1")
            with pytest.raises(RuntimeError, match="injected fault"):
                client.quiesce()
            assert port.hits("device.agentlet.quiesce") == 1
            arm(monkeypatch, "device.agentlet.resume:raise:x1")
            with pytest.raises(RuntimeError, match="injected fault"):
                client.resume()
            assert port.hits("device.agentlet.resume") == 1


def test_snapshot_dump_and_place_faults(tmp_path, monkeypatch):
    """Twin of ``test_snapshot_dump_and_place_faults``."""
    from grit_tpu_torch.device.snapshot import restore_snapshot, write_snapshot

    d = str(tmp_path / "snap")
    arm(monkeypatch, "device.snapshot.dump:raise")
    with pytest.raises(port.FaultInjected):
        write_snapshot(d, {"w": torch.zeros(4)})
    monkeypatch.delenv(port.FAULT_POINTS_ENV)
    write_snapshot(d, {"w": torch.zeros(4)})
    arm(monkeypatch, "device.snapshot.place:raise")
    with pytest.raises(port.FaultInjected):
        restore_snapshot(d, like={"w": torch.zeros(4)})


def test_mirror_fault_abandons_the_mirror_not_the_dump(tmp_path, monkeypatch):
    """Twin of ``test_mirror_fault_abandons_mirror_not_dump``."""
    from grit_tpu_torch.device.snapshot import (
        restore_snapshot,
        snapshot_exists,
        write_snapshot,
    )

    arm(monkeypatch, "device.snapshot.mirror:raise")
    d = str(tmp_path / "snap")
    m = str(tmp_path / "mirror")
    write_snapshot(d, {"w": torch.arange(4.0)}, mirror=m)
    assert snapshot_exists(d)       # the primary committed
    assert not snapshot_exists(m)   # the mirror abandoned itself
    out = restore_snapshot(d, like={"w": torch.zeros(4)})
    assert out["w"].tolist() == [0.0, 1.0, 2.0, 3.0]


def test_restore_postcopy_fault_falls_back_to_blocking(tmp_path, monkeypatch):
    """Twin of ``test_restore_postcopy_fault_falls_back_to_blocking``: the
    armed tail falls back to the blocking restore, bit-identical."""
    from grit_tpu_torch.device.snapshot import (
        restore_snapshot,
        restore_snapshot_postcopy,
        write_snapshot,
    )

    state = {"w": torch.arange(2048.0), "b": torch.ones((8,))}
    snap = write_snapshot(str(tmp_path / "snap"), state)
    monkeypatch.setenv("GRIT_RESTORE_POSTCOPY_HOT_MB", "0")
    arm(monkeypatch, "restore.postcopy_fault:raise:x1")
    like = {k: torch.zeros_like(v) for k, v in state.items()}
    handle = restore_snapshot_postcopy(snap, like=like, device="cpu")
    lazy = handle.wait(timeout=30.0)
    assert port.hits("restore.postcopy_fault") >= 1
    truth = restore_snapshot(snap, like=like, device="cpu")
    for k in state:
        assert lazy[k].numpy().tobytes() == truth[k].numpy().tobytes(), k


def test_wire_send_fault_is_a_wire_error(tmp_path, monkeypatch):
    """Twin of ``test_wire_send_fault_is_wire_error``: the port's sender
    into the reference's receiver."""
    from grit_tpu.agent.copy import StageJournal, WireReceiver
    from grit_tpu_torch.wire import WireError, WireSender

    dst = tmp_path / "dst"
    receiver = WireReceiver(str(dst), journal=StageJournal(str(dst)))
    try:
        sender = WireSender(receiver.endpoint)
        arm(monkeypatch, "wire.send:raise")
        with pytest.raises(WireError) as err:
            sender.send_chunk("f", 0, b"data")
        assert isinstance(err.value.__cause__, port.FaultInjected)
        sender.close()
    finally:
        receiver.close()


@pytest.mark.parametrize("point", ["codec.compress", "codec.decompress"])
def test_codec_faults_travel_as_codec_errors(point, monkeypatch):
    """The codec's seams raise :class:`CodecError` (``wrap=``) in both
    packages, with the injected fault as the cause."""
    from grit_tpu import codec as ref_codec
    from grit_tpu_torch import codec

    view = np.zeros(4096, np.uint8)
    arm(monkeypatch, f"{point}:raise")
    for mod, faults_mod in ((codec, port), (ref_codec, ref)):
        with pytest.raises(mod.CodecError) as err:
            if point == "codec.compress":
                mod.compress_block(view, mod.CODEC_ZLIB)
            else:
                mod.decompress_block(mod.CODEC_ZERO, b"", 4096)
        assert isinstance(err.value.__cause__, faults_mod.FaultInjected)


def test_codec_fault_in_the_mirror_abandons_it_not_the_dump(tmp_path,
                                                            monkeypatch):
    """``codec.compress`` armed under the mirror's codec stage: the tee
    dies, the dump commits and restores."""
    from grit_tpu_torch.device.snapshot import (
        restore_snapshot,
        snapshot_exists,
        write_snapshot,
    )

    monkeypatch.setenv("GRIT_SNAPSHOT_CODEC", "zlib")
    arm(monkeypatch, "codec.compress:raise")
    d, m = str(tmp_path / "snap"), str(tmp_path / "mirror")
    write_snapshot(d, {"w": torch.zeros(1 << 16)}, mirror=m)
    assert snapshot_exists(d) and not snapshot_exists(m)
    assert restore_snapshot(d, like={"w": torch.ones(1 << 16)})["w"].sum() == 0


def test_serve_drain_fault_fails_the_quiesce_and_the_engine_serves_on(
        params, tmp_path, monkeypatch):
    """Twin of ``test_fault_serve_drain_fails_quiesce_engine_keeps_serving``."""
    from grit_tpu.device.agentlet import ToggleClient
    from test_torch_serving_agentlet import (
        PROMPT_A,
        ServeLoop,
        _adapter,
        _wait,
        drain_slot,
    )

    arm(monkeypatch, "serve.drain:raise:x1")
    adapter = _adapter(params, tmp_path, drain_mode="serialize")
    with adapter:
        sa = adapter.submit(PROMPT_A)
        loop = ServeLoop(adapter).start()
        with ToggleClient(0, path=adapter.agentlet.path) as client:
            with pytest.raises(RuntimeError, match="quiesce timeout"):
                client.request("quiesce", timeout=1.0)
            _wait(lambda: loop.error is not None, msg="fault")
            assert isinstance(loop.error, port.FaultInjected)
            assert not adapter.last_drain["ok"]
            client.resume()  # clears the stranded request
        monkeypatch.delenv(port.FAULT_POINTS_ENV)
        port.reset()
        assert len(drain_slot(adapter.engine, sa, 2)) == 2


def test_snap_speculate_fault_degrades_to_the_parked_dump_bitwise(
        tmp_path, monkeypatch):
    """An armed ``snap.speculate`` fails the concurrent pass's launch; the
    round degrades, loudly, to the parked dump, whose manifest is the one
    a dump without speculation writes."""
    from grit_tpu_torch.device.snapshot import SnapshotManifest
    from test_torch_agentlet import _Loop

    monkeypatch.setenv("GRIT_TPU_SOCKET_DIR", str(tmp_path))
    lp = _Loop()
    try:
        from grit_tpu_torch.device.agentlet import ToggleClient

        with ToggleClient(0, path=lp.agentlet.path, timeout=30) as c:
            arm(monkeypatch, "snap.speculate:raise:x1")
            spec = str(tmp_path / "spec" / "hbm")
            c.quiesce(dump_spec={"dir": spec})
            resp = c.dump(spec)
            assert port.hits("snap.speculate") == 1
            assert resp["speculative"]["outcome"] == "degraded"
            assert "injected fault" in resp["speculative"]["error"]
            assert not os.path.exists(spec + "-spec")
            plain = str(tmp_path / "plain" / "hbm")
            resp_plain = c.dump(plain)
            assert "speculative" not in resp_plain
            c.resume()
    finally:
        lp.close()
    got, want = SnapshotManifest.load(spec), SnapshotManifest.load(plain)
    assert got.meta == want.meta and "base" not in got.meta
    strip = [[{k: v for k, v in c.items() if k != "file"} for c in r["chunks"]]
             for r in got.arrays]
    assert strip == [[{k: v for k, v in c.items() if k != "file"}
                      for c in r["chunks"]] for r in want.arrays]


def test_slice_barrier_fault_latches_every_gloo_rank(tmp_path, monkeypatch):
    """Twin of ``test_barrier_fault_point_latches_failed`` on two gloo
    ranks: the armed barrier latches each rank's gate failed (the loop
    trains on), both ranks bracket the barrier on the request's flight
    log with ``ok`` false, and ``SLICE_BARRIER_SECONDS`` is set."""
    from grit_tpu_torch.obs import flight
    from grit_tpu_torch.parallel.launch import run_ranks
    from tests import torch_ranks

    monkeypatch.setenv("GRIT_FLIGHT", "1")
    flight.reset()
    ckpt = str(tmp_path / "ck")
    flight.configure(ckpt, "node")
    flight.reset()
    arm(monkeypatch, "slice.barrier:raise")
    got = run_ranks(torch_ranks.slice_barrier_fault, 2, {"dir": ckpt},
                    backend="gloo", timeout=300)
    for res in got:
        assert res["parked"] is False
        assert "injected fault" in res["failed"]
        assert res["hits"] >= 1 and res["barrier_s"] >= 0
    events = flight.read_flight_file(os.path.join(ckpt, ".grit-flight.jsonl"))
    ends = [e for e in events if e["ev"] == "slice.barrier.end"]
    assert {e["pid"] for e in ends} == {r["pid"] for r in got}
    assert all(e["ok"] is False for e in ends)
    assert {e["pid"] for e in events if e["ev"] == "slice.barrier.start"} == \
        {r["pid"] for r in got}
