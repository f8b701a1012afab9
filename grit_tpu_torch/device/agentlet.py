"""Checkpoint agentlet — the in-process toggle endpoint of a torch workload.

Counterpart of ``grit_tpu/device/agentlet.py``, speaking the same
protocol on the same socket, so the unchanged node agent
(``grit_tpu.device.hook.TpuDeviceCheckpointHook``) and the reference
``ToggleClient`` drive a PyTorch workload exactly as they drive a JAX one.

Protocol (newline-delimited JSON, one request per line):

    {"op": "quiesce", "dump"?,       → {"ok": true, "step": N}   toggle off
     "slice"?, "flight_dir"?,
     "slice_nonce"?}
    {"op": "dump", "dir": "<path>",  → {"ok": true, "dir": ...}  device snapshot
     "base"?, "hashes"?, "mirror"?,
     "wire"?, "speculative"?}
    {"op": "resume", "reload"?}      → {"ok": true}              toggle on
    {"op": "status"}                 → {"ok": true, "step": N, "paused": ...,
                                        "slice"?: {"cut", "failed"}}

Socket path: ``{GRIT_TPU_SOCKET_DIR:-/tmp}/grit-tpu-{pid}.sock``.

A dump's ``base`` makes it a delta against that committed snapshot,
``hashes`` records a sha256 per chunk (the pre-copy live pass), and
``mirror`` tees the written bytes into a second committed snapshot, the
agent's upload destination (:func:`~grit_tpu_torch.device.snapshot.write_snapshot`).
The response also carries ``"legs"``, the writer's seconds by stage.

Validated speculation (``GRIT_SNAP_SPECULATE``, on by default), as the
reference serves it:

- a quiesce carrying a ``dump`` spec (``{"dir", "base"?, "mirror"?}``)
  takes a clone of the state at the loop's next step boundary, starts
  writing it to ``<dir>-spec`` on a thread, and only then asks the loop to
  park; the matching dump joins that pass, compares the parked state with
  the clone and re-ships only the leaves that differ, referencing the
  rest. Its response carries ``"speculative": {"outcome": "validated",
  "overlap_s", "validate_s", "clean_bytes", "dirty_bytes", "legs"}``. A
  failed launch, join or validation degrades loudly (a warning, and
  ``"outcome": "degraded"`` with ``"error"``) to the parked dump, which is
  then bit-identical to one without speculation;
- a ``"speculative": true`` dump is the non-parking probe: the clone is
  harvested at a step boundary and written while the loop keeps
  stepping; it answers ``"speculative": {"outcome": "probe"}``.

A dump's ``wire`` (``{"endpoint": "host:port", "prefix", "streams"?}``,
the agent's wire-mode migration) streams the snapshot's data file to the
destination's receiver while the dump drains, as
``<prefix>/data-h0000.bin`` (a sharded rank's leg: ``data-h<k>.bin``;
:mod:`grit_tpu_torch.wire`). The response
carries ``"wire": {"ok": true, "files": {rel: raw bytes}, "sent_bytes",
"dump_overlap_bytes", "send_s", "stall_s"}``, or ``{"ok": false, "error"}``
when the connect failed or the wire dropped: never a failed dump (the
agent falls back to the PVC path). A speculative pass streams nothing.

``resume`` with ``reload`` (the device re-attach after a process
restore) seeds the kernel libraries the snapshot carries (with
``GRIT_TPU_COMPILE_CACHE`` set), runs the workload's ``reload_fn`` on the
snapshot while still parked, then unparks; without a ``reload_fn`` it is
refused.

Gang slice cut: a workload of a multi-host slice passes ``slice_gate``
(:class:`~grit_tpu_torch.parallel.coordination.SliceQuiesceGate`). A
quiesce with ``"slice": true`` (the node hook under ``GRIT_SLICE_HOSTS`` >
1) arms the gate with its ``slice_nonce``, and the loop parks only at the
step boundary every host agreed on, after a bounded barrier. A barrier
that fails latches the gate: the loop trains on and the quiesce answers
``{"ok": false, "error": "slice quiesce barrier failed: ..."}`` within
the barrier's timeout, its request cleared. ``resume`` resets the gate;
``status`` reports ``{"cut", "failed"}``. A quiesce without ``slice``
ignores the gate. With the gate's ``lockstep`` collective (ranks that
share collectives), every boundary runs it, and a rank whose peer has a
slice quiesce pending holds at that boundary for its own.

Sharded state (any DTensor leaf: a ``Trainer(mesh=, rules=)``'s, a
sharded grid's): every dump, the speculative pass, the probe, a delta,
the mirror and the wire tee, writes this rank's own leg, process ``k``
of the world's ``n`` (``write_snapshot(leg=True)``): every shard the
rank holds, each leaf described by its own sharding, into
``data-h<k>.bin``, committed by the rank alone. So each host of a gang
cut ships a tree that restores alone onto the same mesh, and a restore
onto another layout reads the legs of one cut through
:func:`~grit_tpu_torch.device.snapshot.merge_legs`.

Wiring: the training loop calls :meth:`Agentlet.checkpoint_point` once
per step (one lock check when idle). On a pending quiesce the loop drains
device work and parks there until ``resume``; ``dump`` runs while the
loop is parked, so the state tree is stable. A speculative clone is taken
by the loop thread itself at a boundary: the port's steps update tensors
in place, so no other thread reads the live state while a step is queued.

Observability and faults, at the reference's seams: the fault points
``device.agentlet.quiesce``, ``device.agentlet.dump`` and
``device.agentlet.resume`` fire inside the dispatch, so an injected raise
comes back as an ``{"ok": false}`` response and the agentlet serves on;
``snap.speculate`` fires at a speculative pass's launch (a raise degrades
the round to the parked dump, bit-identical) and at the probe's start (a
raise fails the probe, and the hook falls back to the parked pass). The
flight events ``snap.speculative.start`` and ``snap.speculative.validated``
bracket a pass, and ``SNAP_SPECULATIVE_{BYTES,SECONDS,ROUNDS}`` account
it. :meth:`Agentlet.start` starts the workload's ``/metrics`` server
(``GRIT_WORKLOAD_METRICS_PORT``) and log correlation, as the reference's
does.
"""

from __future__ import annotations

import json
import logging
import os
import posixpath
import socket
import threading
import time
from typing import Any, Callable

import torch

from grit_tpu_torch import faults
from grit_tpu_torch.api import config
from grit_tpu_torch.device.quiesce import clone_generation, quiesce
from grit_tpu_torch.ops import build
from grit_tpu_torch.device.snapshot import (
    SpeculativeDump,
    data_file,
    last_write,
    snapshot_delta_nbytes,
    snapshot_nbytes,
    start_speculative_dump,
    validated_clean_names,
    write_snapshot,
)
from grit_tpu_torch.obs import flight
from grit_tpu_torch.obs.logctx import install_log_correlation
from grit_tpu_torch.obs.metrics import (
    SNAP_SPECULATIVE_BYTES,
    SNAP_SPECULATIVE_ROUNDS,
    SNAP_SPECULATIVE_SECONDS,
)
from grit_tpu_torch.obs.server import start_workload_metrics_server
from grit_tpu_torch.parallel.sharding import is_dtensor
from grit_tpu_torch.tree import flatten_with_names
from grit_tpu_torch.wire import WireDumpSink, WireSender

log = logging.getLogger(__name__)

def _hbm(clone: Any) -> dict | None:
    """Device memory around a speculative clone: its bytes on the card,
    the allocator's bytes in use and its peak so far on the clone's
    devices (None when the clone holds no CUDA tensor)."""
    leaves = [x for _, x in flatten_with_names(clone)
              if isinstance(x, torch.Tensor) and x.is_cuda]
    if not leaves:
        return None
    devices = {x.device for x in leaves}
    return {"clone_bytes": sum(x.numel() * x.element_size() for x in leaves),
            "allocated": sum(torch.cuda.memory_allocated(d) for d in devices),
            "peak": sum(torch.cuda.max_memory_allocated(d) for d in devices)}


def leg_of(state: Any) -> dict:
    """The ``write_snapshot`` arguments of this rank's own leg when
    ``state`` holds a DTensor (process ``rank`` of the default group's
    world), else ``{}``: a dense state's single-process dump."""
    if not any(is_dtensor(x) for _, x in flatten_with_names(state)):
        return {}
    import torch.distributed as dist  # noqa: PLC0415

    return {"process_index": dist.get_rank(),
            "process_count": dist.get_world_size(), "leg": True}


def socket_path(pid: int | None = None) -> str:
    pid = pid if pid is not None else os.getpid()
    return os.path.join(config.TPU_SOCKET_DIR.get(), f"grit-tpu-{pid}.sock")


class Agentlet:
    """Serve the toggle protocol for one workload process.

    Args:
      state_fn: returns the *current* migratable state tree (a getter:
        the trainer rebinds its state); the dump writes it.
      step_fn: returns the current step for status/acks.
      meta_fn: extra manifest metadata at dump time, beside ``step``.
      path: the socket path (default :func:`socket_path` of this process).
      quiesce_state_fn: what the park's device drain blocks on (default
        ``state_fn``). A caller whose ``state_fn`` derives a transformed
        dump view (the serving adapter's tagged KV grid) passes the raw
        state here, so the park does not build and discard a copy.
      pre_park_fn: runs once per quiesce round, on the loop thread, after
        the pause request is seen and before the device drain and the
        park (the serving adapter's request-drain policy). Hooked here,
        not before the caller's ``checkpoint_point``, so a quiesce landing
        between the caller's own check and the park still drains. A raise
        aborts the park attempt; the request stays pending for the
        agent's error path.
      reload_fn: ``reload_fn(snapshot_dir)`` reloads the device state
        from a snapshot (a ``resume`` with ``reload``), on the dispatch
        thread while the loop is parked.
      slice_gate: the gang's
        :class:`~grit_tpu_torch.parallel.coordination.SliceQuiesceGate`;
        None is the single-host agentlet.
    """

    def __init__(
        self,
        state_fn: Callable[[], Any],
        step_fn: Callable[[], int] = lambda: -1,
        meta_fn: Callable[[], dict] | None = None,
        path: str | None = None,
        quiesce_state_fn: Callable[[], Any] | None = None,
        pre_park_fn: Callable[[], None] | None = None,
        reload_fn: Callable[[str], Any] | None = None,
        slice_gate=None,
    ) -> None:
        self.state_fn = state_fn
        self.step_fn = step_fn
        self.meta_fn = meta_fn or (lambda: {})
        self.quiesce_state_fn = quiesce_state_fn or state_fn
        self.pre_park_fn = pre_park_fn
        self.reload_fn = reload_fn
        self.slice_gate = slice_gate
        self.path = path or socket_path()
        # One condition guards the pause protocol. _want_pause is the
        # request (set by quiesce, cleared by resume/stop); _is_parked is
        # the loop's acknowledgment. The loop stays parked exactly while
        # _want_pause holds, so a timed-out quiesce is recovered by the
        # agent's error-path resume.
        self._cond = threading.Condition()
        self._want_pause = False
        self._slice_pending = False  # the pending quiesce asks for the cut
        self._is_parked = False
        self._dumps_in_flight = 0
        self._reloads_in_flight = 0
        # Speculation, under _cond: the pass launched by this quiesce
        # round, whether the round asked for one, why its launch failed,
        # and the boundary-clone handshake with the loop thread.
        self._speculative: SpeculativeDump | None = None
        self._spec_requested = False
        self._spec_error: str | None = None
        self._spec_clone_pending = False
        self._spec_clone_box: tuple | None = None
        self._spec_clone_error: str | None = None
        self._shutdown = False
        self._dump_lock = threading.Lock()  # one snapshot write at a time
        self._srv: socket.socket | None = None
        self._thread: threading.Thread | None = None

    # -- lifecycle --------------------------------------------------------------

    def start(self) -> "Agentlet":
        if os.path.exists(self.path):
            os.unlink(self.path)
        srv = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        try:
            srv.bind(self.path)
        except OSError:
            srv.close()
            raise
        srv.listen(4)
        self._srv = srv
        self._thread = threading.Thread(target=self._serve,
                                        name="grit-agentlet", daemon=True)
        self._thread.start()
        # The workload's own /metrics (a no-op unless the knob is set) and
        # log lines stamped with the migration's uid: the agentlet lives
        # in every managed workload process. Neither ever raises.
        start_workload_metrics_server()
        install_log_correlation()
        return self

    def stop(self) -> None:
        with self._cond:
            self._shutdown = True
            self._want_pause = False
            self._cond.notify_all()
        if self._srv is not None:
            try:
                # shutdown() wakes the accept() blocked in _serve; a bare
                # close() from another thread does not.
                self._srv.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            self._srv.close()
        if os.path.exists(self.path):
            try:
                os.unlink(self.path)
            except OSError:
                pass
        if self._thread is not None:
            self._thread.join(timeout=5.0)

    def __enter__(self) -> "Agentlet":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    # -- loop-side hook ---------------------------------------------------------

    def checkpoint_point(self) -> None:
        """Call once per training step. Serves a pending boundary clone,
        then parks while a quiesce is pending (a slice quiesce: at the
        agreed boundary, after the gate's barrier)."""
        gate = self.slice_gate
        lockstep = gate is not None and gate.lockstep is not None
        with self._cond:
            harvest = self._spec_clone_pending
            self._spec_clone_pending = False
            if not (harvest or self._want_pause or lockstep):
                return
        if harvest:
            # Between steps, on the loop's own stream: the clone's reads
            # come before the next step's in-place writes. The park, if
            # one is pending, comes at a later boundary, after the
            # concurrent write has started against the clone.
            self._serve_boundary_clone()
        with self._cond:
            want = self._want_pause
            slice_pending = want and self._slice_pending
        # The lockstep collective runs at every boundary on every rank;
        # when a peer's slice quiesce is pending and this rank's is not,
        # hold here for it rather than step into a collective the peer,
        # blocked in the cut's gather, will not join. No rank pending
        # ends a failed round.
        if lockstep:
            if not gate.lockstep(slice_pending):
                gate.settle()
            elif not slice_pending:
                if gate.failed_this_round or \
                        not self._hold_for_slice_request():
                    return
                want = slice_pending = True
        if not want:
            return
        if slice_pending and not gate.ready_to_park(int(self.step_fn())):
            # Below the agreed cut, or the gate failed: keep training.
            return
        if self.pre_park_fn is not None:
            self.pre_park_fn()
        # Drain device work outside the lock; re-check the request after —
        # it may have been cancelled meanwhile.
        quiesce(self.quiesce_state_fn())
        with self._cond:
            if not self._want_pause:
                return
            self._is_parked = True
            self._cond.notify_all()
            while self._want_pause and not self._shutdown:
                self._cond.wait()
            self._is_parked = False
            self._cond.notify_all()

    def _hold_for_slice_request(self) -> bool:
        """Hold the loop at this boundary until this rank's own slice
        quiesce arrives, bounded by the gate's timeout, serving a boundary
        clone asked for meanwhile (the quiesce's speculation harvests one
        before it sets the request). False, with the gate latched, when
        none arrived."""
        timeout = self.slice_gate.timeout_s()
        deadline = time.monotonic() + timeout
        while True:
            with self._cond:
                if self._want_pause and self._slice_pending:
                    return True
                harvest = self._spec_clone_pending
                self._spec_clone_pending = False
                remaining = deadline - time.monotonic()
                if self._shutdown or (not harvest and remaining <= 0):
                    break
                if not harvest:
                    self._cond.wait(timeout=min(0.2, remaining))
                    continue
            self._serve_boundary_clone()
        self.slice_gate.latch(
            f"BarrierTimeout: a peer's slice quiesce was pending and none "
            f"reached this rank within {timeout}s")
        return False

    @property
    def paused(self) -> bool:
        with self._cond:
            return self._is_parked

    @property
    def quiesce_pending(self) -> bool:
        """A quiesce request is waiting for the loop to park (the serving
        adapter closes admission on it)."""
        with self._cond:
            return self._want_pause and not self._is_parked

    # -- server side ------------------------------------------------------------

    def _serve(self) -> None:
        # Thread per connection: the node agent keeps its connection open
        # while status probes still need to get through.
        while True:
            try:
                conn, _ = self._srv.accept()
            except OSError:
                return  # stop() closed the listening socket
            threading.Thread(target=self._conn_worker, args=(conn,),
                             daemon=True).start()

    def _conn_worker(self, conn: socket.socket) -> None:
        try:
            self._handle_conn(conn)
        except (OSError, ValueError) as exc:
            log.warning("agentlet connection dropped: %s", exc)
        finally:
            conn.close()

    def _handle_conn(self, conn: socket.socket) -> None:
        buf = b""
        while True:
            chunk = conn.recv(65536)
            if not chunk:
                return
            buf += chunk
            while b"\n" in buf:
                line, buf = buf.split(b"\n", 1)
                if line.strip():
                    resp = self._dispatch(json.loads(line))
                    conn.sendall((json.dumps(resp) + "\n").encode())

    def _dispatch(self, req: dict) -> dict:
        op = req.get("op")
        try:
            # The toggle's chaos seams fire inside this try: an injected
            # raise travels as a real failure does, an error response.
            if op == "quiesce":
                faults.fault_point("device.agentlet.quiesce")
                return self._quiesce(req)
            if op == "dump":
                faults.fault_point("device.agentlet.dump")
                if req.get("speculative"):
                    return self._speculative_probe(req)
                return self._dump(req)
            if op == "resume":
                faults.fault_point("device.agentlet.resume")
                return self._resume(req)
            if op == "status":
                resp = {"ok": True, "step": int(self.step_fn()),
                        "paused": self.paused, "pid": os.getpid()}
                if self.slice_gate is not None:
                    resp["slice"] = {"cut": self.slice_gate.cut,
                                     "failed": self.slice_gate.failed}
                return resp
            return {"ok": False, "error": f"unknown op {op!r}"}
        except Exception as exc:  # noqa: BLE001 — report, don't crash the workload
            log.exception("agentlet %s failed", op)
            return {"ok": False, "error": f"{type(exc).__name__}: {exc}"}

    # -- speculation --------------------------------------------------------------

    def _serve_boundary_clone(self) -> None:
        """Loop-thread half of the handshake: clone the current generation,
        with its step and meta, and hand them to the waiting dispatch
        thread (or the error that stopped it)."""
        try:
            box: tuple | None = (clone_generation(self.state_fn()),
                                 int(self.step_fn()), dict(self.meta_fn()))
            err: str | None = None
        except Exception as exc:  # noqa: BLE001 — reported to the waiter
            box, err = None, f"{type(exc).__name__}: {exc}"
        with self._cond:
            self._spec_clone_box = box
            self._spec_clone_error = err
            self._cond.notify_all()

    def _harvest_boundary_clone(self, timeout_s: float) -> tuple[Any, int, dict]:
        """Dispatch-thread half: ``(clone, step, meta)`` of the generation
        at the loop's next step boundary. A parked loop is at a boundary
        with no step queued, so that case clones here. Raises on timeout
        (a loop that never reaches a boundary) or a failed clone."""
        with self._cond:
            parked = self._is_parked and self._want_pause
            if not parked:
                self._spec_clone_box = None
                self._spec_clone_error = None
                self._spec_clone_pending = True
                self._cond.notify_all()
        if parked:
            return (clone_generation(self.state_fn()), int(self.step_fn()),
                    dict(self.meta_fn()))
        deadline = time.monotonic() + timeout_s
        with self._cond:
            while self._spec_clone_box is None \
                    and self._spec_clone_error is None:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    self._spec_clone_pending = False
                    raise RuntimeError(
                        f"no step boundary within {timeout_s:.0f}s to "
                        "harvest the speculative clone")
                self._cond.wait(timeout=min(0.2, remaining))
            box, err = self._spec_clone_box, self._spec_clone_error
            self._spec_clone_box = self._spec_clone_error = None
        if err is not None:
            raise RuntimeError(f"boundary clone failed: {err}")
        return box

    def _speculative_probe(self, req: dict) -> dict:
        """The non-parking dump: a clone harvested at a step boundary,
        written from this thread while the loop keeps stepping. No pause
        is ever requested. The committed snapshot has the parked dump's
        format (hashed when asked), so a delta base it feeds stays valid."""
        faults.fault_point("snap.speculate")
        directory = req["dir"]
        with self._cond:
            self._dumps_in_flight += 1
        try:
            t0 = time.monotonic()
            clone, at_step, at_meta = self._harvest_boundary_clone(
                config.SNAP_SPECULATE_WAIT_S.get_float())
            flight.emit_near(directory, "snap.speculative.start",
                             dir=os.path.basename(directory), probe=True,
                             delta=req.get("base") is not None)
            hbm = _hbm(clone)
            with self._dump_lock:
                write_snapshot(directory, clone,
                               meta={"step": at_step, **at_meta},
                               base=req.get("base"),
                               hashes=bool(req.get("hashes")),
                               mirror=req.get("mirror"), speculative=True,
                               **leg_of(clone))
                legs = last_write()
            if hbm is not None:
                hbm["peak_after"] = _hbm(clone)["peak"]
            del clone
            SNAP_SPECULATIVE_SECONDS.inc(time.monotonic() - t0,
                                         phase="concurrent")
            SNAP_SPECULATIVE_ROUNDS.inc(outcome="probe")
            flight.emit_near(directory, "snap.speculative.validated",
                             outcome="probe")
        finally:
            with self._cond:
                self._dumps_in_flight -= 1
                self._cond.notify_all()
        info: dict = {"outcome": "probe"}
        if hbm is not None:
            info["hbm"] = hbm
        return {"ok": True, "dir": directory, "legs": legs,
                "speculative": info}

    def _launch_speculation(self, dump_spec: dict, timeout_s: float) -> None:
        """A quiesce's dump spec: harvest a boundary clone and start its
        concurrent pass. A failure is recorded (the dump reports the
        degrade) and logged; it never fails the quiesce."""
        with self._cond:
            stale = self._speculative
            self._speculative = None
            self._spec_requested = True
            self._spec_error = None
        if stale is not None:
            stale.release()
        try:
            faults.fault_point("snap.speculate")
            clone, at_step, at_meta = self._harvest_boundary_clone(
                min(timeout_s, config.SNAP_SPECULATE_WAIT_S.get_float()))
            spec = start_speculative_dump(
                str(dump_spec["dir"]), clone, already_cloned=True,
                meta={"step": at_step, **at_meta},
                base=dump_spec.get("base"), mirror=dump_spec.get("mirror"),
                dump_lock=self._dump_lock, **leg_of(clone))
            spec.hbm = _hbm(clone)
            with self._cond:
                self._speculative = spec
        except Exception as exc:  # noqa: BLE001 — degrade, never fail the quiesce
            with self._cond:
                self._spec_error = f"{type(exc).__name__}: {exc}"
            log.warning("speculative dump launch failed (%s); this round "
                        "degrades to the parked dump", exc)

    def _consume_speculation(self, directory: str, req_base: str | None
                             ) -> tuple[str | None, frozenset | None,
                                        dict | None, bool]:
        """Join and validate this round's speculative pass for the parked
        dump: ``(base, clean_names, spec_info, spec_started)``. Validated:
        the base is the committed ``-spec`` pass and ``clean_names`` the
        leaves proved untouched. Any failure: the request's own base and
        no clean set, the parked dump without speculation, and a warning.
        ``spec_info`` is None when the round asked for no speculation;
        ``spec_started``, whether a pass was launched (and so bracketed by
        ``snap.speculative.start``). Runs before the dump lock is taken:
        the pass writes under it."""
        with self._cond:
            spec, self._speculative = self._speculative, None
            requested, self._spec_requested = self._spec_requested, False
            why, self._spec_error = self._spec_error or "", None
        if not requested:
            return req_base, None, None, False
        outcome, overlap_s, validate_s = "degraded", 0.0, 0.0
        base, clean = req_base, None
        if spec is not None:
            if not spec.join(config.SNAP_SPECULATE_WAIT_S.get_float()):
                why = "speculative pass still running past the wait bound"
            else:
                overlap_s = spec.seconds
                if spec.error is not None:
                    why = f"speculative pass failed: {spec.error!r}"
                elif spec.final_dir != directory:
                    why = (f"speculative pass targeted {spec.final_dir!r}, "
                           f"the dump asked for {directory!r}")
                else:
                    if spec.hbm is not None:
                        spec.hbm["peak_after"] = _hbm(spec.clone)["peak"]
                    tv = time.monotonic()
                    names = validated_clean_names(self.state_fn(), spec.clone)
                    validate_s = time.monotonic() - tv
                    SNAP_SPECULATIVE_SECONDS.inc(validate_s, phase="validate")
                    if names is None:
                        why = "state generations structurally incomparable"
                    else:
                        clean = frozenset(names)
                        base = spec.directory
                        outcome = "validated"
            spec.release()
        info: dict = {"outcome": outcome, "overlap_s": round(overlap_s, 4),
                      "validate_s": round(validate_s, 4)}
        if outcome == "validated":
            info["legs"] = spec.legs
            if spec.hbm is not None:
                info["hbm"] = spec.hbm
        else:
            info["error"] = why or "launch failed"
            log.warning("speculative dump degraded to the parked full "
                        "path: %s", info["error"])
        return base, clean, info, spec is not None

    @staticmethod
    def _account_speculation(directory: str, info: dict,
                             spec_started: bool) -> None:
        """A round's outcome (``SNAP_SPECULATIVE_ROUNDS``) and, for a
        validated re-ship, its bytes: ``clean_bytes`` it referenced from
        the speculative pass with no device read, ``dirty_bytes`` the
        steps since the clone touched; then the ``snap.speculative.validated``
        event, only where a ``start`` opened the bracket."""
        if info["outcome"] == "validated":
            try:
                total = snapshot_nbytes(directory)
                dirty = snapshot_delta_nbytes(directory)
            except (OSError, ValueError, KeyError):
                total = dirty = 0
            info["clean_bytes"] = max(0, total - dirty)
            info["dirty_bytes"] = dirty
            SNAP_SPECULATIVE_BYTES.inc(info["clean_bytes"], outcome="clean")
            SNAP_SPECULATIVE_BYTES.inc(dirty, outcome="dirty")
        SNAP_SPECULATIVE_ROUNDS.inc(outcome=info["outcome"])
        if spec_started:
            flight.emit_near(directory, "snap.speculative.validated",
                             outcome=info["outcome"],
                             overlap_s=info["overlap_s"],
                             validate_s=info["validate_s"],
                             clean_bytes=info.get("clean_bytes", 0),
                             dirty_bytes=info.get("dirty_bytes", 0))

    # -- the protocol ---------------------------------------------------------------

    def _quiesce(self, req: dict) -> dict:
        timeout = float(req.get("timeout", 300.0))
        gate = self.slice_gate
        want_slice = bool(req.get("slice")) and gate is not None
        dump_spec = req.get("dump")
        if dump_spec and config.SNAP_SPECULATE.get_flag():
            # The concurrent pass starts before the pause is requested:
            # the loop clones at its next boundary, steps on, and parks
            # at a later one (a slice quiesce: after the gate's wait).
            self._launch_speculation(dump_spec, timeout)
        if want_slice:
            # Armed before the request, so the first boundary that sees
            # the request consults it.
            gate.request(flight_dir=req.get("flight_dir"),
                         nonce=req.get("slice_nonce"),
                         step=int(self.step_fn()))
        deadline = time.monotonic() + timeout
        with self._cond:
            self._slice_pending = want_slice
            self._want_pause = True
            self._cond.notify_all()
            while not self._is_parked:
                if want_slice and gate.failed is not None:
                    # The loop cannot park this round; a pending request
                    # would ambush the next attempt, so it is cleared.
                    self._want_pause = False
                    self._slice_pending = False
                    self._cond.notify_all()
                    return {"ok": False, "error": "slice quiesce barrier "
                                                  f"failed: {gate.failed}"}
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    # Leave the request pending: the loop parks at its next
                    # boundary and the agent's error path resumes it.
                    return {"ok": False, "error": "quiesce timeout"}
                self._cond.wait(timeout=min(0.2, remaining))
        return {"ok": True, "step": int(self.step_fn())}

    @staticmethod
    def _wire_sink(spec: dict | None, fname: str):
        """The dump's wire tee from a request's ``wire`` spec, carrying
        the data file ``fname``: ``(sink, sender, error_result)``. A
        connect failure is reported in the response's ``wire`` block,
        never raised: the agent falls back to the PVC path loudly, and
        the snapshot is never lost."""
        if not spec:
            return None, None, None
        try:
            sender = WireSender(str(spec["endpoint"]),
                                streams=int(spec.get("streams", 2)))
            rel = posixpath.join(str(spec.get("prefix", "")), fname)
            return WireDumpSink(sender, rel), sender, None
        except Exception as exc:  # noqa: BLE001 — reported, never raised
            return None, None, {"ok": False,
                                "error": f"{type(exc).__name__}: {exc}"}

    def _dump(self, req: dict) -> dict:
        with self._cond:
            if not (self._is_parked and self._want_pause):
                return {"ok": False, "error": "not quiesced"}
            self._dumps_in_flight += 1
        wire_result: dict | None = None
        try:
            directory = req["dir"]
            state = self.state_fn()
            leg = leg_of(state)
            sink, sender, wire_result = self._wire_sink(
                req.get("wire"), data_file(leg.get("process_index", 0)))
            try:
                base, clean, spec_info, spec_started = \
                    self._consume_speculation(directory, req.get("base"))
                with self._dump_lock:
                    write_snapshot(directory, state,
                                   meta={"step": int(self.step_fn()),
                                         **self.meta_fn()},
                                   base=base, hashes=bool(req.get("hashes")),
                                   mirror=req.get("mirror"), wire=sink,
                                   clean_names=clean, **leg)
                    legs = last_write()
            finally:
                if sender is not None:
                    sender.close()  # sends what is queued, then closes
            if spec_info is not None:
                self._account_speculation(directory, spec_info, spec_started)
            if sink is not None:
                wire_result = (
                    {"ok": True, "files": {sink.rel: sink.nbytes},
                     "sent_bytes": sender.sent_bytes,
                     # on a socket while the dump still drained
                     "dump_overlap_bytes": sink.bytes_during_dump,
                     "send_s": round(sender.send_s, 4),
                     "stall_s": round(sender.stall_s, 4)}
                    if sink.ok else {"ok": False, "error": sink.error})
        finally:
            with self._cond:
                self._dumps_in_flight -= 1
                self._cond.notify_all()
        resp: dict = {"ok": True, "dir": directory, "legs": legs}
        if wire_result is not None:
            resp["wire"] = wire_result
        if spec_info is not None:
            resp["speculative"] = spec_info
        return resp

    def _resume(self, req: dict) -> dict:
        reload_dir = req.get("reload")
        if reload_dir is not None:
            # The loop must be parked, so the state is stable while
            # reload_fn rebinds it; a plain resume meanwhile waits it out.
            with self._cond:
                if not (self._is_parked and self._want_pause):
                    return {"ok": False, "error": "reload requires quiesced"}
                if self.reload_fn is None:
                    return {"ok": False, "error": "workload has no reload_fn"}
                self._reloads_in_flight += 1
            try:
                # The libraries the snapshot carries first: a reload_fn
                # may build kernels without entering restore_snapshot,
                # which seeds them on the Trainer's path.
                if config.TPU_COMPILE_CACHE.get():
                    build.seed_compile_cache(reload_dir)
                with self._dump_lock:
                    self.reload_fn(reload_dir)
            finally:
                with self._cond:
                    self._reloads_in_flight -= 1
                    self._cond.notify_all()
        with self._cond:
            # A dump or reload in flight must finish before the loop may
            # step again.
            while (self._dumps_in_flight or self._reloads_in_flight) \
                    and not self._shutdown:
                self._cond.wait()
            self._want_pause = False
            self._slice_pending = False
            # Resume ends the speculation window: a pass no dump consumed
            # (a quiesce aborted before its dump) is abandoned.
            stale, self._speculative = self._speculative, None
            self._spec_requested = False
            self._spec_error = None
            self._cond.notify_all()
        if stale is not None:
            stale.release()
        if self.slice_gate is not None:
            # The round is over: the next attempt agrees afresh.
            self.slice_gate.reset()
        return {"ok": True, **({"reloaded": reload_dir} if reload_dir else {})}


class ToggleClient:
    """Client side of the toggle protocol (what the node agent uses)."""

    def __init__(self, pid: int, path: str | None = None,
                 timeout: float = 310.0) -> None:
        self.path = path or socket_path(pid)
        self._sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        self._sock.settimeout(timeout)
        self._sock.connect(self.path)
        self._buf = b""

    def request(self, op: str, **fields) -> dict:
        self._sock.sendall((json.dumps({"op": op, **fields}) + "\n").encode())
        while b"\n" not in self._buf:
            chunk = self._sock.recv(65536)
            if not chunk:
                raise ConnectionError("agentlet closed the connection")
            self._buf += chunk
        line, self._buf = self._buf.split(b"\n", 1)
        resp = json.loads(line)
        if not resp.get("ok"):
            raise RuntimeError(f"agentlet {op} failed: {resp.get('error')}")
        return resp

    def quiesce(self, slice_cut: bool = False,
                flight_dir: str | None = None,
                slice_nonce: str | None = None,
                dump_spec: dict | None = None) -> int:
        """Park the workload; returns its step. ``slice_cut``: park at the
        slice's agreed cut (the workload's gate runs the cross-host
        barrier), scoped by ``slice_nonce``; a workload without a gate
        ignores it. ``dump_spec`` (``{"dir", "base"?, "mirror"?}``)
        pre-announces the dump: the speculative pass starts before the
        park."""
        fields: dict = {}
        if slice_cut:
            fields["slice"] = True
            if flight_dir is not None:
                fields["flight_dir"] = flight_dir
            if slice_nonce is not None:
                fields["slice_nonce"] = slice_nonce
        if dump_spec is not None:
            fields["dump"] = dump_spec
        return int(self.request("quiesce", **fields)["step"])

    def dump(self, directory: str, base: str | None = None,
             hashes: bool = False, mirror: str | None = None,
             wire: dict | None = None, speculative: bool = False) -> dict:
        """The dump response. ``base``, ``hashes`` and ``mirror`` as
        :func:`~grit_tpu_torch.device.snapshot.write_snapshot` takes them;
        ``speculative``: the non-parking probe; ``wire``: ``{"endpoint",
        "prefix", "streams"?}``, the stream to a migration destination."""
        fields: dict = {"dir": directory}
        if base is not None:
            fields["base"] = base
        if hashes:
            fields["hashes"] = True
        if mirror is not None:
            fields["mirror"] = mirror
        if wire is not None:
            fields["wire"] = wire
        if speculative:
            fields["speculative"] = True
        return self.request("dump", **fields)

    def resume(self, reload: str | None = None) -> None:
        """Unpark; with ``reload``, have the workload reload its device
        state from that snapshot first."""
        fields = {"reload": reload} if reload is not None else {}
        self.request("resume", **fields)

    def status(self) -> dict:
        return self.request("status")

    def close(self) -> None:
        self._sock.close()

    def __enter__(self) -> "ToggleClient":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
