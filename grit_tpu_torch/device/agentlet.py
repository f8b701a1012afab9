"""Checkpoint agentlet — the in-process toggle endpoint of a torch workload.

Counterpart of ``grit_tpu/device/agentlet.py``, speaking the same
protocol on the same socket, so the unchanged node agent
(``grit_tpu.device.hook.TpuDeviceCheckpointHook``) and the reference
``ToggleClient`` drive a PyTorch workload exactly as they drive a JAX one.

Protocol (newline-delimited JSON, one request per line):

    {"op": "quiesce"}                → {"ok": true, "step": N}   toggle off
    {"op": "dump", "dir": "<path>"}  → {"ok": true, "dir": ...}  device snapshot
    {"op": "resume"}                 → {"ok": true}              toggle on
    {"op": "status"}                 → {"ok": true, "step": N, "paused": ...}

Socket path: ``{GRIT_TPU_SOCKET_DIR:-/tmp}/grit-tpu-{pid}.sock``.

Parts of the protocol this slice answers on the reference's own failure
paths (the features arrive with later slices):

- a quiesce carrying a ``dump`` spec (quiesce-free concurrent dump) parks
  as a plain quiesce; the following dump is the parked full dump and its
  response says ``"speculative": {"outcome": "degraded", ...}``;
- a non-parking ``"speculative": true`` dump is refused (``ok: false``);
  the agent then falls back to its parked pass;
- a ``mirror`` dir is abandoned (the primary dump commits; the agent's
  upload pass ships the bytes), a ``wire`` stream answers
  ``"wire": {"ok": false, ...}`` (the agent falls back to the PVC path);
- ``base`` (delta dump) is ignored: the dump is full, which a delta
  reader accepts as is; ``resume`` with ``reload`` is refused.

Wiring: the training loop calls :meth:`Agentlet.checkpoint_point` once
per step. On a pending quiesce the loop drains device work and parks
there until ``resume``; ``dump`` runs while the loop is parked, so the
state tree is stable.
"""

from __future__ import annotations

import json
import logging
import os
import socket
import threading
import time
from typing import Any, Callable

from grit_tpu_torch.api import config
from grit_tpu_torch.device.quiesce import quiesce
from grit_tpu_torch.device.snapshot import write_snapshot

log = logging.getLogger(__name__)

_NOT_IN_SLICE = "not in this slice of the PyTorch port"


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
    """

    def __init__(
        self,
        state_fn: Callable[[], Any],
        step_fn: Callable[[], int] = lambda: -1,
        meta_fn: Callable[[], dict] | None = None,
        path: str | None = None,
        quiesce_state_fn: Callable[[], Any] | None = None,
        pre_park_fn: Callable[[], None] | None = None,
    ) -> None:
        self.state_fn = state_fn
        self.step_fn = step_fn
        self.meta_fn = meta_fn or (lambda: {})
        self.quiesce_state_fn = quiesce_state_fn or state_fn
        self.pre_park_fn = pre_park_fn
        self.path = path or socket_path()
        # One condition guards the pause protocol. _want_pause is the
        # request (set by quiesce, cleared by resume/stop); _is_parked is
        # the loop's acknowledgment. The loop stays parked exactly while
        # _want_pause holds, so a timed-out quiesce is recovered by the
        # agent's error-path resume.
        self._cond = threading.Condition()
        self._want_pause = False
        self._is_parked = False
        self._dumps_in_flight = 0
        self._spec_requested = False
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
        """Call once per training step. Parks while a quiesce is pending."""
        with self._cond:
            if not self._want_pause:
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
            if op == "quiesce":
                return self._quiesce(req)
            if op == "dump":
                return self._dump(req)
            if op == "resume":
                return self._resume(req)
            if op == "status":
                return {"ok": True, "step": int(self.step_fn()),
                        "paused": self.paused, "pid": os.getpid()}
            return {"ok": False, "error": f"unknown op {op!r}"}
        except Exception as exc:  # noqa: BLE001 — report, don't crash the workload
            log.exception("agentlet %s failed", op)
            return {"ok": False, "error": f"{type(exc).__name__}: {exc}"}

    def _quiesce(self, req: dict) -> dict:
        deadline = time.monotonic() + float(req.get("timeout", 300.0))
        with self._cond:
            # A pre-announced dump ("dump" spec) is not speculated here:
            # remember it so the dump reports the degrade.
            self._spec_requested = bool(req.get("dump"))
            self._want_pause = True
            self._cond.notify_all()
            while not self._is_parked:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    # Leave the request pending: the loop parks at its next
                    # boundary and the agent's error path resumes it.
                    return {"ok": False, "error": "quiesce timeout"}
                self._cond.wait(timeout=min(0.2, remaining))
        return {"ok": True, "step": int(self.step_fn())}

    def _dump(self, req: dict) -> dict:
        if req.get("speculative"):
            return {"ok": False, "error": f"speculative probe {_NOT_IN_SLICE}"}
        with self._cond:
            if not (self._is_parked and self._want_pause):
                return {"ok": False, "error": "not quiesced"}
            self._dumps_in_flight += 1
            spec_requested = self._spec_requested
            self._spec_requested = False
        try:
            directory = req["dir"]
            if req.get("mirror") is not None:
                log.warning("mirror %s abandoned (%s); the agent's upload "
                            "pass ships the snapshot", req["mirror"],
                            _NOT_IN_SLICE)
            with self._dump_lock:
                write_snapshot(directory, self.state_fn(),
                               meta={"step": int(self.step_fn()),
                                     **self.meta_fn()})
        finally:
            with self._cond:
                self._dumps_in_flight -= 1
                self._cond.notify_all()
        resp: dict = {"ok": True, "dir": directory}
        if req.get("wire") is not None:
            resp["wire"] = {"ok": False, "error": f"wire stream {_NOT_IN_SLICE}"}
        if spec_requested:
            resp["speculative"] = {
                "outcome": "degraded", "overlap_s": 0.0, "validate_s": 0.0,
                "error": f"speculative dump {_NOT_IN_SLICE}"}
        return resp

    def _resume(self, req: dict) -> dict:
        if req.get("reload") is not None:
            return {"ok": False, "error": "workload has no reload_fn"}
        with self._cond:
            # A dump in flight must finish before the loop may step again.
            while self._dumps_in_flight and not self._shutdown:
                self._cond.wait()
            self._want_pause = False
            self._spec_requested = False
            self._cond.notify_all()
        return {"ok": True}


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

    def quiesce(self, dump_spec: dict | None = None) -> int:
        fields = {"dump": dump_spec} if dump_spec is not None else {}
        return int(self.request("quiesce", **fields)["step"])

    def dump(self, directory: str) -> dict:
        return self.request("dump", dir=directory)

    def resume(self) -> None:
        self.request("resume")

    def status(self) -> dict:
        return self.request("status")

    def close(self) -> None:
        self._sock.close()

    def __enter__(self) -> "ToggleClient":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
