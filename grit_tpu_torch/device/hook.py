"""Device hooks: the node agent's side of the toggle and the workload's
restore side.

Counterpart of ``grit_tpu/device/hook.py``, with no JAX in it, so a GPU
node's agent can take a device hook without importing jax:

- :class:`TpuDeviceCheckpointHook` is what the agent's checkpoint code
  calls inside the pause window (the slot where the reference relies on
  CRIU's ``cuda_plugin.so``). It quiesces the workload through its
  agentlet, over the per-pid socket, and has it dump its device state
  into ``<dest_dir>/hbm``. :class:`AutoDeviceHook` dispatches per pid:
  the toggle path when the workload runs an agentlet, a loud skip
  otherwise. Both take the place of the reference's classes in
  ``grit_tpu.agent.app.run(argv, device_hook=...)``; the wire and env
  names keep their ``TPU`` spelling, since the agent and shim share them.
- The restore side is cooperative: the shim injects
  ``GRIT_TPU_RESTORE_DIR`` into a restore-mode container, and the
  restored workload finds its snapshot with :func:`restore_dir_from_env`.
  The snapshot carries the kernel libraries and its restore seeds them
  (:mod:`grit_tpu_torch.ops.build`); the hook has no part in that.

The hook brackets the blackout's quiesce and dump on the migration's
flight log, as the reference's does: ``quiesce.start``/``quiesce.end`` and
``dump.start``/``dump.end`` with ``dir=dest_dir`` (the log governing the
checkpoint's work dir, so in the agent's process they land where the agent
configured it), closed on failure too.
"""

from __future__ import annotations

import logging
import os

from grit_tpu_torch.api import config
from grit_tpu_torch.device.agentlet import ToggleClient, socket_path
from grit_tpu_torch.device.snapshot import snapshot_exists
from grit_tpu_torch.obs import flight

# Subdirectory of a container checkpoint that holds the device snapshot.
HBM_SUBDIR = "hbm"
RESTORE_ENV = config.TPU_RESTORE_DIR.name

log = logging.getLogger(__name__)


def _namespace_pid(host_pid: int) -> int:
    """The workload's pid inside its pid namespace: the agentlet names its
    socket with the pid it sees, the runtime reports host pids.
    ``/proc/<host>/status``'s ``NSpid:`` lists the pid in every namespace,
    innermost last."""
    try:
        with open(f"/proc/{host_pid}/status") as f:
            for line in f:
                if line.startswith("NSpid:"):
                    return int(line.split()[-1])
    except (OSError, ValueError, IndexError):
        pass
    return host_pid


def _agentlet_pid(host_pid: int) -> int:
    """Socket-naming pid of a workload: the host pid when its socket
    exists (no pid namespace, or a shared socket dir), else the namespace
    pid when that one's does."""
    if os.path.exists(socket_path(host_pid)):
        return host_pid
    ns = _namespace_pid(host_pid)
    return ns if os.path.exists(socket_path(ns)) else host_pid


class TpuDeviceCheckpointHook:
    """Agent side: quiesce the workload through its agentlet and dump its
    device state.

    ``dump`` leaves the snapshot in ``<dest_dir>/hbm/``; the workload stays
    quiesced until ``resume`` (a leave-running checkpoint) or its kill (a
    migration)."""

    def __init__(self, timeout: float = 310.0) -> None:
        self.timeout = timeout
        self._clients: dict[int, ToggleClient] = {}

    def _client(self, pid: int) -> ToggleClient:
        if pid not in self._clients:
            self._clients[pid] = ToggleClient(_agentlet_pid(pid),
                                              timeout=self.timeout)
        return self._clients[pid]

    def dump(self, pid: int, dest_dir: str, base: str | None = None,
             mirror: str | None = None,
             wire: dict | None = None) -> dict | None:
        """The blackout dump. ``base``: the pre-copy snapshot this dump is
        a delta against. ``mirror``: the container-level upload
        destination; the snapshot streams a committed copy into
        ``<mirror>/hbm`` while it dumps. ``wire``: the agentlet's wire
        outcome is returned (None when no wire was asked for).

        With ``GRIT_SNAP_SPECULATE`` on (the default) the quiesce
        pre-announces the dump, as the reference's does: the agentlet
        starts writing a boundary clone to ``<hbm>-spec`` before the loop
        parks, and the dump re-ships only what the steps since touched
        (its response's ``speculative`` block says ``validated``, or
        ``degraded`` with the error when the pass failed and the dump
        fell back to the parked path). The delta references the ``-spec``
        sibling, which ships with it.

        Under ``GRIT_SLICE_HOSTS`` > 1 (one host of a gang) the quiesce
        asks for the slice cut: the workload's gate parks every host at the
        same agreed step, its rendezvous names scoped by
        ``GRIT_SLICE_NONCE`` ("0" when unset). Pre-copy passes
        (:meth:`predump`) stay per host. A rank of a sharded job (a
        ``Trainer(mesh=, rules=)``) dumps its own leg into ``hbm``: its
        shards, described by the leaves themselves, as process ``k`` of
        the world (:func:`~grit_tpu_torch.device.snapshot.merge_legs`
        joins a cut's legs for a restore onto another layout)."""
        hbm_dir = os.path.join(dest_dir, HBM_SUBDIR)
        hbm_mirror = (os.path.join(mirror, HBM_SUBDIR)
                      if mirror is not None else None)
        dump_spec = None
        if config.SNAP_SPECULATE.get_flag():
            dump_spec = {"dir": hbm_dir}
            if base is not None:
                dump_spec["base"] = base
            if hbm_mirror is not None:
                dump_spec["mirror"] = hbm_mirror
        c = self._client(pid)
        flight.emit("quiesce.start", dir=dest_dir, workload_pid=pid)
        ok = False
        try:
            if config.SLICE_HOSTS.get_int() > 1:
                c.quiesce(slice_cut=True, flight_dir=dest_dir,
                          slice_nonce=config.SLICE_NONCE.get() or "0",
                          dump_spec=dump_spec)
            else:
                c.quiesce(dump_spec=dump_spec)
            ok = True
        finally:
            # Closed on failure too: an open quiesce would stretch over
            # the recovery that follows.
            flight.emit("quiesce.end", dir=dest_dir, workload_pid=pid, ok=ok)
        # The request and response windows around the workload's own
        # dump bracket are blackout too.
        flight.emit("dump.start", dir=dest_dir, workload_pid=pid)
        resp = None
        try:
            resp = c.dump(hbm_dir, base=base, mirror=hbm_mirror, wire=wire)
        finally:
            flight.emit("dump.end", dir=dest_dir, workload_pid=pid,
                        ok=resp is not None)
        return resp.get("wire") if wire is not None else None

    def predump(self, pid: int, dest_dir: str,
                mirror: str | None = None,
                base: str | None = None) -> None:
        """A pre-copy pass into ``<dest_dir>/hbm`` while the workload keeps
        training: a momentary quiesce at its next step boundary, a hashed
        dump (``base``: the rolling pre-copy base a later round deltas
        against), an immediate resume.

        With ``GRIT_SNAP_SPECULATE`` on it is the reference's
        non-parking speculative probe: the agentlet clones the state at a
        step boundary and writes the clone while the loop keeps stepping,
        so the loop never parks. A failed probe falls back, with a
        warning, to the parked pass: the same committed layout either
        way."""
        hbm_dir = os.path.join(dest_dir, HBM_SUBDIR)
        hbm_mirror = (os.path.join(mirror, HBM_SUBDIR)
                      if mirror is not None else None)
        with ToggleClient(_agentlet_pid(pid), timeout=self.timeout) as c:
            if config.SNAP_SPECULATE.get_flag():
                try:
                    c.dump(hbm_dir, hashes=True, base=base,
                           mirror=hbm_mirror, speculative=True)
                    return
                except (RuntimeError, ConnectionError, OSError) as exc:
                    log.warning(
                        "speculative predump probe failed (%s); falling "
                        "back to the parked pre-copy pass", exc)
            # The quiesce sits inside the try: a timed-out quiesce leaves
            # the pause pending, and the loop parks at its next boundary;
            # the resume in the finally keeps it training.
            try:
                c.quiesce()
                # Hashed: the live pass runs outside the blackout and pays
                # the sha256 pass, so the blackout delta matches by hash.
                c.dump(hbm_dir, hashes=True, base=base, mirror=hbm_mirror)
            finally:
                c.resume()

    def resume(self, pid: int) -> None:
        c = self._clients.pop(pid, None)
        if c is None:
            c = ToggleClient(_agentlet_pid(pid), timeout=self.timeout)
        try:
            c.resume()
        finally:
            c.close()

    def reattach(self, pid: int, snapshot_dir: str) -> None:
        """Device re-attach after a process restore (the second
        ``cuda-checkpoint --toggle``): the parked agentlet of the restored
        process ``pid`` reloads its device state from the checkpoint's
        snapshot, then unparks."""
        with ToggleClient(_agentlet_pid(pid), timeout=self.timeout) as c:
            c.resume(reload=os.path.join(snapshot_dir, HBM_SUBDIR))

    @staticmethod
    def workload_has_agentlet(pid: int) -> bool:
        return os.path.exists(socket_path(_agentlet_pid(pid)))


class AutoDeviceHook:
    """Per-pid dispatch: the toggle path when the workload runs an
    agentlet, nothing otherwise (a CPU-only pod needs no device hook) —
    but loudly, since a GPU pod whose agentlet is missing would otherwise
    yield a checkpoint without its device state."""

    def __init__(self, timeout: float = 310.0) -> None:
        self._dev = TpuDeviceCheckpointHook(timeout=timeout)
        self._skipped: set[int] = set()

    def dump(self, pid: int, dest_dir: str, base: str | None = None,
             mirror: str | None = None,
             wire: dict | None = None) -> dict | None:
        if TpuDeviceCheckpointHook.workload_has_agentlet(pid):
            return self._dev.dump(pid, dest_dir, base=base, mirror=mirror,
                                  wire=wire)
        self._skipped.add(pid)
        log.warning(
            "no agentlet socket for pid %d (looked for %s and its "
            "namespace-pid variant): skipping the device dump; if this pod "
            "holds GPU state, the checkpoint is incomplete",
            pid, socket_path(pid))
        return None

    def predump(self, pid: int, dest_dir: str,
                mirror: str | None = None,
                base: str | None = None) -> None:
        # A pod without an agentlet has no device state to pre-copy; its
        # blackout dump (above) is the loud one.
        if TpuDeviceCheckpointHook.workload_has_agentlet(pid):
            self._dev.predump(pid, dest_dir, mirror=mirror, base=base)

    def resume(self, pid: int) -> None:
        if pid in self._skipped:
            self._skipped.discard(pid)
            return
        # Unconditional: the inner hook reuses its open connection, so a
        # socket unlinked while the workload was parked still gets its
        # resume.
        self._dev.resume(pid)


# -- the workload's restore side ----------------------------------------------------


def restore_dir_from_env(rank: int = 0) -> str | None:
    """The snapshot dir to restore from: ``GRIT_TPU_RESTORE_DIR`` when it
    holds a committed snapshot, else None. A ``{rank}`` in it names each
    rank's own leg of a sharded job (``rank`` substituted)."""
    d = config.TPU_RESTORE_DIR.get().replace("{rank}", str(rank))
    if not d:
        return None
    return d if snapshot_exists(d) else None

