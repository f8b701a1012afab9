"""Slice coordination: consistent multi-host cuts.

Counterpart of ``grit_tpu/parallel/coordination.py``. A job of N host
processes cannot be frozen one process at a time: a rank parked at step 12
while its peers run on leaves them blocked in a collective it will never
join, and a dump taken there is not one cut of the job. So:

1. **Cut agreement**: every host publishes its current step and the cut
   is ``max`` of them (run forward, never back: steps taken cannot be
   undone); hosts below it step on to it.
2. **Barrier**: at the cut each host waits, bounded, for every other;
   then no collective is in flight anywhere and each host parks.
3. **Snapshot**: each host writes its own files; process 0 merges the
   indexes and commits one manifest
   (:func:`~grit_tpu_torch.device.snapshot.write_snapshot`'s ``barrier``).
4. **Restore**: each host restores, then a barrier gates the first step.

Transports (:class:`Rendezvous`): :class:`LocalRendezvous` (threads of one
process), :class:`FileRendezvous` (processes sharing a directory; the
reference's on-disk layout byte for byte, so a port host and a JAX host
meet on one directory) and :class:`StoreRendezvous` (a
``torch.distributed`` ``Store``, in place of the reference's
``MultihostRendezvous`` over ``jax.distributed``). Every wait is bounded
(``GRIT_SLICE_BARRIER_TIMEOUT_S`` unless the call narrows it) and raises
:class:`BarrierTimeout` when it expires.

:class:`SliceQuiesceGate` is the agentlet's side: it turns "park at the
next step boundary" into "park at the same agreed boundary on every host".
Ranks that share collectives (a pipeline's stages) pass it ``lockstep``
(:func:`group_any`), one collective a step boundary that tells every rank,
at the same boundary, whether any rank has a slice quiesce pending; a rank
whose own request has not arrived then holds there (bounded) instead of
stepping into a collective its requested peer will not join. See
:class:`SliceQuiesceGate`.

The reference's ``slice.barrier`` fault point, its flight events and its
``SLICE_BARRIER_SECONDS`` metric have no counterpart yet; the barrier's
wait is the gate's ``wait_s``.
"""

from __future__ import annotations

import datetime
import json
import logging
import os
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Protocol

from grit_tpu_torch.api import config
from grit_tpu_torch.device.quiesce import quiesce
from grit_tpu_torch.device.snapshot import restore_snapshot, write_snapshot

log = logging.getLogger(__name__)


class BarrierTimeout(RuntimeError):
    """A bounded rendezvous wait expired: some host of the slice never
    arrived. A partial barrier fails the leg, and through it the gang,
    rather than park part of the slice against a host that never comes."""


class Rendezvous(Protocol):
    """The cross-host primitives the coordinator needs. ``rank`` is the
    caller's process index; ``timeout`` bounds the wait (None: the
    transport's default) and its expiry raises :class:`BarrierTimeout`."""

    def barrier(self, name: str, timeout: float | None = None) -> None: ...

    def allgather(self, name: str, value: Any, rank: int,
                  timeout: float | None = None) -> list[Any]: ...


def _default_timeout() -> float:
    return config.SLICE_BARRIER_TIMEOUT_S.get_float()


class LocalRendezvous:
    """In-process rendezvous for N simulated hosts (threads)."""

    def __init__(self, world_size: int) -> None:
        self.world_size = world_size
        self._barriers: dict[str, threading.Barrier] = {}
        self._values: dict[str, dict[int, Any]] = {}
        self._lock = threading.Lock()

    def _barrier_for(self, name: str) -> threading.Barrier:
        with self._lock:
            if name not in self._barriers:
                self._barriers[name] = threading.Barrier(self.world_size)
            return self._barriers[name]

    def barrier(self, name: str, timeout: float | None = None) -> None:
        try:
            self._barrier_for(name).wait(timeout=timeout)
        except threading.BrokenBarrierError:
            # Broken by a peer's timeout or by ours: either way the slice
            # never fully arrived here.
            raise BarrierTimeout(
                f"barrier {name!r}: not all {self.world_size} host(s) "
                f"arrived within {timeout}s") from None

    def allgather(self, name: str, value: Any, rank: int,
                  timeout: float | None = None) -> list[Any]:
        with self._lock:
            self._values.setdefault(name, {})[rank] = value
        self.barrier(name + "/gathered", timeout=timeout)
        out = [self._values[name][k] for k in sorted(self._values[name])]
        self.barrier(name + "/read", timeout=timeout)
        return out


class FileRendezvous:
    """Cross-process rendezvous over a shared directory.

    Layout, the reference's: ``<dir>/<name>/arrive-<rank:04d>`` for a
    barrier, ``<dir>/<name>/value-<rank:04d>.json`` for an allgather
    (``name`` with path separators and ``..`` replaced by ``_``). Every
    write goes to a ``.tmp-<pid>`` twin, is fsynced and renamed into
    place, and a reader ignores the twins, so it never sees a torn value.
    Names must be unique per use; the coordinator sequences them."""

    def __init__(self, directory: str, rank: int, world_size: int) -> None:
        self.directory = directory
        self.rank = int(rank)
        self.world_size = int(world_size)

    @staticmethod
    def _safe(name: str) -> str:
        return name.replace(os.sep, "_").replace("..", "_")

    def _write(self, name: str, fname: str, payload: str) -> str:
        d = os.path.join(self.directory, self._safe(name))
        os.makedirs(d, exist_ok=True)
        path = os.path.join(d, fname)
        tmp = f"{path}.tmp-{os.getpid()}"
        with open(tmp, "w") as f:
            f.write(payload)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
        return d

    def _wait(self, d: str, prefix: str, timeout: float | None,
              name: str) -> list[str]:
        deadline = time.monotonic() + (
            timeout if timeout is not None else _default_timeout())
        poll = max(0.01, config.SLICE_POLL_S.get_float())
        while True:
            try:
                have = sorted(f for f in os.listdir(d)
                              if f.startswith(prefix) and ".tmp-" not in f)
            except OSError:
                have = []
            if len(have) >= self.world_size:
                return have
            if time.monotonic() > deadline:
                raise BarrierTimeout(
                    f"barrier {name!r}: {len(have)}/{self.world_size} "
                    f"host(s) arrived before the deadline")
            time.sleep(poll)

    def barrier(self, name: str, timeout: float | None = None) -> None:
        d = self._write(name, f"arrive-{self.rank:04d}", str(self.rank))
        self._wait(d, "arrive-", timeout, name)

    def allgather(self, name: str, value: Any, rank: int,
                  timeout: float | None = None) -> list[Any]:
        d = self._write(name, f"value-{rank:04d}.json", json.dumps(value))
        out = []
        for fname in self._wait(d, "value-", timeout, name):
            with open(os.path.join(d, fname)) as f:
                out.append(json.load(f))
        return out


class StoreRendezvous:
    """Rendezvous over a ``torch.distributed`` ``Store`` (``TCPStore``,
    ``FileStore``): the transport of ranks that share a store, where the
    reference uses ``jax.distributed``. Unlike the reference's
    ``MultihostRendezvous`` it is bounded: each wait is the store's own
    ``wait`` with the timeout, and its expiry raises
    :class:`BarrierTimeout` naming the hosts that arrived.

    Keys: ``<name>/arrive-<rank:04d>`` and ``<name>/value-<rank:04d>``
    (JSON), under the store's own prefix."""

    def __init__(self, store, rank: int, world_size: int) -> None:
        self.store = store
        self.rank = int(rank)
        self.world_size = int(world_size)

    def _wait(self, keys: list[str], timeout: float | None,
              name: str) -> None:
        t = timeout if timeout is not None else _default_timeout()
        try:
            self.store.wait(keys, datetime.timedelta(seconds=max(t, 0.001)))
        except RuntimeError:  # the store's timeout (DistStoreError)
            have = sum(1 for k in keys if self.store.check([k]))
            raise BarrierTimeout(
                f"barrier {name!r}: {have}/{self.world_size} host(s) "
                f"arrived before the deadline") from None

    def barrier(self, name: str, timeout: float | None = None) -> None:
        self.store.set(f"{name}/arrive-{self.rank:04d}", str(self.rank))
        self._wait([f"{name}/arrive-{k:04d}" for k in range(self.world_size)],
                   timeout, name)

    def allgather(self, name: str, value: Any, rank: int,
                  timeout: float | None = None) -> list[Any]:
        self.store.set(f"{name}/value-{rank:04d}", json.dumps(value))
        keys = [f"{name}/value-{k:04d}" for k in range(self.world_size)]
        self._wait(keys, timeout, name)
        return [json.loads(self.store.get(k)) for k in keys]


def _default_group_rank() -> tuple[int, int]:
    """``(rank, world size)`` of the initialised default process group,
    else ``(0, 1)``."""
    import torch.distributed as dist  # noqa: PLC0415

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


@dataclass
class SliceCoordinator:
    """Drives consistent-cut snapshots for one host of a slice.
    ``process_index``/``process_count`` default to the initialised
    default process group's rank and size (0 and 1 without one)."""

    rendezvous: Rendezvous
    process_index: int | None = None
    process_count: int | None = None
    _seq: int = field(default=0)

    def _pidx(self) -> int:
        if self.process_index is not None:
            return self.process_index
        return _default_group_rank()[0]

    def _pcount(self) -> int:
        if self.process_count is not None:
            return self.process_count
        return _default_group_rank()[1]

    def agree_cut_step(self, current_step: int) -> int:
        """All hosts exchange steps; the cut is the max (run forward)."""
        self._seq += 1
        steps = self.rendezvous.allgather(f"grit/cut/{self._seq}",
                                          int(current_step), self._pidx())
        return max(int(s) for s in steps)

    def snapshot(self, directory: str, state: Any, *,
                 step_fn: Callable[[], Any] | None = None,
                 current_step: int | None = None, meta: dict | None = None,
                 base: str | None = None, hashes: bool = False,
                 mirror: str | None = None) -> str:
        """Consistent-cut snapshot across all hosts.

        ``state`` is the tree to dump, or a callable returning it (needed
        whenever ``step_fn`` rebinds the state rather than updating it in
        place). With ``step_fn`` and ``current_step`` the host first runs
        forward to the agreed cut, and ``meta`` defaults to
        ``{"step": cut}``. ``base``: a delta against an earlier coordinated
        snapshot, each host matching only its own chunks. ``mirror``: each
        host tees its own data file, and process 0 seals the mirror only
        when every host dropped its marker."""
        if current_step is not None and step_fn is not None:
            cut = self.agree_cut_step(current_step)
            while current_step < cut:
                step_fn()
                current_step += 1
            if meta is None:
                meta = {"step": cut}
        if callable(state):
            state = state()
        quiesce(state)
        self._seq += 1
        name = f"grit/snap/{self._seq}"
        return write_snapshot(
            directory, state, meta=meta,
            barrier=lambda: self.rendezvous.barrier(name),
            process_index=self._pidx(), process_count=self._pcount(),
            base=base, hashes=hashes, mirror=mirror)

    def restore(self, directory: str, **kwargs) -> Any:
        """Barriered restore: no host starts stepping until all loaded."""
        state = restore_snapshot(directory, **kwargs)
        self._seq += 1
        self.rendezvous.barrier(f"grit/restored/{self._seq}")
        return state


def group_any(group=None) -> Callable[[bool], bool]:
    """The ``lockstep`` collective of :class:`SliceQuiesceGate` over a
    ``torch.distributed`` group (default: the default group): every rank
    passes whether it has a slice quiesce pending, and every rank gets
    whether any has. One all-reduce of one integer on the host: a group
    of another backend (NCCL) gets a gloo twin here, so the step boundary
    never waits for the card's queued work (every rank of the group
    builds it here, together). The returned function must be called once
    at every step boundary by every rank of the group, as the training
    loop's own collectives are."""
    import torch  # noqa: PLC0415
    import torch.distributed as dist  # noqa: PLC0415

    if dist.get_backend(group) != "gloo":
        group = dist.new_group(
            ranks=None if group is None else dist.get_process_group_ranks(group),
            backend="gloo", use_local_synchronization=True)

    def any_pending(pending: bool) -> bool:
        flag = torch.tensor([1 if pending else 0], dtype=torch.int32)
        dist.all_reduce(flag, op=dist.ReduceOp.MAX, group=group)
        return bool(flag.item())

    return any_pending


class SliceQuiesceGate:
    """The cross-host quiesce barrier, as the agentlet sees it.

    1. On the first :meth:`ready_to_park` after a quiesce request, every
       host allgathers its step (bounded) and the cut is the ``max``.
    2. Hosts below the cut keep stepping (``ready_to_park`` is False).
    3. At the cut each host enters a bounded barrier; only when every
       host arrived may the loop park.
    4. A timeout (a host died before the cut, a wedged peer) latches the
       gate failed: the loop keeps training and the agent's quiesce
       fails, so the gang aborts. Never a half-parked slice.

    Rendezvous names are ``grit/q<nonce>.g<gen>/cut`` and
    ``grit/q<nonce>.g<gen>/barrier-<cut>``: the nonce is the agent's
    attempt (a retried gang never meets a failed attempt's arrivals), the
    generation counts :meth:`reset` calls within it (file arrivals persist
    on disk, and a second round must not read the first's).

    ``lockstep`` (for ranks that share collectives, :func:`group_any`): a
    collective that the agentlet calls at every step boundary with
    whether this rank has a slice quiesce pending. Without it, a rank whose
    request came first would block in the cut's allgather at its boundary
    while a peer, with no request yet, stepped into the next collective
    and waited for it: neither reaches the other, and the gather times
    out. With it, every rank learns at the same boundary that a request
    is pending; a rank without its own holds there, bounded by the
    barrier timeout, until its request arrives (a hold that expires
    latches the gate failed). Every rank then publishes the same step.
    A latched failure stops a hold only within its own round: once the
    collective reads no rank pending (:meth:`settle`), the round is over
    everywhere, and a retry (a new nonce) that reaches this rank after a
    peer's holds for its request again.

    ``wait_s`` is the last barrier's wait, ``request_step`` the step at
    which the last request arrived."""

    def __init__(self, coordinator: SliceCoordinator,
                 timeout_s: float | None = None,
                 lockstep: Callable[[bool], bool] | None = None) -> None:
        self.coordinator = coordinator
        self.lockstep = lockstep
        self._timeout_s = timeout_s
        self._lock = threading.Lock()
        self._cut: int | None = None
        self._passed = False
        self.failed: str | None = None
        self._settled = False  # the latched failure's round has ended
        self._nonce = "0"
        self._gen = 0
        self.wait_s: float | None = None
        self.request_step: int | None = None

    def timeout_s(self) -> float:
        if self._timeout_s is not None:
            return self._timeout_s
        return _default_timeout()

    @property
    def cut(self) -> int | None:
        with self._lock:
            return self._cut

    def request(self, flight_dir: str | None = None,
                nonce: str | None = None, step: int | None = None) -> None:
        """Arm for one quiesce round (the agentlet calls it when a slice
        quiesce arrives). ``nonce`` scopes this attempt's rendezvous names;
        a new one clears a latched failure and the cut. ``flight_dir`` is
        accepted for the protocol's sake (the port has no flight recorder
        yet). ``step``: the step the request arrived at."""
        del flight_dir
        with self._lock:
            self.request_step = step
            if nonce is not None and nonce != self._nonce:
                self._nonce = str(nonce)
                self._gen = 0
                self._cut = None
                self._passed = False
                self.failed = None
                self._settled = False

    def reset(self) -> None:
        """Forget the agreed cut and clear a latched failure (every host's
        resume runs it); advance the round generation."""
        with self._lock:
            self._gen += 1
            self._cut = None
            self._passed = False
            self.failed = None
            self._settled = False

    def latch(self, why: str) -> None:
        """Latch the gate failed: the loop trains on and the quiesce
        answers the error."""
        with self._lock:
            self.failed = why
            self._settled = False
        log.error("slice quiesce failed: %s — this host will not park", why)

    def settle(self) -> None:
        """The ``lockstep`` collective read no rank pending: a latched
        failure's round is over on every rank. The latch still answers a
        request of its own nonce, but no longer stops a hold."""
        with self._lock:
            self._settled = self.failed is not None

    @property
    def failed_this_round(self) -> bool:
        """A failure latched in the round still under way: a hold for this
        rank's request would wait for a request that cannot park."""
        with self._lock:
            return self.failed is not None and not self._settled

    def ready_to_park(self, step: int) -> bool:
        """Whether the loop may park at this step boundary: False while the
        slice has not agreed, this host is below the cut, or the gate
        failed. Blocks, bounded, in the cut's allgather and at the cut's
        barrier."""
        with self._lock:
            if self.failed is not None:
                return False
            if self._passed:
                return True
            cut = self._cut
            nonce = f"{self._nonce}.g{self._gen}"
        rdv = self.coordinator.rendezvous
        try:
            if cut is None:
                steps = rdv.allgather(f"grit/q{nonce}/cut", int(step),
                                      self.coordinator._pidx(),
                                      timeout=self.timeout_s())
                cut = max(int(s) for s in steps)
                with self._lock:
                    self._cut = cut
            if int(step) < cut:
                return False  # run forward to the agreed boundary
            t0 = time.monotonic()
            try:
                rdv.barrier(f"grit/q{nonce}/barrier-{cut}",
                            timeout=self.timeout_s())
            finally:
                self.wait_s = time.monotonic() - t0
        except Exception as exc:  # noqa: BLE001 — latch, never kill the loop
            self.latch(f"{type(exc).__name__}: {exc}")
            return False
        with self._lock:
            self._passed = True
        return True
