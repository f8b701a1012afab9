"""Fault-injection registry: named fault points threaded through the port.

Counterpart of ``grit_tpu/faults.py``, with the same spec syntax, modes
and registry, so one ``GRIT_FAULT_POINTS`` value arms the reference's
agent and a port workload alike (the chaos suite's contract)::

    GRIT_FAULT_POINTS=<spec>[,<spec>...]
    spec = <point>:<mode>[:<arg>][:xN]

    modes:
      raise            raise FaultInjected at the point
      delay[:secs]     sleep secs (default 0.1) then continue
      hang[:secs]      sleep secs (default 3600) — a wedged leg
      kill[:code]      os._exit(code) (default 137) — the process
                       SIGKILLed mid-flight (no error-path cleanup runs)
      truncate[:n]     at fault_write() sites: pass only the first n bytes
                       (default 0) through — a torn write
    xN                 arm for the first N hits only (default: every hit)

Points are cheap when unarmed: one cached env lookup per call. The parse
cache is keyed on the raw env string, so flipping the env between calls
needs no explicit reset (``reset()`` clears hit counters too).

The port's seams: ``device.snapshot.{dump,mirror,place}``,
``restore.postcopy_fault``, ``snap.speculate``,
``device.agentlet.{quiesce,dump,resume}``, ``codec.{compress,decompress}``,
``wire.send``, ``serve.drain`` and ``slice.barrier``.
"""

from __future__ import annotations

import os
import threading
import time
from dataclasses import dataclass

from grit_tpu_torch.api import config

FAULT_POINTS_ENV = config.FAULT_POINTS.name

#: The reference's registry, whole: one ``GRIT_FAULT_POINTS`` value reaches
#: the agent and the workload alike, so the strict parse accepts every
#: name the agent knows, including points with no seam in this package.
#: ``tests/test_torch_faults.py`` holds it equal to the reference's and
#: finds a literal call site here for each point the port carries.
KNOWN_POINTS = (
    # agent: checkpoint driver
    "agent.checkpoint.predump",
    "precopy.round",
    # agent: preemption-armed standby (grit_tpu.agent.standby)
    "standby.round",
    "standby.governor",
    "standby.fire",
    "agent.checkpoint.dump",
    "agent.checkpoint.upload",
    "agent.checkpoint.wire_send",
    "agent.checkpoint.commit",
    # gang slice migration (parallel/coordination.py quiesce barrier +
    # agent/slicerole.py gang ledger)
    "slice.barrier",
    "slice.commit",
    "slice.abort",
    # agent: restore driver
    "agent.restore.prestage",
    "agent.restore.stage",
    "agent.restore.stream",
    "agent.restore.wire_wait",
    # agent: data mover / wire transport
    "agent.copy.transfer",
    "agent.copy.chunk_write",
    "wire.send",
    "wire.recv",
    "wire.commit",
    # codec stage (snapshot-transport compression, grit_tpu.codec)
    "codec.compress",
    "codec.decompress",
    # native file data plane (gritio-file): io.drain fires at the dump
    # mirror's native-drain creation seam (raise = this dump's tee runs
    # the Python plane, loudly — the degrade ladder under chaos);
    # io.place fires per native container/batched-raw read (raise = that
    # read degrades to the Python decode path, loudly; the restore stays
    # bit-identical either way).
    "io.drain",
    "io.place",
    # device layer: snap.speculate fires at the start of every
    # speculative (quiesce-free) snapshot pass — the clone + concurrent
    # dump that overlaps execution; raise = this round degrades loudly
    # to the parked dump, bit-identical (the validated-speculation
    # degrade ladder).
    "snap.speculate",
    "device.snapshot.dump",
    "device.snapshot.place",
    "restore.postcopy_fault",
    "device.snapshot.mirror",
    "device.agentlet.quiesce",
    "device.agentlet.dump",
    "device.agentlet.resume",
    # CRIU adapter
    "cri.criu.dump",
    "cri.criu.restore",
    # manager control plane
    "manager.checkpoint.reconcile",
    "manager.restore.reconcile",
    # fleet migration scheduler (manager/fleet/plan_controller.py):
    # fleet.place fires per destination-candidate probe (raise = that
    # destination rejects placement this pass), fleet.budget at each
    # admission decision (raise = admission deferred, member stays
    # queued), fleet.wave at the top of every wave reconcile (raise =
    # workqueue error path — the wave resumes on the retry).
    "fleet.place",
    "fleet.budget",
    "fleet.wave",
    # serving snapshot fan-out (grit_tpu.serving + restoreset
    # controller): serve.drain fires at the serving agentlet's
    # request-drain seam (raise = the drain — and with it the quiesce
    # attempt — fails; the engine keeps serving), serve.verify at the
    # RestoreSet template-verify seam (raise = workqueue error path,
    # the verify retries level-triggered), serve.clone per clone
    # Restore creation (raise = only that clone's creation is skipped
    # this pass; siblings fan out and the clone retries next reconcile).
    "serve.drain",
    "serve.verify",
    "serve.clone",
)

_MODES = ("raise", "delay", "hang", "kill", "truncate")


class FaultInjected(RuntimeError):
    """An armed fault point fired. Deliberately a plain RuntimeError
    subclass: injected faults must travel the same error paths real
    failures do (classification, journal poisoning, error-path resume)."""

    def __init__(self, point: str):
        super().__init__(f"injected fault at {point}")
        self.point = point


@dataclass
class FaultSpec:
    point: str
    mode: str
    arg: float | None = None
    max_hits: int | None = None  # None = every hit


class FaultSyntaxError(ValueError):
    """Malformed GRIT_FAULT_POINTS value. Raised at parse time so an
    operator typo fails the agent loudly instead of silently disarming
    the chaos run it was meant to drive."""


def parse_fault_points(raw: str) -> dict[str, FaultSpec]:
    """``spec[,spec...]`` → {point: FaultSpec}. Empty/blank → {}."""
    specs: dict[str, FaultSpec] = {}
    for item in raw.split(","):
        item = item.strip()
        if not item:
            continue
        parts = item.split(":")
        if len(parts) < 2:
            raise FaultSyntaxError(
                f"fault spec {item!r}: want <point>:<mode>[:<arg>][:xN]")
        point, mode, rest = parts[0], parts[1], parts[2:]
        if mode not in _MODES:
            raise FaultSyntaxError(
                f"fault spec {item!r}: unknown mode {mode!r} "
                f"(known: {', '.join(_MODES)})")
        arg: float | None = None
        max_hits: int | None = None
        for extra in rest:
            if extra.startswith("x") and extra[1:].isdigit():
                max_hits = int(extra[1:])
            else:
                try:
                    arg = float(extra)
                except ValueError as exc:
                    raise FaultSyntaxError(
                        f"fault spec {item!r}: bad arg {extra!r}") from exc
        specs[point] = FaultSpec(point=point, mode=mode, arg=arg,
                                 max_hits=max_hits)
    return specs


def validate_fault_points(raw: str) -> dict[str, FaultSpec]:
    """Strict parse for operator-facing entry points (the agent CLI):
    syntax AND point names are checked against :data:`KNOWN_POINTS`, so a
    misspelled point fails the Job terminally instead of silently
    disarming the chaos run it was meant to drive. (The lazy in-process
    parse stays name-agnostic — tests arm synthetic points freely.)"""
    specs = parse_fault_points(raw)
    unknown = sorted(p for p in specs if p not in KNOWN_POINTS)
    if unknown:
        raise FaultSyntaxError(
            f"unknown fault point(s) {', '.join(unknown)} — see "
            "grit_tpu_torch.faults.KNOWN_POINTS")
    return specs


_lock = threading.Lock()
_cache_raw: str | None = None
_cache_specs: dict[str, FaultSpec] = {}
_hits: dict[str, int] = {}


def _active() -> dict[str, FaultSpec]:
    global _cache_raw, _cache_specs
    raw = config.FAULT_POINTS.get()
    with _lock:
        if raw != _cache_raw:
            _cache_specs = parse_fault_points(raw)
            _cache_raw = raw
            _hits.clear()
        return _cache_specs


def reset() -> None:
    """Forget parse cache and hit counters (tests)."""
    global _cache_raw, _cache_specs
    with _lock:
        _cache_raw = None
        _cache_specs = {}
        _hits.clear()


def _take_hit(spec: FaultSpec) -> bool:
    """Count a hit; True if the point should fire this time."""
    with _lock:
        n = _hits.get(spec.point, 0) + 1
        _hits[spec.point] = n
    return spec.max_hits is None or n <= spec.max_hits


def hits(point: str) -> int:
    with _lock:
        return _hits.get(point, 0)


def fault_point(point: str, wrap: type[BaseException] | None = None) -> None:
    """Fire ``point`` if armed. No-op (one env read) otherwise.

    ``wrap`` names the exception type an injected ``raise`` travels as —
    sites whose callers classify by type (the wire transport's WireError
    fallback protocol) pass it so the injected failure takes the same
    recovery path a real one would; the original FaultInjected rides
    along as ``__cause__``.

    ``truncate`` at a non-write site degrades to ``raise``: a spec asking
    for a torn write where no write happens still makes the leg fail,
    which is the intent of arming it at all.
    """
    spec = _active().get(point)
    if spec is None or not _take_hit(spec):
        return
    if spec.mode == "delay":
        time.sleep(spec.arg if spec.arg is not None else 0.1)
    elif spec.mode == "hang":
        time.sleep(spec.arg if spec.arg is not None else 3600.0)
    elif spec.mode == "kill":
        os._exit(int(spec.arg) if spec.arg is not None else 137)
    else:  # raise, or truncate-at-non-write-site
        injected = FaultInjected(point)
        if wrap is not None:
            raise wrap(str(injected)) from injected
        raise injected


def fault_write(point: str, data: bytes) -> bytes:
    """Write-site variant: ``truncate`` returns a clipped buffer (a torn
    write the integrity machinery must catch); every other mode behaves
    like :func:`fault_point`. Returns the (possibly clipped) data."""
    spec = _active().get(point)
    if spec is None:
        return data
    if spec.mode == "truncate":
        if not _take_hit(spec):
            return data
        n = int(spec.arg) if spec.arg is not None else 0
        return data[:n]
    fault_point(point)
    return data
