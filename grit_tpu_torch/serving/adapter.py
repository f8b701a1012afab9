"""Serving agentlet: the quiesce hook generalised to a request-drain hook.

Counterpart of ``grit_tpu/serving/adapter.py``. A training loop parks at
its next step boundary; a serving engine has a *batch* boundary (between
decode rounds) and a policy question about the requests in flight when
the quiesce lands:

- ``serialize`` (default): park at the very next batch boundary. The
  in-flight slots' KV, position and RNG state ship inside the snapshot
  (the continuous-batching state is one tree), and the restored replica
  resumes the streams mid-token, bit-identically.
- ``drain``: stop admitting, keep decoding until every in-flight slot
  completes (EOS or the cache limit), then park an empty grid. Bounded by
  ``GRIT_SERVE_DRAIN_TIMEOUT_S``; expiry raises
  :class:`ServingDrainTimeout` out of the serving loop, never a silent
  serialize or a half-drained park.

The adapter owns an ordinary :class:`~grit_tpu_torch.device.agentlet.Agentlet`
(same socket protocol), so the managed checkpoint flow needs nothing
serving-specific: the quiesce takes the drain detour before the park, and
the dump reads the engine's tagged state
(:meth:`~grit_tpu_torch.models.serving.ContinuousBatchingEngine.snapshot_state`).

The drain carries the reference's seams: the ``serve.drain`` fault point
(an injected raise fails the drain, and with it the quiesce, while the
engine keeps serving), the ``serve.drain.start``/``serve.drain.end``
flight events, and ``SERVE_DRAIN_SECONDS`` and ``SERVE_DRAINED_SLOTS``.
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Callable

from grit_tpu_torch import faults
from grit_tpu_torch.api import config
from grit_tpu_torch.device.agentlet import Agentlet
from grit_tpu_torch.obs import flight
from grit_tpu_torch.obs.metrics import SERVE_DRAIN_SECONDS, SERVE_DRAINED_SLOTS

log = logging.getLogger(__name__)

DRAIN_SERIALIZE = "serialize"
DRAIN_COMPLETE = "drain"


class ServingDrainTimeout(RuntimeError):
    """The 'drain' policy could not complete every in-flight request
    inside GRIT_SERVE_DRAIN_TIMEOUT_S. Loud on purpose: a silent fallback
    to serialization would change what the snapshot means."""


class ServingDraining(RuntimeError):
    """A submit raced a drain: admission is closed until the migration
    resumes the engine. Callers retry or shed; the request is not queued,
    since a quiesced engine cannot bound how long a queue would hold it."""


class ServingAgentlet:
    """Wraps a ContinuousBatchingEngine with the toggle endpoint.

    The serving loop decodes through :meth:`step`, calls
    :meth:`batch_boundary` once per decode round, and routes admissions
    through :meth:`submit`; the adapter orders cross-thread submits
    against decode rounds and the drain.

    Args:
      engine: the ContinuousBatchingEngine to serve.
      drain_mode: override for GRIT_SERVE_DRAIN_MODE.
      drain_timeout_s: override for GRIT_SERVE_DRAIN_TIMEOUT_S.
      emit_fn: ``(slot, token)`` callback for tokens decoded during a
        drain (the caller's own step loop no longer sees them).
      path: explicit agentlet socket path.
    """

    def __init__(
        self,
        engine,
        *,
        drain_mode: str | None = None,
        drain_timeout_s: float | None = None,
        emit_fn: Callable[[int, int], None] | None = None,
        path: str | None = None,
    ) -> None:
        self.engine = engine
        mode = drain_mode or config.SERVE_DRAIN_MODE.get()
        if mode not in (DRAIN_SERIALIZE, DRAIN_COMPLETE):
            log.warning("unknown %s=%r — degrading to %r",
                        config.SERVE_DRAIN_MODE.name, mode, DRAIN_SERIALIZE)
            mode = DRAIN_SERIALIZE
        self.drain_mode = mode
        self.drain_timeout_s = (
            config.SERVE_DRAIN_TIMEOUT_S.get_float()
            if drain_timeout_s is None else float(drain_timeout_s))
        self.emit_fn = emit_fn
        self._rounds = 0  # batch boundaries crossed: the "step" counter
        self.last_drain: dict = {}  # evidence of the most recent drain
        # Orders submit against the cutover and against step: an admission
        # holding this lock completes before the drain starts (and ships
        # in the snapshot); one starting after the quiesce landed sees
        # `draining` and raises.
        self._admission = threading.Lock()
        self.agentlet = Agentlet(
            # The dump ships the tagged state; the park's device drain
            # blocks on the raw state (a tagged copy per quiesce would be
            # built and thrown away inside the blackout).
            state_fn=engine.snapshot_state,
            quiesce_state_fn=lambda: engine.state,
            pre_park_fn=self._pre_park,
            step_fn=lambda: self._rounds,
            meta_fn=self._meta,
            path=path,
        )

    def _meta(self) -> dict:
        return {
            "serving": True,
            "drain_mode": self.drain_mode,
            "active_slots": int(self.engine.state["active"].sum()),
            # The engine's own metadata rides the managed dump too:
            # without "submissions" a restored engine's first admission
            # would reuse an RNG stream a running slot already has.
            **self.engine.snapshot_meta(),
        }

    # -- lifecycle --------------------------------------------------------------

    def start(self) -> "ServingAgentlet":
        self.agentlet.start()
        return self

    def stop(self) -> None:
        self.agentlet.stop()

    def __enter__(self) -> "ServingAgentlet":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    # -- serving loop hooks -----------------------------------------------------

    @property
    def draining(self) -> bool:
        """Admission is closed from the quiesce request until resume:
        while the drain runs and while the engine is parked (a prompt
        admitted into a parked engine would miss the snapshot, or, in
        drain mode, un-empty the grid the snapshot promised empty)."""
        return self.agentlet.quiesce_pending or self.agentlet.paused

    def submit(self, prompt) -> int:
        """Admission gate (see :attr:`draining`), serialized against the
        drain and against :meth:`step` by the admission lock."""
        with self._admission:
            if self.draining:
                raise ServingDraining(
                    "engine is draining for a snapshot — retry after resume")
            return self.engine.submit(prompt)

    def step(self) -> dict[int, int]:
        """One decode round, serialized against cross-thread submits: the
        engine's state updates are read-modify-write, so a submit racing
        a round would lose one side's write."""
        with self._admission:
            return self.engine.step()

    def batch_boundary(self) -> None:
        """Call once per decode round, on the serving loop's thread. A
        pending quiesce runs the drain policy (the agentlet's pre-park
        hook, atomic with the park decision) and parks until resume."""
        self._rounds += 1
        self.agentlet.checkpoint_point()

    def _pre_park(self) -> None:
        # Barrier: an admission that read `draining` False completes
        # before the drain starts; every later one sees the pending
        # quiesce and is refused.
        with self._admission:
            pass
        self._drain()

    # -- the drain itself -------------------------------------------------------

    def _drain(self) -> None:
        t0 = time.monotonic()
        if not getattr(self.engine, "resumed_all", True):
            # A clone still mid post-copy restore: settle the merge now, so
            # the drain sees (and drain mode finishes) the migrated streams
            # too; the dump-time absorb would re-activate them into a grid
            # the drain declared empty. The drain budget bounds the absorb:
            # a stalled tail surfaces as the drain's loud timeout.
            try:
                self.engine.absorb_restored(
                    timeout=max(0.001, self.drain_timeout_s))
            except TimeoutError as exc:
                raise ServingDrainTimeout(
                    f"cold post-copy tail still landing after "
                    f"{self.drain_timeout_s:.0f}s "
                    f"({config.SERVE_DRAIN_TIMEOUT_S.name}): {exc}") from exc
        in_flight = int(self.engine.state["active"].sum())
        flight.emit("serve.drain.start", mode=self.drain_mode, slots=in_flight)
        ok = False
        drained_tokens = 0
        try:
            faults.fault_point("serve.drain")
            if self.drain_mode == DRAIN_COMPLETE and in_flight:
                deadline = t0 + self.drain_timeout_s
                while True:
                    emitted = self.engine.step()
                    if not emitted:
                        break
                    drained_tokens += len(emitted)
                    if self.emit_fn is not None:
                        for slot, tok in emitted.items():
                            self.emit_fn(slot, tok)
                    if time.monotonic() > deadline:
                        raise ServingDrainTimeout(
                            f"drain still has "
                            f"{int(self.engine.state['active'].sum())} slots "
                            f"in flight after {self.drain_timeout_s:.0f}s "
                            f"({config.SERVE_DRAIN_TIMEOUT_S.name})")
                SERVE_DRAINED_SLOTS.inc(in_flight, how="drained")
            else:
                SERVE_DRAINED_SLOTS.inc(in_flight, how="serialized")
            ok = True
        finally:
            dt = time.monotonic() - t0
            SERVE_DRAIN_SECONDS.set(dt)
            self.last_drain = {
                "mode": self.drain_mode, "slots": in_flight,
                "drained_tokens": drained_tokens,
                "seconds": round(dt, 4), "ok": ok,
            }
            flight.emit("serve.drain.end", mode=self.drain_mode,
                        slots=in_flight, drained_tokens=drained_tokens, ok=ok)
