"""In-process snapshot fan-out: one staged snapshot into N clone engines.

Counterpart of ``grit_tpu/serving/fanout.py``. Every clone engine on a
node restores from the same staged tree, so the read of the snapshot is
shared rather than multiplied by the replica count.
:func:`fan_out_clones` runs the engines' post-copy restores in parallel
threads: each clone's hot set is placed before it returns, the clone
serves new traffic at once, and its cold KV cache lands behind that
traffic. Each leg's ``serve.clone.start``, ``serve.clone.ready`` or
``serve.clone.abort`` lands on the flight log governing the snapshot, and
a first served token emits ``serve.clone.served``, as the reference's
legs do.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field

from grit_tpu_torch.obs import flight


@dataclass
class CloneLeg:
    """One clone of the fan-out: its engine, its in-flight post-copy
    handle, and the times the evidence reads."""

    ordinal: int
    engine: object
    handle: object = None
    hot_placed_s: float = 0.0   # restore call → hot set placed
    first_token_s: float = 0.0  # restore call → first served token
    served_before_tail: bool = False
    error: BaseException | None = None
    _t0: float = field(default=0.0, repr=False)

    def serve_first(self, prompt, max_steps: int = 512) -> int:
        """Admit ``prompt`` into a free slot and decode its first token,
        the replica's first served request; records whether the cold tail
        was still landing when the token came back (measured, not
        assumed)."""
        slot = self.engine.submit(prompt)
        for _ in range(max_steps):
            emitted = self.engine.step()
            if slot in emitted:
                self.served_before_tail = (self.handle is not None
                                           and not self.handle.done)
                self.first_token_s = time.monotonic() - self._t0
                flight.emit("serve.clone.served", ordinal=self.ordinal,
                            first_token_s=round(self.first_token_s, 4),
                            tail_in_flight=self.served_before_tail)
                return emitted[slot]
        raise RuntimeError(f"clone {self.ordinal} never emitted a token")

    def finish(self, timeout: float | None = None) -> None:
        """Absorb the restored streams (waits for the cold tail)."""
        self.engine.absorb_restored(timeout=timeout)


def fan_out_clones(directory: str, engines, *,
                   parallel: bool = True) -> list[CloneLeg]:
    """Start a post-copy restore of ``directory`` on every engine; one
    :class:`CloneLeg` per engine, its hot set placed (the cold tails keep
    landing). A clone whose restore raises carries the error on its own
    leg, and its siblings go on: the replicas are independent."""
    legs = [CloneLeg(ordinal=k, engine=e) for k, e in enumerate(engines)]

    def one(leg: CloneLeg) -> None:
        leg._t0 = time.monotonic()
        flight.emit_near(directory, "serve.clone.start", ordinal=leg.ordinal,
                         clone=f"clone-{leg.ordinal}")
        try:
            leg.handle = leg.engine.restore_postcopy(directory)
            leg.hot_placed_s = time.monotonic() - leg._t0
        except BaseException as exc:  # noqa: BLE001 — sibling isolation
            leg.error = exc
            flight.emit_near(directory, "serve.clone.abort",
                             ordinal=leg.ordinal,
                             reason=f"{type(exc).__name__}: {exc}")

    if parallel:
        threads = [threading.Thread(target=one, args=(leg,),
                                    name=f"grit-clone-{leg.ordinal}",
                                    daemon=True) for leg in legs]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
    else:
        for leg in legs:
            one(leg)
    for leg in legs:
        if leg.error is None:
            flight.emit_near(directory, "serve.clone.ready",
                             ordinal=leg.ordinal,
                             hot_placed_s=round(leg.hot_placed_s, 4))
    return legs
