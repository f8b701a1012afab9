"""In-process snapshot fan-out: one staged snapshot into N clone engines.

Counterpart of ``grit_tpu/serving/fanout.py``. Every clone engine on a
node restores from the same staged tree, so the read of the snapshot is
shared rather than multiplied by the replica count.
:func:`fan_out_clones` runs the engines' post-copy restores in parallel
threads: each clone's hot set is placed before it returns, the clone
serves new traffic at once, and its cold KV cache lands behind that
traffic. The reference's ``serve.clone.*`` flight events are not ported
yet (the port has no flight recorder).
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field


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
        try:
            leg.handle = leg.engine.restore_postcopy(directory)
            leg.hot_placed_s = time.monotonic() - leg._t0
        except BaseException as exc:  # noqa: BLE001 — sibling isolation
            leg.error = exc

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
    return legs
