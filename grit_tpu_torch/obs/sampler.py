"""Periodic observability sampler: keeps edge-triggered gauges fresh.

Counterpart of ``grit_tpu/obs/sampler.py``. Some gauges move only when an
event fires (``grit_codec_queue_depth`` at a pool submission), so a
scrape between events reads a stale edge. One daemon thread a process
(``grit-obs-sampler``), ticking every ``GRIT_OBS_SAMPLE_S`` seconds, runs
registered callbacks that re-derive them from live state: the codec
pool's backlog, the resource ledger (:func:`~grit_tpu_torch.obs.profile.sample_ledger`)
and the progress gauges and snapshot files
(:func:`~grit_tpu_torch.obs.progress.sample`). The workload's ``/metrics``
server starts it.

``stop()`` sets an event the loop waits on and joins with a timeout: no
unbounded join, no thread outliving the intent to stop it. A failing
callback logs once and the others keep sampling.
"""

from __future__ import annotations

import logging
import threading
from collections.abc import Callable

from grit_tpu_torch.api import config

log = logging.getLogger(__name__)


def _sample_codec_queue_depth() -> None:
    from grit_tpu_torch import codec  # noqa: PLC0415 — torch-free, import-light

    codec.sample_queue_depth()


def _sample_progress() -> None:
    from grit_tpu_torch.obs import progress  # noqa: PLC0415

    progress.sample()


def _sample_ledger() -> None:
    from grit_tpu_torch.obs import profile  # noqa: PLC0415

    profile.sample_ledger()


class Sampler:
    """Bounded-period callback loop on a daemon thread."""

    def __init__(self, period_s: float | None = None) -> None:
        self.period_s = max(
            0.05, float(period_s if period_s is not None
                        else config.OBS_SAMPLE_S.get()))
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self._lock = threading.Lock()
        self._callbacks: dict[str, Callable[[], None]] = {}
        self._warned: set[str] = set()

    def register(self, name: str, fn: Callable[[], None]) -> None:
        with self._lock:
            self._callbacks[name] = fn

    def unregister(self, name: str) -> None:
        with self._lock:
            self._callbacks.pop(name, None)

    def sample_once(self) -> None:
        with self._lock:
            callbacks = list(self._callbacks.items())
        for name, fn in callbacks:
            try:
                fn()
            except Exception as exc:  # noqa: BLE001 — one bad cb ≠ dead loop
                if name not in self._warned:
                    self._warned.add(name)
                    log.warning("sampler callback %s failing: %s", name, exc)

    def _loop(self) -> None:
        while not self._stop.wait(self.period_s):
            self.sample_once()

    @property
    def running(self) -> bool:
        return self._thread is not None and self._thread.is_alive()

    def start(self) -> "Sampler":
        if self.running:
            return self
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._loop, name="grit-obs-sampler", daemon=True)
        self._thread.start()
        return self

    def stop(self, timeout: float = 2.0, final_sample: bool = True) -> None:
        """Signal the loop and join BOUNDED (the clean-daemon-shutdown
        contract: a wedged callback must not pin the caller). A final
        synchronous sample by default, so short runs still publish their
        terminal state."""
        self._stop.set()
        thread = self._thread
        if thread is not None:
            thread.join(timeout=timeout)
            if thread.is_alive():
                log.warning("obs sampler did not stop within %.1fs "
                            "(daemon thread; abandoning it)", timeout)
            self._thread = None
        if final_sample:
            self.sample_once()

    def __enter__(self) -> "Sampler":
        return self.start()

    def __exit__(self, *exc: object) -> None:
        self.stop()


_lock = threading.Lock()
_sampler: Sampler | None = None


def default_sampler() -> Sampler:
    """The process-wide sampler, with the default callback set (codec
    queue depth, the resource ledger, migration progress) registered.
    Not started: the caller owns the lifecycle (the workload's metrics
    server starts it)."""
    global _sampler
    with _lock:
        if _sampler is None:
            _sampler = Sampler()
            _sampler.register("codec-queue-depth",
                              _sample_codec_queue_depth)
            # Ledger BEFORE progress: the ledger stamp rides the same
            # tick's snapshot publish instead of trailing one period.
            _sampler.register("resource-ledger", _sample_ledger)
            _sampler.register("migration-progress", _sample_progress)
        return _sampler


def start() -> Sampler:
    return default_sampler().start()


def stop(timeout: float = 2.0) -> None:
    with _lock:
        sampler = _sampler
    if sampler is not None:
        sampler.stop(timeout=timeout)


def reset() -> None:
    """Drop the global sampler (tests)."""
    global _sampler
    with _lock:
        sampler, _sampler = _sampler, None
    if sampler is not None:
        sampler.stop(final_sample=False)
