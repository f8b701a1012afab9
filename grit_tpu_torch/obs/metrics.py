"""Prometheus-text metrics registry of a port workload.

Counterpart of ``grit_tpu/obs/metrics.py``: the same ``Registry``,
``Counter``, ``Gauge`` and ``Histogram`` and the same text exposition, and
of the reference's metric set the families the port's modules feed, under
the same names, help, label names and buckets (dashboards and the agent
read them alike). The manager, fleet, standby, progress and profiler
families are the reference's alone.
"""

from __future__ import annotations

import threading
from typing import Any, Iterable, Mapping, TypeVar


_M = TypeVar("_M", bound="_Metric")


def _fmt_labels(labels: tuple[tuple[str, str], ...]) -> str:
    if not labels:
        return ""
    inner = ",".join(
        f'{k}="{str(v).replace(chr(92), chr(92) * 2).replace(chr(34), chr(92) + chr(34))}"'
        for k, v in labels
    )
    return "{" + inner + "}"


def _fmt_value(v: float) -> str:
    if v == int(v) and abs(v) < 1e15:
        return str(int(v))
    return repr(float(v))


class _Metric:
    kind = "untyped"

    def __init__(self, name: str, help_: str,
                 labelnames: Iterable[str] = ()) -> None:
        self.name = name
        self.help = help_
        self.labelnames = tuple(labelnames)
        self._values: dict[tuple[tuple[str, str], ...], float] = {}
        self._lock = threading.Lock()

    def _key(self, labels: Mapping[str, object]) -> tuple[tuple[str, str], ...]:
        if set(labels) != set(self.labelnames):
            raise ValueError(
                f"metric {self.name}: labels {sorted(labels)} != "
                f"declared {sorted(self.labelnames)}"
            )
        return tuple((k, str(labels[k])) for k in self.labelnames)

    def render(self) -> str:
        lines = [
            f"# HELP {self.name} {self.help}",
            f"# TYPE {self.name} {self.kind}",
        ]
        with self._lock:
            items = sorted(self._values.items())
        if not items and not self.labelnames:
            items = [((), 0.0)]
        for key, val in items:
            lines.append(f"{self.name}{_fmt_labels(key)} {_fmt_value(val)}")
        return "\n".join(lines)


class Counter(_Metric):
    kind = "counter"

    def inc(self, amount: float = 1.0, **labels: object) -> None:
        key = self._key(labels)
        with self._lock:
            self._values[key] = self._values.get(key, 0.0) + amount

    def value(self, **labels: object) -> float:
        with self._lock:
            return self._values.get(self._key(labels), 0.0)


class Gauge(_Metric):
    kind = "gauge"

    def set(self, value: float, **labels: object) -> None:
        with self._lock:
            self._values[self._key(labels)] = float(value)

    def value(self, **labels: object) -> float:
        with self._lock:
            return self._values.get(self._key(labels), 0.0)


class Histogram(_Metric):
    """Cumulative-bucket histogram (the prometheus classic): per label
    set, one counter per ``le`` boundary plus ``_sum``/``_count``.
    Bucket boundaries are DECLARED here, bounded and literal — the
    ``metrics-contract`` lint rejects dynamic or unbounded bucket lists,
    because every boundary is a time series forever."""

    MAX_BUCKETS = 24
    kind = "histogram"

    def __init__(self, name: str, help_: str, buckets: Iterable[float],
                 labelnames: Iterable[str] = ()) -> None:
        super().__init__(name, help_, labelnames)
        bounds = tuple(float(b) for b in buckets)
        if not bounds or len(bounds) > self.MAX_BUCKETS:
            raise ValueError(
                f"histogram {name}: needs 1..{self.MAX_BUCKETS} bucket "
                f"boundaries, got {len(bounds)}")
        if list(bounds) != sorted(set(bounds)):
            raise ValueError(
                f"histogram {name}: bucket boundaries must be strictly "
                "increasing")
        self.buckets = bounds
        # key -> [counts per bound (+inf implicit), sum, count]
        self._hist: dict[tuple[tuple[str, str], ...], list[Any]] = {}

    def observe(self, value: float, **labels: object) -> None:
        key = self._key(labels)
        v = float(value)
        with self._lock:
            slot = self._hist.get(key)
            if slot is None:
                slot = [[0] * (len(self.buckets) + 1), 0.0, 0]
                self._hist[key] = slot
            counts, _sum, _n = slot
            for i, bound in enumerate(self.buckets):
                if v <= bound:
                    counts[i] += 1
                    break
            else:
                counts[len(self.buckets)] += 1
            slot[1] += v
            slot[2] += 1

    def count(self, **labels: object) -> int:
        with self._lock:
            slot = self._hist.get(self._key(labels))
            return int(slot[2]) if slot else 0

    def sum(self, **labels: object) -> float:
        with self._lock:
            slot = self._hist.get(self._key(labels))
            return float(slot[1]) if slot else 0.0

    def render(self) -> str:
        lines = [
            f"# HELP {self.name} {self.help}",
            f"# TYPE {self.name} histogram",
        ]
        with self._lock:
            items = sorted((k, (list(v[0]), v[1], v[2]))
                           for k, v in self._hist.items())
        for key, (counts, total, n) in items:
            cum = 0
            for bound, c in zip(self.buckets, counts):
                cum += c
                le = _fmt_value(bound)
                lines.append(
                    f"{self.name}_bucket"
                    f"{_fmt_labels(key + (('le', le),))} {cum}")
            cum += counts[-1]
            lines.append(
                f"{self.name}_bucket"
                f"{_fmt_labels(key + (('le', '+Inf'),))} {cum}")
            lines.append(
                f"{self.name}_sum{_fmt_labels(key)} {_fmt_value(total)}")
            lines.append(f"{self.name}_count{_fmt_labels(key)} {n}")
        return "\n".join(lines)


class Registry:
    def __init__(self) -> None:
        self._metrics: dict[str, _Metric] = {}
        self._lock = threading.Lock()

    def _get_or_create(self, cls: type[_M], name: str, help_: str,
                       labelnames: Iterable[str]) -> _M:
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = cls(name, help_, labelnames)
                self._metrics[name] = m
            elif not isinstance(m, cls) or m.labelnames != tuple(labelnames):
                raise ValueError(f"metric {name} re-registered with a different shape")
            return m

    def counter(self, name: str, help_: str,
                labelnames: Iterable[str] = ()) -> Counter:
        return self._get_or_create(Counter, name, help_, labelnames)

    def gauge(self, name: str, help_: str,
              labelnames: Iterable[str] = ()) -> Gauge:
        return self._get_or_create(Gauge, name, help_, labelnames)

    def histogram(self, name: str, help_: str, buckets: Iterable[float],
                  labelnames: Iterable[str] = ()) -> Histogram:
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = Histogram(name, help_, buckets, labelnames)
                self._metrics[name] = m
            elif not isinstance(m, Histogram) \
                    or m.labelnames != tuple(labelnames) \
                    or m.buckets != tuple(float(b) for b in buckets):
                raise ValueError(
                    f"metric {name} re-registered with a different shape")
            return m

    def render(self) -> str:
        with self._lock:
            metrics = [self._metrics[k] for k in sorted(self._metrics)]
        return "\n".join(m.render() for m in metrics) + "\n"


REGISTRY = Registry()

# -- the snapshot engine -------------------------------------------------------

SNAPSHOT_BYTES = REGISTRY.counter(
    "grit_snapshot_bytes_total",
    "Bytes written/read by the HBM snapshot engine",
    ("op",),
)

SNAPSHOT_SECONDS = REGISTRY.counter(
    "grit_snapshot_seconds_total",
    "Wall seconds spent writing/reading HBM snapshots",
    ("op",),
)

SNAP_SPECULATIVE_BYTES = REGISTRY.counter(
    "grit_snap_speculative_bytes_total",
    "Validated-speculation byte accounting at the parked re-ship: clean "
    "= bytes the speculative pass already shipped that validation let "
    "the re-ship reference (zero device reads), dirty = bytes the "
    "in-flight step touched that had to re-ship inside the window",
    ("outcome",),  # clean | dirty
)

SNAP_SPECULATIVE_SECONDS = REGISTRY.counter(
    "grit_snap_speculative_seconds_total",
    "Wall seconds of the speculative dump machinery: concurrent = the "
    "speculative pass overlapping execution (outside the park), "
    "validate = the per-array device compare at the step boundary",
    ("phase",),  # concurrent | validate
)

SNAP_SPECULATIVE_ROUNDS = REGISTRY.counter(
    "grit_snap_speculative_rounds_total",
    "Speculative dump outcomes: validated = parked re-ship referenced "
    "the speculative pass, degraded = speculation lost (fault, timeout, "
    "structure change) and the dump fell back to the parked full path, "
    "probe = non-parking standby probe served entirely speculatively",
    ("outcome",),  # validated | degraded | probe
)

# -- the restore pipeline ------------------------------------------------------

RESTORE_PIPELINE_SECONDS = REGISTRY.counter(
    "grit_restore_pipeline_seconds_total",
    "Summed per-leg durations of the restore data path (stage_wait = "
    "blocked on the streamed-staging journal, read = disk+checksum, "
    "place = host-to-device puts); wall clock overlaps these legs",
    ("phase",),
)

RESTORE_OVERLAP_FRACTION = REGISTRY.gauge(
    "grit_restore_overlap_fraction",
    "1 - wall/(stage_wait+read+place) of the most recent restore: the "
    "fraction of serial leg time the pipelined restore hid",
)

PLACE_CHUNK_SECONDS = REGISTRY.histogram(
    "grit_place_chunk_seconds",
    "Per-array host-to-device place latency inside the restore pipeline "
    "(the top-priority blackout phase) — a fat tail here means device "
    "puts, not staging, bound the restore",
    (0.001, 0.005, 0.02, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 15.0,
     60.0),
)

# -- the codec stage -----------------------------------------------------------

CODEC_BYTES = REGISTRY.counter(
    "grit_codec_bytes_total",
    "Bytes through the snapshot-transport codec stage, by direction: "
    "compress_in/compress_out = raw/compressed bytes of blocks that "
    "shipped compressed, compress_raw_shipped = raw bytes the adaptive "
    "sampler decided to ship uncompressed, decompress_in/decompress_out "
    "= compressed/raw bytes decoded on the receive side",
    ("dir", "codec"),
)

CODEC_SECONDS = REGISTRY.counter(
    "grit_codec_seconds_total",
    "Summed worker seconds spent in the PYTHON codec pool (sampling + "
    "compress, or decompress + CRC), by direction; the pool overlaps "
    "this with transport, so compare against wire/transfer seconds to "
    "see whether the codec hid inside the data path. The native file "
    "plane's drain does its codec work in C threads and reports bytes "
    "(grit_codec_bytes_total still counts) but not worker-seconds — "
    "its pacing evidence is grit_io_drain_seconds + the io.drain event",
    ("dir",),
)

CODEC_QUEUE_DEPTH = REGISTRY.gauge(
    "grit_codec_queue_depth",
    "Jobs queued (not yet picked up) in the shared codec worker pool at "
    "the most recent submission — sustained depth means the codec stage, "
    "not the transport, is the bottleneck of the dump/receive path",
)

CODEC_RATIO = REGISTRY.gauge(
    "grit_codec_ratio",
    "compressed/raw byte ratio of the most recent dump transport "
    "session (adaptive raw-shipped blocks count at 1.0), per direction "
    "of travel on this node",
)

CODEC_WAIT_SECONDS = REGISTRY.histogram(
    "grit_codec_wait_seconds",
    "Per-block wait for a codec pool result on the dump/wire producer "
    "side — sustained mass in the high buckets means the codec pool, "
    "not the transport, is pacing the data path",
    (0.0005, 0.002, 0.005, 0.02, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 10.0),
)

# -- the wire's sending side ---------------------------------------------------

WIRE_BYTES = REGISTRY.counter(
    "grit_wire_bytes_total",
    "Bytes moved over the direct source-to-destination migration wire",
    ("role",),  # send | recv
)

WIRE_SECONDS = REGISTRY.counter(
    "grit_wire_seconds_total",
    "Wall seconds of the wire leg, by phase: send = socket writes, "
    "stall = producer blocked on the bounded send queue (slow consumer "
    "backpressure), ack = waiting for the destination's commit ack",
    ("phase",),
)

WIRE_STALL_SECONDS = REGISTRY.histogram(
    "grit_wire_stall_seconds",
    "Duration of each producer stall on the bounded wire send queues "
    "(backpressure episodes, not their sum — grit_wire_seconds_total "
    "has that): many short stalls are healthy pacing, few long ones "
    "are a wedged consumer",
    (0.005, 0.02, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 15.0, 60.0),
)

WIRE_FRAME_SEND_SECONDS = REGISTRY.histogram(
    "grit_wire_frame_send_seconds",
    "Per-frame socket write latency on the wire send workers; the "
    "distribution separates a uniformly slow link from intermittent "
    "receiver pushback",
    (0.0005, 0.002, 0.005, 0.02, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 10.0),
)

# -- serving and the gang cut --------------------------------------------------

SERVE_DRAIN_SECONDS = REGISTRY.gauge(
    "grit_serve_drain_seconds",
    "Wall seconds the most recent request-drain took between the "
    "quiesce request landing and the engine parking at its batch "
    "boundary — the serving workload's contribution to the blackout "
    "window (serialize mode: one batch boundary; drain mode: the "
    "run-to-completion tail)",
)

SERVE_DRAINED_SLOTS = REGISTRY.counter(
    "grit_serve_drained_slots_total",
    "In-flight slots resolved by request drains, by how: serialized "
    "(KV/position state shipped inside the snapshot) or drained "
    "(decoded to EOS/length before the park)",
    ("how",),
)

SERVE_CLONES = REGISTRY.counter(
    "grit_serve_clones_total",
    "Clone restore legs a RestoreSet resolved, by outcome: ready "
    "(Restore reached Restored), failed (terminal failure — recorded "
    "in status.replicas[], siblings unaffected), skipped (creation "
    "deferred by an armed serve.clone fault; retried next reconcile)",
    ("outcome",),
)

SLICE_BARRIER_SECONDS = REGISTRY.gauge(
    "grit_slice_barrier_seconds",
    "Wall seconds this host spent waiting at the most recent cross-host "
    "quiesce barrier after reaching the agreed cut step (the straggler "
    "wait — the slice quiesce scales with its max across hosts)",
)

# -- the flight recorder -------------------------------------------------------

FLIGHT_EVENTS = REGISTRY.counter(
    "grit_flight_events_total",
    "Flight-recorder events emitted by this process, by phase family "
    "(the first dotted segment of the event name — a closed vocabulary "
    "from grit_tpu.obs.flight.EVENTS)",
    ("phase",),
)
