"""The chunk codec stage of the snapshot's transport: blocks, the worker
pool and the container format.

Counterpart of ``grit_tpu/codec.py``, byte for byte in what it writes: a
block compressed here decodes there and the other way round, and the
container (concatenated block payloads) with its ``<file>.gritc`` sidecar
(one JSON line per block mapping raw to container offsets, then a
terminal line) is the reference's format, so either package restores a
mirror the other wrote.

- Codecs: ``zlib`` (stdlib), ``zstd`` where the ``zstandard`` module is
  importable (without it, ``zstd`` degrades loudly to ``zlib`` on the
  write side and a zstd block raises :class:`CodecError` on the read
  side), ``none``; an all-zero block ships as an empty ``zero`` payload.
- Adaptive raw-ship: a chunk whose head and middle samples
  (``GRIT_CODEC_SAMPLE_KB``) do not compress below
  ``GRIT_CODEC_MIN_RATIO`` ships raw (:func:`decide_codec`).
- Every block carries the zlib crc32 of its raw bytes, checked after
  decode (:func:`decompress_block`).
- The bounded worker pool (``GRIT_CODEC_WORKERS``) compresses blocks in
  parallel: zlib releases the GIL. A submission carries the caller's
  trace context into the worker (:func:`pool_submit`). The sampler and
  the resource ledger read its backlog and saturation
  (:func:`queue_depth`, :func:`active_jobs`, :func:`pool_saturation`,
  :func:`sample_queue_depth`), which never creates the pool.
- The reference's seams: the ``codec.compress`` and ``codec.decompress``
  fault points (an injected raise travels as :class:`CodecError`) and the
  ``CODEC_BYTES``, ``CODEC_SECONDS`` and ``CODEC_QUEUE_DEPTH`` metrics.

Not here: the reference's native container read
(``native_container_range``), which is ``libgritio``'s.
"""

from __future__ import annotations

import json
import logging
import os
import threading
import time
import zlib
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass

from grit_tpu_torch import faults
from grit_tpu_torch.api import config
from grit_tpu_torch.obs import trace
from grit_tpu_torch.obs.metrics import CODEC_BYTES, CODEC_QUEUE_DEPTH, CODEC_SECONDS

log = logging.getLogger(__name__)

# Codec names as they appear in wire headers and sidecar records.
CODEC_NONE = "none"
CODEC_ZLIB = "zlib"
CODEC_ZSTD = "zstd"
# An all-zero block ships as an empty payload; applied whenever a
# compression codec is active, never a GRIT_SNAPSHOT_CODEC value.
CODEC_ZERO = "zero"
CODECS = (CODEC_NONE, CODEC_ZLIB, CODEC_ZSTD)

# Raw bytes per block, compressed independently; equal to the wire's
# frame size, so one block is one frame.
BLOCK_BYTES = 4 * 1024 * 1024

SIDECAR_SUFFIX = ".gritc"
SIDECAR_FORMAT = "grit-codec-1"

# Fast levels: the codec has to hide inside the transport's time.
_ZLIB_LEVEL = 1
_ZSTD_LEVEL = 3


class CodecError(RuntimeError):
    """A codec operation failed or a payload is corrupt (unknown codec id,
    decoded size or CRC-of-raw mismatch); callers treat it as a torn
    transfer."""


def zstd_available() -> bool:
    try:
        import zstandard  # noqa: F401, PLC0415

        return True
    except ImportError:
        return False


_warned: set[str] = set()


def _warn_once(key: str, msg: str, *args) -> None:
    if key not in _warned:
        _warned.add(key)
        log.warning(msg, *args)


def resolve_codec(name: str | None = None) -> str:
    """The effective codec: ``name`` (or ``GRIT_SNAPSHOT_CODEC``) checked
    against :data:`CODECS`. An unknown name degrades to ``none`` and
    ``zstd`` without ``zstandard`` to ``zlib``, each with a warning once."""
    if name is None:
        name = config.SNAPSHOT_CODEC.get()
    if name not in CODECS:
        _warn_once(f"unknown:{name}",
                   "unknown snapshot codec %r; shipping uncompressed "
                   "(known: %s)", name, ", ".join(CODECS))
        return CODEC_NONE
    if name == CODEC_ZSTD and not zstd_available():
        _warn_once("nozstd",
                   "GRIT_SNAPSHOT_CODEC=zstd but the zstandard module is "
                   "not installed; degrading to zlib")
        return CODEC_ZLIB
    return name


def _compress(codec: str, view) -> bytes:
    if codec == CODEC_ZLIB:
        return zlib.compress(view, _ZLIB_LEVEL)
    if codec == CODEC_ZSTD:
        import zstandard  # noqa: PLC0415

        return zstandard.ZstdCompressor(level=_ZSTD_LEVEL).compress(
            bytes(view))
    raise CodecError(f"cannot compress with codec {codec!r}")


def _all_zero(view) -> bool:
    import numpy as np  # noqa: PLC0415

    if isinstance(view, np.ndarray):
        return not view.any()
    return bytes(view).count(0) == len(view)


def _decompress(codec: str, payload, raw_n: int) -> bytes:
    if codec == CODEC_ZERO:
        if len(payload):
            raise CodecError(
                f"zero-elided block carries {len(payload)} payload bytes")
        return bytes(raw_n)
    if codec == CODEC_ZLIB:
        return zlib.decompress(payload)
    if codec == CODEC_ZSTD:
        if not zstd_available():
            raise CodecError(
                "stream carries zstd blocks but the zstandard module is "
                "not installed on the receive side")
        import zstandard  # noqa: PLC0415

        return zstandard.ZstdDecompressor().decompress(
            bytes(payload), max_output_size=raw_n)
    raise CodecError(f"unknown codec id {codec!r}")


def decide_codec(view, codec: str, *, min_ratio: float | None = None,
                 sample_kb: int | None = None) -> str:
    """One decision per chunk: ``codec`` when both its head and its middle
    sample compress to at most ``GRIT_CODEC_MIN_RATIO``, else ``none``
    (zero blocks still elide per block)."""
    if codec == CODEC_NONE or len(view) == 0:
        return CODEC_NONE
    if min_ratio is None:
        min_ratio = config.CODEC_MIN_RATIO.get_float()
    if sample_kb is None:
        sample_kb = config.CODEC_SAMPLE_KB.get_int()
    sample_n = min(len(view), max(1, sample_kb) * 1024)
    t0 = time.monotonic()
    ok = True
    for start in {0, max(0, (len(view) - sample_n) // 2)}:
        sample = _compress(codec, view[start:start + sample_n])
        if len(sample) / sample_n > min_ratio:
            ok = False
            break
    CODEC_SECONDS.inc(time.monotonic() - t0, dir="compress")
    # Raw-shipped bytes are counted per block, in compress_block.
    return codec if ok else CODEC_NONE


def compress_block(view, codec: str, *, min_ratio: float | None = None,
                   sample_kb: int | None = None, presampled: bool = False,
                   elide_zeros: bool = False):
    """One block through the codec stage: ``(codec_used, payload, raw_n,
    crc_raw)``. ``zero`` (empty payload) for an all-zero block when a codec
    is active or ``elide_zeros``; ``none`` with ``view`` itself as the
    payload when the codec is off, the head sample (skipped when
    ``presampled``) or the whole block does not compress enough.
    ``crc_raw`` is the zlib crc32 of the raw bytes."""
    faults.fault_point("codec.compress", wrap=CodecError)
    raw_n = len(view)
    crc_raw = zlib.crc32(view) & 0xFFFFFFFF
    if raw_n and (codec != CODEC_NONE or elide_zeros) and _all_zero(view):
        CODEC_BYTES.inc(raw_n, dir="compress_in", codec=CODEC_ZERO)
        return CODEC_ZERO, b"", raw_n, crc_raw
    if codec == CODEC_NONE or raw_n == 0:
        if elide_zeros and raw_n:
            # A raw-decided block of a codec stream.
            CODEC_BYTES.inc(raw_n, dir="compress_raw_shipped",
                            codec=CODEC_NONE)
        return CODEC_NONE, view, raw_n, crc_raw
    if min_ratio is None:
        min_ratio = config.CODEC_MIN_RATIO.get_float()
    if sample_kb is None:
        sample_kb = config.CODEC_SAMPLE_KB.get_int()
    t0 = time.monotonic()
    sample_n = min(raw_n, max(1, sample_kb) * 1024)
    if not presampled and sample_n < raw_n:
        sample = _compress(codec, view[:sample_n])
        if len(sample) / sample_n > min_ratio:
            CODEC_SECONDS.inc(time.monotonic() - t0, dir="compress")
            CODEC_BYTES.inc(raw_n, dir="compress_raw_shipped", codec=codec)
            return CODEC_NONE, view, raw_n, crc_raw
    payload = _compress(codec, view)
    CODEC_SECONDS.inc(time.monotonic() - t0, dir="compress")
    if len(payload) / raw_n > min_ratio:
        CODEC_BYTES.inc(raw_n, dir="compress_raw_shipped", codec=codec)
        return CODEC_NONE, view, raw_n, crc_raw
    CODEC_BYTES.inc(raw_n, dir="compress_in", codec=codec)
    CODEC_BYTES.inc(len(payload), dir="compress_out", codec=codec)
    return codec, payload, raw_n, crc_raw


def decompress_block(codec: str, payload, raw_n: int,
                     crc_raw: int | None = None) -> bytes:
    """Inverse of :func:`compress_block`: checks the codec id, the raw
    size and (when given) the CRC of the raw bytes; raises
    :class:`CodecError` on any mismatch."""
    faults.fault_point("codec.decompress", wrap=CodecError)
    if codec == CODEC_NONE:
        raw = payload
    else:
        t0 = time.monotonic()
        try:
            raw = _decompress(codec, payload, raw_n)
        except (zlib.error, ValueError, MemoryError) as exc:
            raise CodecError(f"decompress({codec}) failed: {exc}") from exc
        except Exception as exc:  # zstandard.ZstdError, not importable here
            if type(exc).__name__ != "ZstdError":
                raise
            raise CodecError(f"decompress({codec}) failed: {exc}") from exc
        CODEC_SECONDS.inc(time.monotonic() - t0, dir="decompress")
        CODEC_BYTES.inc(len(payload), dir="decompress_in", codec=codec)
        CODEC_BYTES.inc(len(raw), dir="decompress_out", codec=codec)
    if len(raw) != raw_n:
        raise CodecError(f"decompressed size mismatch: got {len(raw)}, "
                         f"header says {raw_n} ({codec})")
    if crc_raw is not None and (zlib.crc32(raw) & 0xFFFFFFFF) != crc_raw:
        raise CodecError(f"CRC-of-raw mismatch after {codec} decompress "
                         "(corrupt in transit)")
    return raw


# -- bounded worker pool ---------------------------------------------------------

_pool_lock = threading.Lock()
_pool: ThreadPoolExecutor | None = None
_pool_workers = 0
# Jobs a worker has picked up and not finished: with the queue depth,
# the pool's saturation (the resource ledger's "is the codec the
# bottleneck" number).
_active_lock = threading.Lock()
_active_jobs = 0


def workers() -> int:
    """``GRIT_CODEC_WORKERS`` when set (at least 1), else 2 to 8 by the
    host's cores."""
    configured = config.CODEC_WORKERS.get_int()
    if configured != int(config.CODEC_WORKERS.default):
        return max(1, configured)
    return max(2, min(8, os.cpu_count() or 1))


def shared_pool() -> ThreadPoolExecutor:
    """The process-wide codec pool, resized when :func:`workers` changes
    (the old pool drains its queue). Callers bound what they submit."""
    global _pool, _pool_workers
    want = workers()
    with _pool_lock:
        if _pool is None or _pool_workers != want:
            if _pool is not None:
                _pool.shutdown(wait=False)
            _pool = ThreadPoolExecutor(max_workers=want,
                                       thread_name_prefix="grit-codec")
            _pool_workers = want
        return _pool


def queue_depth() -> int | None:
    """Jobs queued, not yet picked up, in the shared pool; None when no
    pool exists (a read never creates one)."""
    with _pool_lock:
        pool = _pool
    if pool is None:
        return None
    try:
        return pool._work_queue.qsize()
    except AttributeError:  # executor internals changed
        return None


def active_jobs() -> int:
    """Jobs submitted through :func:`pool_submit` that a worker is
    running now."""
    with _active_lock:
        return _active_jobs


def pool_saturation() -> float | None:
    """(running + queued jobs) / the pool's workers, or None when no pool
    exists: 0 idle, 1 every worker busy, above 1 a backlog behind them
    (the codec, not the transport, paces the data path)."""
    with _pool_lock:
        pool, nworkers = _pool, _pool_workers
    if pool is None:
        return None
    try:
        queued = pool._work_queue.qsize()
    except AttributeError:  # executor internals changed
        queued = 0
    return (active_jobs() + queued) / max(1, nworkers)


def sample_queue_depth() -> None:
    """The sampler's refresh of ``CODEC_QUEUE_DEPTH`` from the live queue
    (the write at submission goes stale as the workers drain it)."""
    depth = queue_depth()
    if depth is not None:
        CODEC_QUEUE_DEPTH.set(depth)


def pool_submit(fn, *args, **kwargs):
    """Submit ``fn`` to the shared pool, bound to the submitting thread's
    trace context (spans inside the worker join the caller's trace) and
    counted in :func:`active_jobs` while it runs, and sample the pool's
    backlog into ``CODEC_QUEUE_DEPTH``."""
    pool = shared_pool()
    wrapped = trace.wrap_parented(fn)

    def _counted(*a, **k):
        global _active_jobs
        with _active_lock:
            _active_jobs += 1
        try:
            return wrapped(*a, **k)
        finally:
            with _active_lock:
                _active_jobs -= 1

    fut = pool.submit(_counted, *args, **kwargs)
    try:
        CODEC_QUEUE_DEPTH.set(pool._work_queue.qsize())
    except AttributeError:  # executor internals changed: the gauge is optional
        pass
    return fut


# -- container format ------------------------------------------------------------


@dataclass(frozen=True)
class BlockRecord:
    codec: str
    raw_off: int
    raw_n: int
    comp_off: int
    comp_n: int
    crc_raw: int


@dataclass
class ContainerIndex:
    """A parsed ``.gritc`` sidecar: the raw → container offset map."""

    raw_size: int
    comp_size: int
    records: list[BlockRecord]

    def covering(self, offset: int, nbytes: int) -> list[BlockRecord]:
        """Records overlapping raw ``[offset, offset + nbytes)`` in raw
        order; raises :class:`CodecError` when they leave a gap."""
        want_end = offset + nbytes
        out = sorted((r for r in self.records
                      if r.raw_off < want_end and r.raw_off + r.raw_n > offset),
                     key=lambda r: r.raw_off)
        covered = offset
        for r in out:
            if r.raw_off > covered:
                break
            covered = max(covered, r.raw_off + r.raw_n)
        if covered < want_end:
            raise CodecError(f"container does not cover raw bytes "
                             f"[{offset}, {want_end}) (have up to {covered})")
        return out


class SidecarWriter:
    """Streaming writer of a container's ``.gritc`` sidecar: one flushed
    JSON line per block, sealed by a terminal line with the totals (an
    unterminated sidecar is invalid, never silently short)."""

    def __init__(self, container_path: str) -> None:
        self.path = container_path + SIDECAR_SUFFIX
        self._f = open(self.path, "w")
        self._f.write(json.dumps(
            {"format": SIDECAR_FORMAT,
             "file": os.path.basename(container_path)}) + "\n")
        self.records = 0

    def record(self, codec: str, raw_off: int, raw_n: int,
               comp_off: int, comp_n: int, crc_raw: int) -> None:
        self._f.write(json.dumps(
            {"c": codec, "ro": raw_off, "rn": raw_n,
             "co": comp_off, "cn": comp_n, "crc": crc_raw}) + "\n")
        self._f.flush()
        self.records += 1

    def close(self, raw_size: int, comp_size: int) -> None:
        self._f.write(json.dumps(
            {"done": True, "raw_size": raw_size, "comp_size": comp_size,
             "records": self.records}) + "\n")
        self._f.flush()
        self._f.close()

    def abandon(self) -> None:
        try:
            self._f.close()
            os.unlink(self.path)
        except OSError:
            pass


# Terminated sidecars are immutable: parsed indexes are cached on the
# sidecar's (size, mtime) so a restore's per-chunk reads parse it once.
_index_lock = threading.Lock()
_index_cache: dict[str, tuple[tuple[int, int], ContainerIndex]] = {}


def load_container_index(data_path: str) -> ContainerIndex | None:
    """The index of the container at ``data_path`` when a sidecar lies
    beside it, None for a raw data file. An unterminated or malformed
    sidecar raises :class:`CodecError` (a torn transfer, not a raw file)."""
    sidecar = data_path + SIDECAR_SUFFIX
    try:
        st = os.stat(sidecar)
    except OSError:
        return None
    token = (st.st_size, st.st_mtime_ns)
    with _index_lock:
        hit = _index_cache.get(sidecar)
        if hit is not None and hit[0] == token:
            return hit[1]
    records: list[BlockRecord] = []
    raw_size = comp_size = -1
    try:
        with open(sidecar) as f:
            header = json.loads(f.readline())
            if header.get("format") != SIDECAR_FORMAT:
                raise CodecError(f"{sidecar}: unknown sidecar format "
                                 f"{header.get('format')!r}")
            for line in f:
                if not line.strip():
                    continue
                rec = json.loads(line)
                if rec.get("done"):
                    raw_size = int(rec["raw_size"])
                    comp_size = int(rec["comp_size"])
                    break
                records.append(BlockRecord(
                    codec=str(rec["c"]), raw_off=int(rec["ro"]),
                    raw_n=int(rec["rn"]), comp_off=int(rec["co"]),
                    comp_n=int(rec["cn"]), crc_raw=int(rec["crc"])))
    except (OSError, ValueError, KeyError, AttributeError) as exc:
        raise CodecError(f"{sidecar}: malformed codec sidecar: {exc}") from exc
    if raw_size < 0:
        raise CodecError(f"{sidecar}: sidecar has no terminal line — "
                         "container is torn or still being written")
    index = ContainerIndex(raw_size=raw_size, comp_size=comp_size,
                           records=records)
    with _index_lock:
        if len(_index_cache) >= 64:
            _index_cache.clear()
        _index_cache[sidecar] = (token, index)
    return index


def container_raw_size(data_path: str) -> int | None:
    """The raw size the container at ``data_path`` decodes to; None when
    it is not a valid, terminated container."""
    try:
        idx = load_container_index(data_path)
    except CodecError:
        return None
    return idx.raw_size if idx is not None else None


def read_container_range(data_path: str, index: ContainerIndex,
                         offset: int, nbytes: int, pread=None) -> bytes:
    """Raw bytes ``[offset, offset + nbytes)`` of the container, decoding
    only the covering blocks. ``pread(comp_off, comp_n)`` reads container
    bytes (a restore gates it on the stage's waterline); by default a
    plain read of the file."""
    out = bytearray(nbytes)
    f = None
    if pread is None:
        f = open(data_path, "rb")

        def pread(co: int, cn: int) -> bytes:
            f.seek(co)
            return f.read(cn)
    try:
        for rec in index.covering(offset, nbytes):
            payload = pread(rec.comp_off, rec.comp_n)
            if len(payload) != rec.comp_n:
                raise CodecError(f"short container read at {rec.comp_off} "
                                 f"({len(payload)}/{rec.comp_n})")
            raw = decompress_block(rec.codec, payload, rec.raw_n, rec.crc_raw)
            lo = max(offset, rec.raw_off)
            hi = min(offset + nbytes, rec.raw_off + rec.raw_n)
            out[lo - offset:hi - offset] = \
                memoryview(raw)[lo - rec.raw_off:hi - rec.raw_off]
    finally:
        if f is not None:
            f.close()
    return bytes(out)
