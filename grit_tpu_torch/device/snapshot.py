"""Device-state snapshot in the JAX package's on-disk format.

Counterpart of ``grit_tpu/device/snapshot.py``: the same self-describing
directory, so a snapshot written by either package restores through the
other::

    <dir>.work/               everything is written here first
        MANIFEST.json         format tag, meta, per-array dtype/shape/chunks
        data-h<k>.bin         process k's arrays' bytes, concatenated
        index-h<k>.json       process k's array records
        COMMIT                sentinel written last
    → renamed to <dir>        the atomic commit

Multi-process (``write_snapshot(barrier=, process_index=,
process_count=)``, the gang's coordinated cut): each process writes its
own data and index file and, with a mirror, its own ``mirror-ok-h<k>``
marker, then meets the others at ``barrier()``; process 0 merges the
indexes by array name in process order, writes the manifest (the real
``process_count``) and commits, sealing the mirror only if every
process's marker is there; a second ``barrier()`` follows. The defaults
(process 0 of 1, no barrier) are the single-process dump.

Arrays are named by their ``jax.tree_util.keystr`` path
(:mod:`grit_tpu_torch.tree`), dtypes by numpy's names with ``bfloat16``
for bf16. A dense leaf is one chunk with ``{"type": "replicated"}``
sharding. A sharded state (``write_snapshot(shardings=)``, the
Trainer's mesh) records each leaf's ``{"type": "named", "mesh_shape",
"mesh_axes", "spec"}`` descriptor, as the JAX package writes it, and one
chunk per distinct shard under its global ``index``, written by the one
rank at coordinate 0 along every mesh dim that does not shard the leaf;
process 0's merge joins one name's shards into one record. A restore
takes each leaf's slice for its target, a whole array or this rank's
shard of a DTensor ``like`` leaf, from the chunk with that index when
there is one, else cut from every chunk that overlaps it: another mesh,
or a dense Trainer, reads a snapshot written on any mesh. Without
``shardings=`` a DTensor leaf's descriptor comes from the leaf itself
(:func:`~grit_tpu_torch.parallel.sharding.sharding_of`). A pipe mesh's
stage leaves (each rank holds its stage of a stacked array) record the
stacked array and each rank's stage as its chunk.

Per-host legs (``write_snapshot(leg=True)``, a sharded job cut by the
gang): each rank commits its own tree of every shard it holds into
``data-h<k>.bin``, so the leg restores alone onto the same mesh; a
restore onto another layout reads :func:`merge_legs`, a manifest over
the legs of one cut whose chunks reference the legs' bytes; it refuses
trees that are not legs of one cut, or legs whose copies of a shard
differ.

Chunk checksums are ``zlib.crc32`` (``"algo": "crc32"``). A
JAX-written snapshot whose chunks carry ``crc32c`` (the JAX package's
native IO plane) is verified with the port's crc32c library
(:mod:`grit_tpu_torch.checksum`); where that cannot be built, its chunks
raise :class:`SnapshotIntegrityError` unless the caller passes
``verify=False``.

Delta dumps (``write_snapshot(base=)``, pre-copy live migration): a chunk
byte-identical to the base's is recorded as a reference (``"ref_dir"``,
relative to this snapshot, chains collapsed) instead of being written
again. Identity is a sha256 match against a hashed base (``hashes=True``
on the base's dump), else a crc32 match confirmed by a byte compare
against the base's file — a crc mismatch alone proves a change. The
manifest then carries ``"base"`` and the ``"dirty"`` accounting the
agent's pre-copy governors read.

Mirror (``mirror=``): a writer thread tees every physically written chunk
into a second committed snapshot (the agent's upload destination), whose
COMMIT records each file's identity so the agent's upload pass skips it
(``grit_tpu/agent/checkpoint.py:_mirrored_skip``). With
``GRIT_SNAPSHOT_CODEC`` set, the tee's codec stage (:mod:`grit_tpu_torch.codec`)
compresses blocks on a worker pool and the mirror's data file is a
container with a ``.gritc`` sidecar, which every restore path decodes and
verifies. Wire (``wire=``): the same tee streams the bytes, raw or as codec
records, to a migration destination while the dump drains
(:mod:`grit_tpu_torch.wire`). A failed tee never fails the dump.

Restore gates every read on the streamed-staging journal when one governs
the directory (the agent stages metadata first, data while the restore
runs), reads and checksums arrays on reader threads ahead of an in-order
place on the caller's thread, and records that pipeline's legs
(:func:`last_restore_pipeline`).

Kernel-library carry (``GRIT_TPU_COMPILE_CACHE`` set): after its commit a
dump copies the kernel libraries of that directory into
``<dir>/compile-cache/``, and a restore seeds the directory from there
before anything else and records the count (``seeded`` in
:func:`last_restore_pipeline`); see :mod:`grit_tpu_torch.ops.build`. The
carry is not part of the commit: a failure to carry only logs.

The card's data path: a CUDA tensor leaves the device through a ring of
``_RING_SLOTS`` pinned buffers of ``_PIECE_BYTES``, filled by
asynchronous copies on a side stream up to a ring ahead of the checksum
(on a hasher thread) and the file write. A restore's readers read arrays
bound for the card straight into pinned blocks of ``_PIECE_BYTES``
(pinned on first need, at most the read-ahead window × the largest
array, reserved in array order), and the caller copies them to the
device asynchronously. Host memory stays bounded by the ring and the
blocks. A CPU target needs neither.

Validated speculation (the quiesce-free dump): :func:`start_speculative_dump`
writes a cloned generation to the ``-spec`` sibling of the final
directory on a thread while the loop keeps stepping;
:func:`validated_clean_names` then compares the parked state with the
clone on the device, byte for byte, and the parked dump
(``write_snapshot(clean_names=)``) references the clean leaves' chunks in
the speculative pass without reading them from the device.

Post-copy restore (:func:`restore_snapshot_postcopy`): the hot set (small
arrays) is placed before the call returns, the cold bulk by a background
tail in the order its bytes are staged; :meth:`PostcopyRestore.wait`
hands over the whole tree. On a mesh each rank's hot set and tail place
its own shards.

Observability and faults, at the reference's seams: the fault points
``device.snapshot.dump`` (a parked dump; the speculative pass has
``snap.speculate``, the agentlet's), ``device.snapshot.mirror`` (the tee
abandons itself, never the dump), ``device.snapshot.place`` (a restore's
start) and ``restore.postcopy_fault`` (a post-copy tail's first touch of
an array; the handle falls back to the blocking restore); the flight
events ``dump.start``/``dump.chunk``/``dump.end`` (not for the speculative
pass, which brackets ``snap.speculative.start``), ``codec.wait``,
``restart.end``, ``place.start``/``place.waterline``/``place.end`` and
``postcopy.tail.start``/``end``, on the log that governs the directory
(:func:`~grit_tpu_torch.obs.flight.emit_near`); the spans
``snapshot.write`` (or ``snapshot.write.speculative``),
``snapshot.mirror``, ``snapshot.restore`` and ``restore_pipeline``, with
the trace context carried into the mirror's writer, the codec pool, the
restore's readers and the post-copy tail; the ``SNAPSHOT_*``,
``SNAP_SPECULATIVE_SECONDS``, ``RESTORE_*``, ``PLACE_CHUNK_SECONDS``,
``CODEC_*`` and ``CODEC_WAIT_SECONDS`` metrics.

Not in this package: the reference's native drain and native container
read (``libgritio``), and so the ``io.drain``/``io.place`` fault points and
events of that plane, and its progress tracker.
"""

from __future__ import annotations

import bisect
import hashlib
import json
import logging
import os
import queue
import shutil
import threading
import time
import zlib
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from typing import Any, Callable, Iterator

import numpy as np
import torch

from grit_tpu_torch import checksum
from grit_tpu_torch import codec as transport_codec
from grit_tpu_torch import faults
from grit_tpu_torch.api import config
from grit_tpu_torch.device.placement import resolve_device
from grit_tpu_torch.ops import build
from grit_tpu_torch.metadata import (
    SNAPSHOT_FORMAT,
    STAGE_JOURNAL_FILE,
    atomic_write_json,
    atomic_write_text,
    chunk_stream_signature,
    crc32_file,
)
from grit_tpu_torch.obs import flight, trace
from grit_tpu_torch.obs.metrics import (
    CODEC_RATIO,
    CODEC_WAIT_SECONDS,
    PLACE_CHUNK_SECONDS,
    RESTORE_OVERLAP_FRACTION,
    RESTORE_PIPELINE_SECONDS,
    SNAP_SPECULATIVE_SECONDS,
    SNAPSHOT_BYTES,
    SNAPSHOT_SECONDS,
)
from grit_tpu_torch.parallel.sharding import (
    NamedSharding,
    dtensor_index,
    is_dtensor,
    like_dtensor,
    local_shard,
    sharding_of,
    spec_from_descriptor,
)
from grit_tpu_torch.tree import flatten_with_names, map_with_names
from grit_tpu_torch.wire import Countdown

log = logging.getLogger(__name__)

FORMAT = SNAPSHOT_FORMAT
MANIFEST_FILE = "MANIFEST.json"
COMMIT_FILE = "COMMIT"
WORK_SUFFIX = ".work"


def data_file(k: int) -> str:
    """Process ``k``'s data file."""
    return f"data-h{k:04d}.bin"


def index_file(k: int) -> str:
    """Process ``k``'s index file."""
    return f"index-h{k:04d}.json"


def mirror_marker(k: int) -> str:
    """Process ``k``'s mirror marker."""
    return f"mirror-ok-h{k:04d}"


# Process 0's: the whole snapshot of a single-process dump.
DATA_FILE = data_file(0)
INDEX_FILE = index_file(0)
MIRROR_MARKER = mirror_marker(0)
# The speculative pass commits beside the final dump directory, under this
# suffix (a wire contract: the agent ships the sibling with the dump).
SPEC_SUFFIX = "-spec"

# The card's staging ring: pieces of at most _PIECE_BYTES (zlib.crc32,
# sha256 and file IO release the GIL only on large buffers), _RING_SLOTS
# of them in flight. The piece is also the delta dump's base-compare
# window (the reference compares 64 MiB at a time).
_PIECE_BYTES = 64 << 20
_RING_SLOTS = 4
# Arrays the restore readers work on ahead of the in-order place.
_RESTORE_WINDOW = 4

# torch dtype <-> manifest dtype string (numpy's names; bf16 as ml_dtypes
# spells it, which is what the JAX writer records).
_DTYPE_NAMES = {
    torch.float32: "float32", torch.float64: "float64",
    torch.float16: "float16", torch.bfloat16: "bfloat16",
    torch.int8: "int8", torch.int16: "int16", torch.int32: "int32",
    torch.int64: "int64", torch.uint8: "uint8", torch.uint32: "uint32",
    torch.bool: "bool",
}
_NAME_DTYPES = {v: k for k, v in _DTYPE_NAMES.items()}
_DTYPE_BYTES = {v: torch.empty((), dtype=k).element_size()
                for k, v in _DTYPE_NAMES.items()}


class SnapshotIntegrityError(RuntimeError):
    """A snapshot's bytes cannot be trusted (checksum, size, coverage, a
    torn codec sidecar or a corrupt block, a failed or stalled stage, a
    missing base), or its crc32c chunks cannot be verified here."""


@dataclass
class SnapshotManifest:
    """Parsed MANIFEST.json."""

    format: str
    process_count: int
    meta: dict
    arrays: list[dict]

    @classmethod
    def load(cls, directory: str) -> "SnapshotManifest":
        with open(os.path.join(directory, MANIFEST_FILE)) as f:
            raw = json.load(f)
        if raw.get("format") != FORMAT:
            raise ValueError(f"unknown snapshot format: {raw.get('format')!r}")
        return cls(format=raw["format"], process_count=raw["process_count"],
                   meta=raw.get("meta", {}), arrays=raw["arrays"])


def snapshot_exists(directory: str) -> bool:
    """True iff ``directory`` holds a committed snapshot (COMMIT sentinel)."""
    return os.path.isfile(os.path.join(directory, COMMIT_FILE))


def snapshot_nbytes(directory: str) -> int:
    """Total payload bytes of a committed snapshot (sum of chunk sizes)."""
    manifest = SnapshotManifest.load(directory)
    return sum(c["nbytes"] for rec in manifest.arrays for c in rec["chunks"])


def snapshot_delta_nbytes(directory: str) -> int:
    """Bytes physically stored in ``directory`` itself — chunks referenced
    from a base are left out. Equals :func:`snapshot_nbytes` for a full
    dump; the dump and transfer cost of a delta."""
    manifest = SnapshotManifest.load(directory)
    return sum(c["nbytes"] for rec in manifest.arrays for c in rec["chunks"]
               if not c.get("ref_dir"))


# Process-level records of the last dump and the last restore (their legs
# in seconds), read by the workload's RESTORE_PIPELINE line and the
# agentlet's dump response.
_RECORD_LOCK = threading.Lock()
_LAST_WRITE: dict = {}
_LAST_RESTORE: dict = {}


def last_write() -> dict:
    """Legs of this process's last :func:`write_snapshot`."""
    with _RECORD_LOCK:
        return dict(_LAST_WRITE)


def last_restore_pipeline() -> dict:
    """Legs of this process's last :func:`restore_snapshot`: ``stage_wait``
    (readers blocked on the stage journal), ``pin`` (readers pinning
    staging blocks), ``read`` (disk and checksum, summed over readers,
    waits and pinning left out), ``place`` (host to device), ``wall``,
    ``overlap_fraction = 1 - wall / (stage_wait + pin + read + place)``,
    and ``seeded``, the kernel libraries it seeded from the snapshot."""
    with _RECORD_LOCK:
        return dict(_LAST_RESTORE)


def _as_tensor(leaf) -> torch.Tensor:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach()
    return torch.as_tensor(np.asarray(leaf))


def _byte_view(t: torch.Tensor) -> torch.Tensor:
    """``t``'s bytes as a flat uint8 tensor on its device (a copy only
    when ``t`` is not contiguous)."""
    return t.detach().contiguous().reshape(-1).view(torch.uint8)


def _spans(n: int) -> list[tuple[int, int]]:
    return [(o, min(_PIECE_BYTES, n - o)) for o in range(0, n, _PIECE_BYTES)]


def _pinned(nbytes: int) -> torch.Tensor:
    """Page-locked host bytes, the card's staging memory."""
    return torch.empty(nbytes, dtype=torch.uint8, pin_memory=True)


class _DeviceToHost:
    """Tensors' bytes on the host, piece by piece in order: the dump's side
    of the data path. A CPU tensor's pieces are views of its own memory. A
    CUDA tensor's are views of a ring of pinned buffers: each piece's copy
    is queued on a side stream, up to the ring's size ahead of the reader,
    with an event the reader waits on before it sees the bytes; a slot is
    refilled only once the reader has moved past the piece it held, and a
    new tensor's copies start only after every copy of the last one has
    landed (an abandoned pass cannot overwrite a live slot).

    The side stream first waits for the caller's current stream, which
    wrote the tensors. ``settled`` tensors (a drained clone,
    :func:`~grit_tpu_torch.device.quiesce.clone_generation`) are complete
    on every stream already: their copies wait on nothing, so a writer
    thread does not queue behind the steps the loop has put on the shared
    default stream since."""

    def __init__(self, settled: bool = False) -> None:
        self._settled = settled
        self._ring: torch.Tensor | None = None
        self._host: np.ndarray | None = None
        self._streams: dict[torch.device, torch.cuda.Stream] = {}
        self._events: list = [None] * _RING_SLOTS
        self.wait_s = 0.0  # reader time blocked on copies

    def pieces(self, t: torch.Tensor) -> Iterator[np.ndarray]:
        flat = _byte_view(t)
        spans = _spans(flat.numel())
        if not flat.is_cuda:
            host = flat.numpy()
            for o, m in spans:
                yield host[o:o + m]
            return
        if self._ring is None:
            self._ring = _pinned(_RING_SLOTS * _PIECE_BYTES)
            self._host = self._ring.numpy()
        for ev in self._events:
            if ev is not None:
                ev.synchronize()
        stream = self._streams.get(flat.device)
        if stream is None:
            stream = self._streams[flat.device] = torch.cuda.Stream(flat.device)
        # The side stream reads what the caller's stream wrote (a settled
        # tensor's bytes are complete, unless the byte view had to copy
        # it), and the allocator must not reuse the memory it reads, the
        # clone's included, before the side stream is done with it.
        if not (self._settled and t.is_contiguous()):
            stream.wait_stream(torch.cuda.current_stream(flat.device))
        flat.record_stream(stream)

        def issue(i: int) -> None:
            o, m = spans[i]
            k = i % _RING_SLOTS
            with torch.cuda.stream(stream):
                self._ring[k * _PIECE_BYTES:k * _PIECE_BYTES + m].copy_(
                    flat[o:o + m], non_blocking=True)
                ev = torch.cuda.Event()
                ev.record(stream)
            self._events[k] = ev

        for i in range(min(_RING_SLOTS, len(spans))):
            issue(i)
        for i, (_, m) in enumerate(spans):
            k = i % _RING_SLOTS
            t0 = time.perf_counter()
            self._events[k].synchronize()
            self.wait_s += time.perf_counter() - t0
            yield self._host[k * _PIECE_BYTES:k * _PIECE_BYTES + m]
            if i + _RING_SLOTS < len(spans):
                issue(i + _RING_SLOTS)


# -- delta dumps -----------------------------------------------------------------


def _load_base_chunks(directory: str, base: str, own_file: str | None = None
                      ) -> tuple[dict, str | None, str | None]:
    """Index a committed base snapshot for a delta write:
    ``({(name, index, nbytes, dtype): chunk}, relpath, abspath)``, the
    relpath from the *final* target directory to the base (what reused
    chunks record). ``own_file``: only chunks stored in that data file
    (a process of a multi-process dump matches its own chunks). A missing
    or uncommitted base degrades to a full dump (an empty index): pre-copy
    is an optimization."""
    target = os.path.abspath(directory)
    base_abs = os.path.abspath(base)
    if base_abs == target:
        raise ValueError("delta snapshot cannot use itself as base")
    if not snapshot_exists(base_abs):
        return {}, None, None
    index: dict = {}
    for rec in SnapshotManifest.load(base_abs).arrays:
        for c in rec["chunks"]:
            if own_file is not None and c["file"] != own_file:
                continue
            index[(rec["name"], tuple(map(tuple, c["index"])), c["nbytes"],
                   rec["dtype"])] = c
    return index, os.path.relpath(base_abs, target), base_abs


class _DumpLegs:
    """Seconds the dump spends in each stage of its byte loop (the hash
    legs run on the hasher thread, the rest on the dump's)."""

    def __init__(self) -> None:
        self.s = {"crc": 0.0, "sha256": 0.0, "write": 0.0, "compare": 0.0,
                  "tee": 0.0}
        self._lock = threading.Lock()

    def timed(self, leg: str, fn, *args, **kwargs):
        t0 = time.perf_counter()
        try:
            return fn(*args, **kwargs)
        finally:
            with self._lock:
                self.s[leg] += time.perf_counter() - t0


class _Digest:
    """A running crc32 and, optionally, sha256 of a byte stream, fed one
    piece at a time on the hasher thread (both release the GIL on large
    buffers) while the dump's thread writes or compares the same piece."""

    def __init__(self, hasher: ThreadPoolExecutor, legs: _DumpLegs, *,
                 crc: bool, sha256: bool) -> None:
        self._hasher, self._legs = hasher, legs
        self.crc = 0 if crc else None
        self._sha = hashlib.sha256() if sha256 else None

    def feed(self, piece: np.ndarray):
        """Start hashing ``piece``; the caller waits on the returned
        future before the piece's buffer is reused."""
        return self._hasher.submit(self._update, piece)

    def _update(self, piece: np.ndarray) -> None:
        if self.crc is not None:
            self.crc = self._legs.timed("crc", zlib.crc32, piece, self.crc)
        if self._sha is not None:
            self._legs.timed("sha256", self._sha.update, piece)

    def sha256(self) -> str | None:
        return None if self._sha is None else self._sha.hexdigest()


def _match_base_chunk(base_abs: str, base_rel: str, bc: dict, index: list,
                      pieces: Callable[[], Iterator[np.ndarray]],
                      hasher: ThreadPoolExecutor,
                      legs: _DumpLegs) -> tuple[dict | None, dict]:
    """The reference chunk for this array if its bytes equal the base
    chunk ``bc``'s, else None, plus what the passes learned of the bytes
    (``crc``, ``sha256``) for the write that follows a miss.

    A hashed base compares sha256 (no read of the base; the crc32 is
    computed beside it for the write). Otherwise a mismatch of the base
    chunk's checksum (crc32, or crc32c from the JAX package's native
    plane) proves a change; a match is only a hint, confirmed by a byte
    compare against the base file, one piece at a time. A base chunk of
    another algo goes straight to the byte compare. An OSError on the base
    means a fresh write."""
    known: dict = {}
    if "sha256" in bc:
        digest = _Digest(hasher, legs, crc=False, sha256=True)
        crc = 0
        for piece in pieces():
            fut = digest.feed(piece)
            crc = legs.timed("crc", zlib.crc32, piece, crc)
            fut.result()
        known.update(crc=crc, sha256=digest.sha256())
        same = known["sha256"] == bc["sha256"]
    else:
        algo = bc.get("algo", "crc32")
        crc_fn = {"crc32": zlib.crc32, "crc32c": checksum.crc32c}.get(algo)
        if crc_fn is not None:
            crc = 0
            for piece in pieces():
                crc = legs.timed("crc", crc_fn, piece, crc)
            if algo == "crc32":  # the write's own checksum
                known["crc"] = crc
            if crc != bc.get("crc", bc.get("crc32")):
                return None, known
        d = base_abs
        if bc.get("ref_dir"):  # the base is itself a delta: follow the chain
            d = os.path.normpath(os.path.join(base_abs, bc["ref_dir"]))
        same = legs.timed("compare", _same_bytes, os.path.join(d, bc["file"]),
                          bc["offset"], bc["nbytes"], pieces())
    if not same:
        return None, known
    return _ref_chunk(bc, index, base_rel), known


def _ref_chunk(bc: dict, index: list, base_rel: str) -> dict:
    """The chunk record that references base chunk ``bc``."""
    chunk = {
        "file": bc["file"], "offset": bc["offset"], "nbytes": bc["nbytes"],
        "index": index, "crc": bc.get("crc", bc.get("crc32")),
        "algo": bc.get("algo", "crc32"),
        # Relative to THIS snapshot; a base that is itself a delta points
        # further back, and the chain collapses to where the bytes live.
        "ref_dir": os.path.normpath(os.path.join(base_rel,
                                                 bc.get("ref_dir", "."))),
    }
    if "sha256" in bc:
        chunk["sha256"] = bc["sha256"]
    return chunk


# Sub-window of the byte compare: its temporaries stay small enough for
# the allocator to reuse, where a piece-sized one is mapped fresh each time.
_COMPARE_WINDOW = 1 << 20


def _same_bytes(path: str, offset: int, nbytes: int,
                pieces: Iterator[np.ndarray]) -> bool:
    """Whether ``pieces`` equal ``nbytes`` of ``path`` at ``offset``, read
    into one reused buffer a piece at a time."""
    buf = None
    seen = 0
    try:
        with open(path, "rb") as f:
            f.seek(offset)
            for piece in pieces:
                if buf is None or buf.nbytes < piece.nbytes:
                    buf = np.empty(piece.nbytes, np.uint8)
                raw = buf[:piece.nbytes]
                if f.readinto(memoryview(raw)) != piece.nbytes:
                    return False
                for o in range(0, piece.nbytes, _COMPARE_WINDOW):
                    if not np.array_equal(piece[o:o + _COMPARE_WINDOW],
                                          raw[o:o + _COMPARE_WINDOW]):
                        return False
                seen += piece.nbytes
    except OSError:
        return False
    return seen == nbytes


# -- mirror tee ------------------------------------------------------------------


class _ByteBoundedQueue:
    """FIFO bounded by in-flight *bytes*: producers block once ``max_bytes``
    is queued; one item is always admitted, so a piece larger than the
    bound cannot deadlock the dump. The ``None`` sentinel is free. Raises
    ``queue.Full`` / ``queue.Empty`` on timeout, as ``queue.Queue`` does."""

    def __init__(self, max_bytes: int) -> None:
        self._max = max(1, max_bytes)
        self._items: deque = deque()
        self._bytes = 0
        self._cond = threading.Condition()

    def put(self, item, nbytes: int = 0, timeout: float = 1.0) -> None:
        deadline = time.monotonic() + timeout
        with self._cond:
            while self._items and self._bytes + nbytes > self._max:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    raise queue.Full
                self._cond.wait(remaining)
            self._items.append((item, nbytes))
            self._bytes += nbytes
            self._cond.notify_all()

    def get(self, timeout: float = 1.0):
        deadline = time.monotonic() + timeout
        with self._cond:
            while not self._items:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    raise queue.Empty
                self._cond.wait(remaining)
            item, nbytes = self._items.popleft()
            self._bytes -= nbytes
            self._cond.notify_all()
            return item


class _MirrorWriter:
    """Background tee of the dump's physically written bytes, in the
    primary's write order, into ``path`` (the mirror's data file; None: no
    file) and onto ``wire`` (a :class:`~grit_tpu_torch.wire.WireDumpSink`;
    None: no wire), behind a queue bounded by
    ``GRIT_MIRROR_MAX_INFLIGHT_MB``.

    A piece whose memory the dump reuses (a pinned ring slot) is queued as
    a copy in a spare buffer that comes back once the file and the wire
    are through with it, so copies never fault in fresh pages.

    With ``GRIT_SNAPSHOT_CODEC`` set, each piece is decided once
    (:func:`~grit_tpu_torch.codec.decide_codec`), split into blocks and
    compressed on the shared pool, and the writer drains the blocks in
    raw-offset order to both sinks: the file becomes a container with a
    ``.gritc`` sidecar, the wire carries codec records. With the codec off
    both carry the raw bytes.

    Any failure only disables the tee: the agent's upload pass ships the
    bytes, and the wire's ``ok`` turns false (a dead tee leaves a hole in
    the stream). It never fails or hangs the dump."""

    def __init__(self, path: str | None, wire=None,
                 flight_dir: str | None = None) -> None:
        self._q = _ByteBoundedQueue(config.MIRROR_MAX_INFLIGHT_MB.get_int() << 20)
        self._ok = True
        self._err: str | None = None
        self._path = path
        self._wire = wire
        self.codec = transport_codec.resolve_codec()
        self._pool = (transport_codec.shared_pool()
                      if self.codec != transport_codec.CODEC_NONE else None)
        self.sidecar_path: str | None = None
        self._raw_off = 0       # raw bytes submitted by the dump
        self.raw_written = 0    # raw bytes drained by the writer
        self.comp_written = 0   # bytes of the file (raw when the codec is off)
        self.codec_wait_s = 0.0  # the writer blocked on the pool
        self._flight_dir = flight_dir  # where codec.wait lands (None: nowhere)
        # The dump thread's trace context: the writer thread's spans, and
        # the pool jobs it submits, join the dump's trace.
        self._trace_ctx = trace.current_context()
        self._started_ns = time.time_ns()
        self._spare: queue.SimpleQueue = queue.SimpleQueue()
        self._thread = threading.Thread(target=self._run,
                                        name="grit-snapshot-mirror", daemon=True)
        self._thread.start()

    def _run(self) -> None:
        with trace.parented(self._trace_ctx):
            self._run_parented()

    def _run_parented(self) -> None:
        sidecar = None
        try:
            f = open(self._path, "wb") if self._path is not None else None
            try:
                if f is not None and self._pool is not None:
                    sidecar = transport_codec.SidecarWriter(self._path)
                    self.sidecar_path = sidecar.path
                idle = 0
                while True:
                    try:
                        # Long gaps are legitimate (a delta dump feeds
                        # nothing for reused chunks): silence only warns.
                        item = self._q.get(timeout=1.0)
                    except queue.Empty:
                        idle += 1
                        if idle % 60 == 0:
                            log.warning("snapshot mirror %s: no bytes and no "
                                        "terminator for %ds (still waiting)",
                                        self._path, idle)
                        continue
                    idle = 0
                    if item is None:
                        if sidecar is not None:
                            sidecar.close(self.raw_written, self.comp_written)
                            sidecar = None
                        return
                    self._drain(f, sidecar, item)
            finally:
                if f is not None:
                    f.close()
        except Exception as exc:  # noqa: BLE001 — the tee never fails the dump
            self._ok = False
            self._err = f"{type(exc).__name__}: {exc}"
            if sidecar is not None:
                sidecar.abandon()  # an unterminated sidecar is invalid
            if self._wire is not None:
                # Bytes died between the dump and the wire: a hole.
                self._wire.mark_failed(f"mirror tee died: {self._err}")
            # Drain so the producer never blocks on a dead tee; bounded,
            # in case the producer went away without its terminator.
            idle = 0
            while idle < 60:
                try:
                    if self._q.get(timeout=1.0) is None:
                        break
                    idle = 0
                except queue.Empty:
                    idle += 1

    def _drain(self, f, sidecar, item) -> None:
        """One queued item to the file and the wire: ``("raw", buf, lease)``
        or ``("rec", future, raw_off, lease)`` (one codec block). ``lease``
        (or None) hands the item's spare buffer back once both are
        through with it."""
        if item[0] == "raw":
            _, buf, lease = item
            used, payload, raw_n, crc_raw = None, buf, buf.nbytes, None
        else:
            _, fut, raw_off, lease = item
            t0 = time.perf_counter()
            # Bounded: a wedged pool worker must surface as a dead tee
            # within finish()'s join budget.
            used, payload, raw_n, crc_raw = fut.result(timeout=600.0)
            wait = time.perf_counter() - t0
            self.codec_wait_s += wait
            CODEC_WAIT_SECONDS.observe(wait)
        if f is not None:
            f.write(payload)
            if sidecar is not None:
                sidecar.record(used, raw_off, raw_n, self.comp_written,
                               len(payload), crc_raw)
        self.raw_written += raw_n
        self.comp_written += len(payload)
        done = lease.tick if lease is not None else None
        if self._wire is None:
            if done is not None:
                done()
        elif used is None:
            self._wire.put(payload, done=done)
        else:
            self._wire.put_record(used, payload, raw_off, raw_n, crc_raw,
                                  done=done)

    def put(self, buf: np.ndarray, *, borrowed: bool = False) -> None:
        """Queue ``buf``, which the caller does not write again; a
        ``borrowed`` one, whose memory the caller reuses, as a copy. An
        armed ``device.snapshot.mirror`` abandons the tee, as a dead tee
        does, and never fails the dump."""
        try:
            faults.fault_point("device.snapshot.mirror")
        except faults.FaultInjected as exc:
            self._ok = False
            self._err = self._err or str(exc)
            return
        if not self._ok:
            return
        view = buf.reshape(-1).view(np.uint8)
        spare = None
        if borrowed:
            try:
                spare = self._spare.get_nowait()
            except queue.Empty:
                pass
            if spare is None or spare.nbytes < view.nbytes:
                spare = np.empty(max(view.nbytes, _PIECE_BYTES), np.uint8)
            np.copyto(spare[:view.nbytes], view)
            view = spare[:view.nbytes]
        if self._pool is None:
            self._enqueue(("raw", view, self._lease(1, spare)), view.nbytes)
            return
        try:
            piece_codec = transport_codec.decide_codec(view, self.codec)
        except Exception as exc:  # noqa: BLE001 — the tee never fails the dump
            self._ok = False
            self._err = self._err or f"codec decision failed: {exc}"
            if self._wire is not None:
                self._wire.mark_failed(self._err)
            return
        # Blocks compress in parallel on the pool; the writer drains them
        # in submission (raw-offset) order. Raw-decided pieces still
        # zero-elide and checksum per block.
        spans = [(o, min(transport_codec.BLOCK_BYTES, view.nbytes - o))
                 for o in range(0, view.nbytes, transport_codec.BLOCK_BYTES)]
        lease = self._lease(len(spans), spare)
        for o, n in spans:
            fut = transport_codec.pool_submit(
                transport_codec.compress_block, view[o:o + n], piece_codec,
                presampled=True, elide_zeros=True)
            self._enqueue(("rec", fut, self._raw_off, lease), n)
            self._raw_off += n

    def _lease(self, parts: int, spare: np.ndarray | None) -> Countdown | None:
        """The lease of ``spare`` to ``parts`` queued items: it returns to
        the free list once each has ticked (None: nothing lent)."""
        if spare is None:
            return None
        return Countdown(parts, lambda: self._spare.put(spare))

    def _enqueue(self, item, nbytes: int) -> None:
        # Fail fast on a dead writer: a put re-checking liveness can never
        # block the dump forever.
        while self._ok:
            if not self._thread.is_alive():
                self._ok = False
                self._err = self._err or "mirror thread died"
                return
            try:
                self._q.put(item, nbytes, timeout=1.0)
                return
            except queue.Full:
                continue

    def finish(self, dump_ok: bool = True) -> bool:
        """Terminate and join, then end the wire's stream (its terminator
        only after a whole, healthy dump); False when the tee is unusable."""
        while self._thread.is_alive():
            try:
                self._q.put(None, 0, timeout=1.0)
                break
            except queue.Full:
                continue
        self._thread.join(timeout=120.0)
        if self._thread.is_alive():
            self._ok = False
            self._err = self._err or "mirror writer wedged at finish"
        if self._wire is not None:
            self._wire.finish(dump_ok and self._ok)
        if self._pool is not None and self._ok and self.raw_written:
            self._codec_accounting()
        if not self._ok:
            log.warning("snapshot mirror %s failed (%s); the upload pass "
                        "ships the bytes instead", self._path, self._err)
        return self._ok and dump_ok

    def _codec_accounting(self) -> None:
        """A healthy codec tee's ratio, its ``codec.wait`` event (the
        writer's seconds blocked on the pool) and its span."""
        CODEC_RATIO.set(self.comp_written / self.raw_written)
        if self._flight_dir is not None:
            flight.emit_near(self._flight_dir, "codec.wait",
                             wait_s=round(self.codec_wait_s, 4),
                             raw_bytes=self.raw_written,
                             comp_bytes=self.comp_written)
        trace.record_span("snapshot.mirror", self._started_ns,
                          parent=self._trace_ctx, raw_bytes=self.raw_written,
                          comp_bytes=self.comp_written,
                          codec_wait=round(self.codec_wait_s, 4))


def _open_mirror(mirror: str | None, wire=None, pidx: int = 0,
                 shared: bool = False, flight_dir: str | None = None
                 ) -> tuple[str | None, _MirrorWriter | None]:
    """The mirror's work dir and the dump's tee into process ``pidx``'s
    data file there and onto ``wire`` (a wire-only tee without a mirror,
    or when the mirror's work dir cannot be made: the two have separate
    failure domains), or ``(None, None)`` with neither. ``shared``: other
    processes write into the same work dir, so it is not emptied first."""
    work = None
    if mirror is not None:
        work = mirror + WORK_SUFFIX
        try:
            if not shared:
                shutil.rmtree(work, ignore_errors=True)
            os.makedirs(work, exist_ok=shared)
        except OSError as exc:
            log.warning("snapshot mirror %s abandoned: %s", mirror, exc)
            work = None
    if work is None and wire is None:
        return None, None
    path = os.path.join(work, data_file(pidx)) if work is not None else None
    return work, _MirrorWriter(path, wire=wire, flight_dir=flight_dir)


def _mark_mirror(mirror_work: str, work: str,
                 written_pairs: list[tuple[int, int]],
                 sidecar_path: str | None, pidx: int = 0) -> None:
    """Copy the index into the mirror and drop its ``mirror-ok`` marker:
    the RAW size and chunk-stream signature of the data file (a container
    too: the upload-skip pass compares the source's raw bytes, and a
    restore re-verifies them after decode), size and crc32 of the index
    and of the codec sidecar, which travels with its container. A missing
    marker abandons the mirror at commit. ``pidx``: the process whose
    files these are."""
    index = os.path.join(work, index_file(pidx))
    try:
        shutil.copyfile(index, os.path.join(mirror_work, index_file(pidx)))
        files = {
            data_file(pidx): {"size": sum(n for _, n in written_pairs),
                              "sig": chunk_stream_signature(written_pairs)},
            index_file(pidx): {"size": os.path.getsize(index),
                               "crc": crc32_file(index)},
        }
        if sidecar_path is not None:
            files[os.path.basename(sidecar_path)] = {
                "size": os.path.getsize(sidecar_path),
                "crc": crc32_file(sidecar_path)}
        atomic_write_json(os.path.join(mirror_work, mirror_marker(pidx)),
                          {"files": files})
    except OSError as exc:
        log.warning("snapshot mirror %s: marker not written (%s)",
                    mirror_work, exc)


def _commit_mirror(mirror: str, committed: str, procs=(0,)) -> bool:
    """Seal the mirror: require the marker of every process of ``procs``
    (the process indices whose files it holds), copy the committed manifest, write a COMMIT whose second
    line is ``{"files": {rel: {size, sig|crc}}}`` (what the agent's
    upload-skip pass verifies) and rename it into place. Any gap abandons
    the mirror — never a half-committed destination. True when the
    mirror committed."""
    work = mirror + WORK_SUFFIX
    if not os.path.isdir(work):
        return False
    try:
        files: dict = {}
        procs = list(procs)
        for k in procs:
            marker = os.path.join(work, mirror_marker(k))
            if not os.path.isfile(marker):
                raise OSError(f"mirror marker h{k:04d} missing")
            try:
                with open(marker) as f:
                    files.update(json.load(f).get("files", {}))
            except ValueError as exc:
                raise OSError(f"mirror marker h{k:04d} malformed: {exc}"
                              ) from exc
        for k in procs:
            os.unlink(os.path.join(work, mirror_marker(k)))
        manifest = os.path.join(work, MANIFEST_FILE)
        shutil.copyfile(os.path.join(committed, MANIFEST_FILE), manifest)
        files[MANIFEST_FILE] = {"size": os.path.getsize(manifest),
                                "crc": crc32_file(manifest)}
        atomic_write_text(os.path.join(work, COMMIT_FILE),
                          FORMAT + "\n" + json.dumps({"files": files}) + "\n")
        if os.path.isdir(mirror):
            shutil.rmtree(mirror)
        os.rename(work, mirror)
    except OSError as exc:
        log.warning("abandoning snapshot mirror %s: %s", mirror, exc)
        shutil.rmtree(work, ignore_errors=True)
        return False
    return True


# -- write -----------------------------------------------------------------------


def write_snapshot(directory: str, state: Any, *, meta: dict | None = None,
                   barrier: Callable[[], None] = lambda: None,
                   process_index: int | None = None,
                   process_count: int | None = None,
                   base: str | None = None, hashes: bool = False,
                   mirror: str | None = None, wire=None,
                   speculative: bool = False,
                   clean_names: frozenset | None = None,
                   shardings: Any = None, leg: bool = False) -> str:
    """Serialize the tree ``state`` to ``directory`` atomically; returns it.

    ``barrier``, ``process_index``, ``process_count``: one process of a
    multi-process dump (default: process 0 of 1). Each process writes its
    own ``data-h<k>.bin`` and ``index-h<k>.json`` into the shared work dir
    (with a mirror, its own tee and marker there), then calls
    ``barrier()``, which must synchronize every participating process;
    process 0 then merges the indexes, commits, and seals the mirror only
    when every marker is present; a second ``barrier()`` follows, and only
    then the kernel-library carry. Leaves of one name from several
    processes become one record with every process's chunks.

    ``base``: a committed snapshot; chunks byte-identical to its are
    recorded as references into it (delta dump, see the module
    docstring). A missing or uncommitted base degrades to a full dump; the
    base must not be ``directory``. The delta restores next to its base,
    at the same relative location.

    ``hashes``: record a sha256 per chunk, so that a later delta against
    this snapshot decides by hash instead of reading these bytes back (the
    pre-copy live pass pays it outside the blackout).

    ``mirror``: a second directory that receives a committed copy of the
    physically written bytes while the dump runs (a codec container with
    its ``.gritc`` sidecar under ``GRIT_SNAPSHOT_CODEC``); failures only
    abandon it.

    ``wire``: a :class:`~grit_tpu_torch.wire.WireDumpSink` that receives
    the same bytes (raw, or the codec's records) in write order while the
    dump drains, and the stream's terminator after a whole dump; the
    direct source-to-destination migration stream. Its failures never
    fail the dump: the caller reads ``wire.ok`` afterwards.

    ``speculative``: the concurrent pass of a quiesce-free dump, racing
    live steps: ``state`` is a drained clone
    (:func:`~grit_tpu_torch.device.quiesce.clone_generation`), whose
    device copies wait on nothing of the caller's stream, and the kernel
    libraries are not carried (the parked dump that validates against
    this pass carries them into the final directory).

    ``shardings``: a tree shaped like ``state`` of
    :class:`~grit_tpu_torch.parallel.sharding.NamedSharding` (or ``None``
    leaves), the sharded state's layout. A leaf with one records the
    ``named`` descriptor, and this process writes its shard (a DTensor
    leaf's local tensor; a plain leaf is whole on every rank, or on a
    pipe mesh a stage leaf's stage) only if it is the replica at
    coordinate 0 along every mesh dim that does not shard the leaf, so
    each distinct shard lands once in the merged manifest. Without
    ``shardings`` each DTensor leaf's comes from the leaf
    (:func:`~grit_tpu_torch.parallel.sharding.sharding_of`, as the JAX
    package reads ``arr.sharding``), and every plain leaf of such a state
    is replicated on its mesh (every rank holds it alike); a DTensor that
    no sharding describes raises, never written whole. A sharded dump
    that is not a ``leg`` is one process of the mesh's whole world.

    ``leg``: this process's own tree of a per-host dump (the gang's
    ``host-<k>`` legs): every shard it holds, replicas included, into
    ``data-h<process_index>.bin``, committed by this process alone with
    no ``barrier``. A leg restores alone onto the same mesh (each rank
    reads its own shards), and the legs of one cut together through
    :func:`merge_legs`.

    ``clean_names``: leaves the caller proved byte-identical to ``base``
    (:func:`validated_clean_names` against the clone ``base`` was written
    from). Each references its base chunk without any device read; a
    name the base does not hold falls through to the normal path, so a
    wrong claim costs time, never correctness, but membership itself is
    trusted.

    The caller quiesces first (:func:`grit_tpu_torch.device.quiesce.quiesce`)
    so the arrays are a consistent cut. The data file is not fsynced, as
    in the JAX package's default: every chunk is crc-verified on restore,
    and the upload to the checkpoint volume is the durability boundary.
    The manifest and COMMIT are fsynced before the rename that commits."""
    if not speculative:
        # The speculative pass has its own point (snap.speculate).
        faults.fault_point("device.snapshot.dump")
    t_start = time.perf_counter()
    pidx = 0 if process_index is None else int(process_index)
    pcount = 1 if process_count is None else int(process_count)
    shared = pcount > 1 and not leg
    work = directory + WORK_SUFFIX
    old = directory + ".old"
    if pidx == 0 or leg:
        # Crash recovery: a leftover .old from a crash mid-commit holds the
        # previous committed snapshot — put it back before overwriting.
        if snapshot_exists(old) and not snapshot_exists(directory):
            shutil.rmtree(directory, ignore_errors=True)
            os.rename(old, directory)
        elif os.path.isdir(old):
            shutil.rmtree(old)
    if shared:
        # The other processes write into the same work dir: only files of
        # processes beyond this count (a larger earlier run) go; each
        # process truncates its own.
        if pidx == 0 and os.path.isdir(work):
            for fname in os.listdir(work):
                if fname.startswith(("data-h", "index-h")):
                    try:
                        k = int(fname.split("-h")[1].split(".")[0])
                    except ValueError:
                        continue
                    if k >= pcount:
                        os.unlink(os.path.join(work, fname))
        os.makedirs(work, exist_ok=True)
    else:
        shutil.rmtree(work, ignore_errors=True)
        os.makedirs(work)

    base_chunks: dict = {}
    base_rel = base_abs = None
    if base is not None:
        base_chunks, base_rel, base_abs = _load_base_chunks(
            directory, base, own_file=data_file(pidx) if shared else None)
    raw = flatten_with_names(state)
    leaves = [(name, _as_tensor(leaf)) for name, leaf in raw]
    # From the leaves themselves: a DTensor's detached copy no longer
    # carries the sharding that placed it.
    layout = (dict(flatten_with_names(shardings)) if shardings is not None
              else _derived_layout(raw))
    mesh = next((sh.mesh for sh in layout.values() if sh is not None), None)
    if mesh is not None and not leg and pcount != mesh.size():
        raise ValueError(
            f"a sharded state on {mesh.size()} ranks dumped as {pcount} "
            "process(es): every rank of the mesh writes its shards "
            "(process_index/process_count), or each its own leg (leg=True)")
    mirror_work, tee = _open_mirror(mirror, wire, pidx=pidx, shared=shared,
                                    flight_dir=work)
    clean = clean_names or frozenset()
    d2h = _DeviceToHost(settled=speculative)
    legs = _DumpLegs()
    records: list[dict] = []
    # (crc, nbytes) of every physically appended chunk in write order —
    # the byte stream the mirror tees, folded into its COMMIT signature.
    written_pairs: list[tuple[int, int]] = []
    offset = 0
    # On the log governing the directory, from this process (the pid that
    # drained the device); the speculative pass stays off the bracket.
    if not speculative:
        flight.emit_near(work, "dump.start", delta=base is not None)
    try:
        with open(os.path.join(work, data_file(pidx)), "wb") as f, \
                ThreadPoolExecutor(max_workers=1) as hasher:
            for name, leaf in leaves:
                if leaf.dtype not in _DTYPE_NAMES:
                    raise ValueError(f"{name}: unsupported dtype {leaf.dtype}")
                dtype = _DTYPE_NAMES[leaf.dtype]
                t, index, shape, sharding, mine = _shard_of(
                    name, leaf, layout.get(name))
                record = {"name": name, "dtype": dtype, "shape": shape,
                          "sharding": sharding, "chunks": []}
                records.append(record)
                if not (mine or leg):
                    continue
                nbytes = t.numel() * t.element_size()
                bc = base_chunks.get((name, tuple(map(tuple, index)), nbytes,
                                      dtype))
                chunk, known = None, {}
                if bc is not None and name in clean:
                    # Validated clean: reference the base chunk; the
                    # size and dtype come from metadata, not a read.
                    chunk = _ref_chunk(bc, index, base_rel)
                elif bc is not None:
                    chunk, known = _match_base_chunk(
                        base_abs, base_rel, bc, index,
                        lambda t=t: d2h.pieces(t), hasher, legs)
                if chunk is None:
                    chunk = _append(f, offset, nbytes, index, d2h.pieces(t),
                                    hashes=hashes, known=known, hasher=hasher,
                                    legs=legs, tee=tee, borrowed=t.is_cuda,
                                    fname=data_file(pidx))
                    written_pairs.append((chunk["crc"], nbytes))
                    offset += nbytes
                    if not speculative:
                        # The waterline: physical bytes drained so far.
                        flight.emit_near(work, "dump.chunk", bytes=offset)
                record["chunks"].append(chunk)
    except BaseException:
        # The tee must never be left blocked, nor its work dir survive.
        if tee is not None:
            tee.finish(dump_ok=False)
            if mirror_work is not None:
                shutil.rmtree(mirror_work, ignore_errors=True)
        if not speculative:
            flight.emit_near(work, "dump.end", bytes=offset, ok=False)
        raise

    with open(os.path.join(work, index_file(pidx)), "w") as f:
        json.dump(records, f)
    if tee is not None and tee.finish() and mirror_work is not None:
        _mark_mirror(mirror_work, work, written_pairs, tee.sidecar_path,
                     pidx=pidx)

    if not leg:
        barrier()
    mirrored = False
    if leg:
        _commit(directory, work, old, records, pcount, meta, base_rel)
        mirrored = mirror is not None and _commit_mirror(mirror, directory,
                                                         [pidx])
    elif pidx == 0:
        _commit(directory, work, old, _merge_indexes(work, records, pcount),
                pcount, meta, base_rel)
        mirrored = mirror is not None and _commit_mirror(mirror, directory,
                                                         range(pcount))
    if not leg:
        barrier()
    if not speculative:
        _carry_kernels(directory)
    wall = time.perf_counter() - t_start
    op = "speculate" if speculative else "write"
    SNAPSHOT_BYTES.inc(offset, op=op)
    SNAPSHOT_SECONDS.inc(wall, op=op)
    trace.record_span(
        "snapshot.write.speculative" if speculative else "snapshot.write",
        time.time_ns() - int(wall * 1e9), bytes=offset, delta=base is not None)
    if not speculative:
        # The commit tail (mirror seal, merge, rename, carry) is the dump's.
        flight.emit_near(directory, "dump.end", bytes=offset)
    with _RECORD_LOCK:
        _LAST_WRITE.clear()
        _LAST_WRITE.update(
            wall=wall, copy_wait=d2h.wait_s, **legs.s, bytes=offset,
            total_bytes=sum(c["nbytes"] for rec in records
                            for c in rec["chunks"]),
            staging=(f"pinned ring {_RING_SLOTS} x {_PIECE_BYTES >> 20} MiB, "
                     "side-stream D2H" if d2h._ring is not None else "host")
            + ", hashing beside the write",
            mirror=mirrored, speculative=speculative,
            codec=tee.codec if tee is not None else transport_codec.CODEC_NONE,
            mirror_bytes=tee.comp_written if tee is not None else 0,
            codec_wait=tee.codec_wait_s if tee is not None else 0.0)
    return directory


def _shard_of(name: str, leaf: torch.Tensor, sharding
              ) -> tuple[torch.Tensor, list[list[int]], list[int], dict,
                         bool]:
    """What this process writes of ``leaf``: ``(tensor, its global index,
    the array's global shape, the sharding descriptor, whether this
    process is the one replica that writes it)``."""
    if sharding is None:
        if is_dtensor(leaf):
            raise ValueError(f"{name}: a DTensor leaf needs its sharding "
                             "(write_snapshot(shardings=))")
        shape = [int(d) for d in leaf.shape]
        return leaf, [[0, d] for d in shape], shape, \
            {"type": "replicated"}, True
    shape = (list(leaf.shape) if is_dtensor(leaf)
             else sharding.global_shape(leaf.shape))
    index = sharding.shard_index(shape)
    local = local_shard(leaf)
    if list(local.shape) != sharding.held_shape(index):
        raise ValueError(f"{name}: local shape {list(local.shape)} is not "
                         f"the shard {index} of {sharding.spec}")
    return local, index, shape, sharding.descriptor(), sharding.writes()


def _mesh_key(mesh) -> tuple:
    return (tuple(mesh.shape), tuple(mesh.mesh_dim_names),
            tuple(mesh.mesh.flatten().tolist()))


def _derived_layout(leaves: list[tuple[str, Any]]) -> dict:
    """The layout of a state dumped without ``shardings=``: each DTensor
    leaf's own sharding and, when there is one, every plain leaf
    replicated on that mesh; ``{}`` for a state with no DTensor. Raises
    for a DTensor no sharding describes and for DTensors of two meshes."""
    named: dict = {}
    for name, x in leaves:
        if is_dtensor(x):
            try:
                named[name] = sharding_of(x)
            except ValueError as exc:
                raise ValueError(f"{name}: {exc}") from None
    if not named:
        return {}
    meshes = {_mesh_key(sh.mesh): sh.mesh for sh in named.values()}
    if len(meshes) > 1:
        raise ValueError(f"the state's DTensors live on {len(meshes)} "
                         "meshes; a snapshot describes one")
    mesh = next(iter(meshes.values()))
    return {name: named.get(name) or NamedSharding(mesh, ())
            for name, _ in leaves}


def merge_legs(directory: str, legs: list[str]) -> str:
    """One committed snapshot at ``directory`` over the legs of one
    per-host cut (each a process's own tree, ``write_snapshot(leg=True)``):
    every leg's records joined by name, each distinct shard once, every
    chunk referencing its leg's bytes (``ref_dir``), so it holds no data
    file of its own. A restore onto another mesh, into one device, or by
    the JAX package reads it as any snapshot. Raises
    :class:`SnapshotIntegrityError` unless every leg is committed and a
    leg of this cut (``process_count`` the number of legs, its chunks in
    its own ``data-h<k>.bin``, each ``k`` once), the legs agree on the
    meta, on every array's dtype, shape and descriptor and on the crc
    (and sha256) of a shard that several hold, and together cover every
    array."""
    if not legs:
        raise ValueError("merge_legs needs at least one leg")
    target = os.path.abspath(directory)
    merged: dict[str, dict] = {}
    # (array name, shard index) -> the first leg's chunk and its leg.
    held: dict[tuple, tuple[dict, str]] = {}
    owners: dict[int, str] = {}
    meta = None
    for leg_dir in legs:
        if not snapshot_exists(leg_dir):
            raise SnapshotIntegrityError(f"leg {leg_dir} is not a committed "
                                         "snapshot")
        m = SnapshotManifest.load(leg_dir)
        if m.process_count != len(legs):
            raise SnapshotIntegrityError(
                f"{leg_dir} is not a leg of a cut of {len(legs)} hosts: it "
                f"records {m.process_count} process(es)")
        files = {c["file"] for rec in m.arrays for c in rec["chunks"]}
        own = [k for k in range(len(legs)) if files == {data_file(k)}]
        if files and not own:
            raise SnapshotIntegrityError(
                f"{leg_dir} is not one process's leg: its chunks are in "
                f"{sorted(files)}")
        if own and own[0] in owners:
            raise SnapshotIntegrityError(
                f"{leg_dir} and {owners[own[0]]} are both process "
                f"{own[0]}'s leg")
        if own:
            owners[own[0]] = leg_dir
        if meta is None:
            meta = m.meta
        elif m.meta != meta:
            raise SnapshotIntegrityError(
                f"leg {leg_dir} is of another cut: meta {m.meta}, the first "
                f"leg's {meta}")
        for rec in m.arrays:
            name = rec["name"]
            mine = merged.get(name)
            if mine is None:
                mine = merged[name] = {k: v for k, v in rec.items()
                                       if k != "chunks"}
                mine["chunks"] = []
            elif any(mine[k] != rec[k] for k in ("dtype", "shape",
                                                  "sharding")):
                raise SnapshotIntegrityError(
                    f"{name}: leg {leg_dir} records another array")
            for c in rec["chunks"]:
                key = (name, tuple(map(tuple, c["index"])))
                if key in held:
                    first, first_leg = held[key]
                    if not _same_chunk(first, c):
                        raise SnapshotIntegrityError(
                            f"{name}: the shard {c['index']} differs "
                            f"between legs {first_leg} and {leg_dir}")
                    continue
                held[key] = (c, leg_dir)
                data_dir = os.path.normpath(os.path.join(
                    os.path.abspath(leg_dir), c.get("ref_dir") or ""))
                mine["chunks"].append(
                    {**c, "ref_dir": os.path.relpath(data_dir, target)})
    for rec in merged.values():
        if not _coverage_complete(rec["shape"],
                                  [c["index"] for c in rec["chunks"]]):
            raise SnapshotIntegrityError(
                f"{rec['name']}: the legs leave elements uncovered (a "
                "host's leg is missing)")
    work = directory + WORK_SUFFIX
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    _commit(directory, work, directory + ".old", list(merged.values()),
            len(legs), meta, None)
    return directory


def _same_chunk(a: dict, b: dict) -> bool:
    """Whether two legs' chunks of one shard record the same bytes: the
    same size and checksum, and the same sha256 where both have one."""
    if (a["nbytes"], a.get("algo"), a["crc"]) != \
            (b["nbytes"], b.get("algo"), b["crc"]):
        return False
    return not ("sha256" in a and "sha256" in b) or \
        a["sha256"] == b["sha256"]


def _merge_indexes(work: str, own: list[dict], pcount: int) -> list[dict]:
    """Process 0's merge: every process's records in process order, the
    chunks of one array name joined into its first record (``own`` is
    process 0's list, the others are read from their index files)."""
    merged: dict[str, dict] = {}
    for k in range(pcount):
        if k == 0:
            recs = own
        else:
            with open(os.path.join(work, index_file(k))) as f:
                recs = json.load(f)
        for rec in recs:
            if rec["name"] in merged:
                merged[rec["name"]]["chunks"].extend(rec["chunks"])
            else:
                merged[rec["name"]] = rec
    return list(merged.values())


def _commit(directory: str, work: str, old: str, records: list[dict],
            pcount: int, meta: dict | None, base_rel: str | None) -> None:
    """Process 0's commit: the manifest (with the delta's ``dirty``
    accounting), COMMIT, both fsynced, then the rename of the work dir."""
    manifest = {"format": FORMAT, "process_count": pcount,
                "meta": meta or {}, "arrays": records}
    if base_rel is not None:
        manifest["base"] = base_rel  # informational; chunks carry ref_dir
        chunks = [c for rec in records for c in rec["chunks"]]
        dirty = [c for c in chunks if not c.get("ref_dir")]
        manifest["dirty"] = {
            "bytes": sum(int(c["nbytes"]) for c in dirty),
            "totalBytes": sum(int(c["nbytes"]) for c in chunks),
            "chunks": len(dirty), "totalChunks": len(chunks)}
    atomic_write_json(os.path.join(work, MANIFEST_FILE), manifest)
    atomic_write_text(os.path.join(work, COMMIT_FILE), FORMAT + "\n")
    if os.path.isdir(directory):
        os.rename(directory, old)
    os.rename(work, directory)
    shutil.rmtree(old, ignore_errors=True)


def _carry_kernels(directory: str) -> None:
    """The kernel-library carry of a committed snapshot (never fails it)."""
    try:
        build.save_compile_cache(directory)
    except OSError as exc:
        log.warning("kernel libraries not carried into %s: %s", directory, exc)


def _append(f, offset: int, nbytes: int, index: list,
            pieces: Iterator[np.ndarray], *, hashes: bool, known: dict,
            hasher: ThreadPoolExecutor, legs: _DumpLegs,
            tee: _MirrorWriter | None, borrowed: bool,
            fname: str = DATA_FILE) -> dict:
    """Write one array's bytes at ``offset`` of the data file ``f`` (and
    into the tee) while the hasher thread checksums them; returns its
    chunk record. ``known`` holds the crc or sha256 a failed base match
    already computed over these bytes. ``borrowed``: the pieces are ring
    slots, reused once the next piece is asked for. ``fname``: the data
    file's name, which the record carries."""
    digest = _Digest(hasher, legs, crc="crc" not in known,
                     sha256=hashes and "sha256" not in known)
    for piece in pieces:
        fut = digest.feed(piece)
        legs.timed("write", f.write, piece)
        if tee is not None:  # copying the piece, or waiting for the tee
            legs.timed("tee", tee.put, piece, borrowed=borrowed)
        fut.result()
    chunk = {"file": fname, "offset": offset, "nbytes": nbytes,
             "index": index, "crc": known.get("crc", digest.crc),
             "algo": "crc32"}
    if hashes:
        chunk["sha256"] = known.get("sha256") or digest.sha256()
    return chunk


# -- validated speculation -------------------------------------------------------


class SpeculativeDump:
    """Handle to an in-flight speculative (quiesce-free) snapshot pass,
    made by :func:`start_speculative_dump`: the cloned generation
    (``clone``, the validation reference) and the thread writing it to
    ``directory`` (``<final_dir>-spec``). The parked dump joins it,
    validates the live state against the clone and re-ships the diff.
    ``seconds`` is the pass's wall time, ``legs`` its writer's legs
    (:func:`last_write`), ``error`` what it raised."""

    def __init__(self, directory: str, final_dir: str, clone: Any) -> None:
        self.directory = directory
        self.final_dir = final_dir
        self.clone = clone
        self.error: BaseException | None = None
        self.seconds = 0.0
        self.legs: dict = {}
        self.hbm: dict | None = None  # the agentlet's device-memory record
        self._thread: threading.Thread | None = None

    @property
    def ok(self) -> bool:
        return self._thread is not None and not self._thread.is_alive() \
            and self.error is None

    def join(self, timeout: float | None = None) -> bool:
        """Wait for the pass; True iff it has finished (ok or not)."""
        self._thread.join(timeout)
        return not self._thread.is_alive()

    def release(self) -> None:
        """Drop the handle's reference to the clone (idempotent). A pass
        still writing keeps its own reference, and the device copies it
        queued hold the clone's memory through ``record_stream``, so this
        never frees bytes that are still being read."""
        self.clone = None


def start_speculative_dump(directory: str, state: Any, *,
                           already_cloned: bool = False,
                           meta: dict | None = None, base: str | None = None,
                           mirror: str | None = None,
                           dump_lock: threading.Lock | None = None,
                           **leg) -> SpeculativeDump:
    """Launch the concurrent pass of a quiesce in progress.

    ``directory`` is the final dump directory; the pass commits to its
    ``-spec`` sibling, hashed, as a delta against ``base`` when given,
    with its mirror (if any) at ``mirror + "-spec"``. ``state`` is cloned
    first (:func:`~grit_tpu_torch.device.quiesce.clone_generation`; a
    zero-argument callable goes through ``clone_live_generation``), or
    taken as is with ``already_cloned`` (the agentlet harvests its clone
    at a step boundary). A thread then writes the clone with
    ``speculative=True`` while holding ``dump_lock`` (the agentlet's
    snapshot serializer): callers join the handle before they take it.
    Raises whatever the clone raises; callers degrade to the parked dump
    on any exception. ``leg``: ``process_index``, ``process_count`` and
    ``leg`` of a rank's own leg (:func:`write_snapshot`)."""
    from grit_tpu_torch.device.quiesce import (  # noqa: PLC0415
        clone_generation,
        clone_live_generation,
    )

    if already_cloned:
        clone = state
    elif callable(state):
        clone = clone_live_generation(state)
    else:
        clone = clone_generation(state)
    handle = SpeculativeDump(directory + SPEC_SUFFIX, directory, clone)
    lock = dump_lock if dump_lock is not None else threading.Lock()
    flight.emit_near(os.path.dirname(directory) or ".",
                     "snap.speculative.start",
                     dir=os.path.basename(handle.directory),
                     delta=base is not None)

    def run(state_ref: Any) -> None:
        # The clone is pinned by this thread (its argument), not by the
        # handle: a caller that gives up on the join and releases the
        # handle must not drop the state under the write.
        t0 = time.monotonic()
        try:
            with lock:
                write_snapshot(handle.directory, state_ref, meta=meta,
                               base=base, hashes=True,
                               mirror=(mirror + SPEC_SUFFIX) if mirror else None,
                               speculative=True, **leg)
                handle.legs = last_write()
        except BaseException as exc:  # noqa: BLE001 — surfaced via handle.error
            handle.error = exc
        finally:
            handle.seconds = time.monotonic() - t0
            SNAP_SPECULATIVE_SECONDS.inc(handle.seconds, phase="concurrent")

    handle._thread = threading.Thread(target=run, args=(clone,),
                                      name="grit-spec-dump", daemon=True)
    handle._thread.start()
    return handle


# Same-width integer views: the validation compares bytes, so a sign of
# zero counts (-0.0 != +0.0) and identical NaN bytes are equal.
_INT_VIEW = {1: torch.uint8, 2: torch.int16, 4: torch.int32, 8: torch.int64}


def validated_clean_names(state: Any, clone: Any) -> set | None:
    """The leaves of ``state`` byte-identical to the speculative ``clone``:
    the ones the steps since the clone left untouched.

    Each leaf pair is compared on its device through an integer view of
    its width, with no copy of the data to the host; the verdicts of each
    device are stacked and fetched with one transfer. Leaves that are not
    tensors compare as the tensors the dump writes. Returns None when the
    two trees are structurally incomparable (other names, shapes or
    dtypes), which callers treat as "degrade to the parked full dump"."""
    flat_s = flatten_with_names(state)
    flat_c = flatten_with_names(clone)
    if [n for n, _ in flat_s] != [n for n, _ in flat_c]:
        return None
    verdicts: dict[torch.device, list[tuple[str, torch.Tensor]]] = {}
    for (name, a), (_, b) in zip(flat_s, flat_c):
        # A DTensor's local shards: each rank validates what it writes.
        a, b = local_shard(_as_tensor(a)), local_shard(_as_tensor(b))
        if a.shape != b.shape or a.dtype != b.dtype or a.device != b.device:
            return None
        view = _INT_VIEW[a.element_size()]
        same = (a.view(view) == b.view(view)).all()
        verdicts.setdefault(a.device, []).append((name, same))
    clean = set()
    for pairs in verdicts.values():
        got = torch.stack([v for _, v in pairs]).cpu().tolist()
        clean.update(name for (name, _), ok in zip(pairs, got) if ok)
    return clean


# -- streamed stage ----------------------------------------------------------------


class _StageMonitor:
    """Reader side of the streamed-staging journal
    (``grit_tpu/agent/copy.py:StageJournal``): tails
    ``<staging root>/.grit-stage-journal`` by byte offset so a read blocks
    on exactly the byte range it needs while later bytes still cross.

    A terminal ``{"failed": msg}`` line, or a wait past
    ``GRIT_TPU_STAGE_TIMEOUT_S``, raises :class:`SnapshotIntegrityError`
    out of every waiter: a torn stage is never half-consumed, and never
    hangs."""

    _POLL_S = 0.02

    def __init__(self, journal_path: str, root: str) -> None:
        self.root = root
        self.path = journal_path
        self._pos = 0  # byte offset of the next unread journal line
        self._buf = b""
        self._water: dict[str, int] = {}
        self._done: set[str] = set()
        self._complete = False
        self._failed: str | None = None
        self._lock = threading.Lock()
        # Seconds restore threads spent blocked on staging (the
        # stage_wait leg).
        self.stage_wait_s = 0.0

    @classmethod
    def find(cls, directory: str) -> "_StageMonitor | None":
        """The journal governing ``directory``: it sits at the staging
        root, a few levels above ``<root>/<container>/hbm``. None → not a
        streamed stage, every read proceeds ungated."""
        d = os.path.abspath(directory)
        for _ in range(4):
            p = os.path.join(d, STAGE_JOURNAL_FILE)
            if os.path.isfile(p):
                return cls(p, d)
            parent = os.path.dirname(d)
            if parent == d:
                break
            d = parent
        return None

    def _poll_locked(self) -> None:
        # No held handle: each poll reads what the stager appended since.
        # A torn trailing line stays buffered until its newline lands.
        try:
            with open(self.path, "rb") as f:
                f.seek(self._pos)
                data = f.read()
        except OSError:
            return
        self._pos += len(data)
        self._buf += data
        while b"\n" in self._buf:
            raw, self._buf = self._buf.split(b"\n", 1)
            if not raw.strip():
                continue
            try:
                rec = json.loads(raw)
            except ValueError:
                continue  # terminal markers are whole lines
            if rec.get("complete"):
                self._complete = True
            elif "failed" in rec:
                self._failed = str(rec["failed"])
            elif "file" in rec:
                rel = os.path.normpath(rec["file"])
                self._water[rel] = max(self._water.get(rel, 0),
                                       int(rec.get("staged", 0)))
                if rec.get("done"):
                    self._done.add(rel)

    def _ready_locked(self, rel: str, nbytes: int | None) -> bool:
        if rel in self._done or self._complete:
            return True
        return nbytes is not None and self._water.get(rel, 0) >= nbytes

    def ready_hint(self, path: str, nbytes: int | None = None) -> bool:
        """Non-blocking: whether ``path`` appears to have ``nbytes``
        contiguous bytes staged (None: the whole file). A hint that only
        orders the post-copy tail; the gated read still waits on
        :meth:`wait_ready`. Paths outside the staging root, and a failed
        stage (whose read then raises), report ready."""
        rel = os.path.relpath(os.path.abspath(path), self.root)
        if rel.startswith(".."):
            return True
        with self._lock:
            self._poll_locked()
            return self._failed is not None or self._ready_locked(
                os.path.normpath(rel), nbytes)

    def wait_ready(self, path: str, nbytes: int | None = None) -> None:
        """Block until ``path`` has at least ``nbytes`` contiguous bytes
        from 0 staged (None: the whole file). Paths outside the staging
        root are not part of this transfer and return at once."""
        rel = os.path.relpath(os.path.abspath(path), self.root)
        if rel.startswith(".."):
            return
        rel = os.path.normpath(rel)
        timeout = _stage_timeout()
        t0 = time.monotonic()
        deadline = t0 + timeout
        blocked = False
        try:
            while True:
                with self._lock:
                    self._poll_locked()
                    if self._failed is not None:
                        raise SnapshotIntegrityError(
                            f"streamed stage failed mid-transfer "
                            f"({self._failed}); refusing to consume "
                            f"partially-staged snapshot")
                    if self._ready_locked(rel, nbytes):
                        return
                if time.monotonic() > deadline:
                    raise SnapshotIntegrityError(
                        f"timed out after {timeout:.0f}s waiting for staged "
                        f"bytes of {rel} (need {nbytes}, have "
                        f"{self._water.get(rel, 0)})")
                blocked = True
                time.sleep(self._POLL_S)
        finally:
            # Only a read that found its bytes not yet staged waited: a
            # restore that starts after the stage has ended counts none.
            if blocked:
                with self._lock:
                    self.stage_wait_s += time.monotonic() - t0


def _stage_timeout() -> float:
    return config.TPU_STAGE_TIMEOUT_S.get_float()


# -- read ------------------------------------------------------------------------


def _chunk_path(directory: str, chunk: dict) -> str:
    """The file holding ``chunk``'s bytes (a delta's base file for a
    referenced chunk)."""
    if chunk.get("ref_dir"):  # delta chunk: the bytes live in the base
        directory = os.path.normpath(os.path.join(directory, chunk["ref_dir"]))
    return os.path.join(directory, chunk["file"])


def _running_crc(algo: str) -> Callable:
    """The running checksum ``(buf, crc) -> crc`` of a chunk's ``algo``:
    zlib's crc32, or the crc32c library's (:mod:`grit_tpu_torch.checksum`).
    A crc32c chunk is read verified or not at all: where the library cannot
    be built this raises, naming why (the reference skips the check)."""
    if algo == "crc32":
        return zlib.crc32
    if algo == "crc32c":
        try:
            checksum.library()
        except checksum.CRC32CUnavailable as exc:
            raise SnapshotIntegrityError(
                f"chunks carry crc32c checksums and the crc32c library is "
                f"unavailable, so they cannot be verified: {exc}") from exc
        return checksum.crc32c
    raise SnapshotIntegrityError(f"unknown checksum algo {algo!r}")


def _read_chunk_into(directory: str, chunk: dict, views: list[np.ndarray], *,
                     verify: bool, monitor: _StageMonitor | None) -> None:
    """``chunk``'s raw bytes read straight into ``views`` (its pieces, in
    order), each read waiting only for its own bytes under a streamed
    stage (the stager preallocates the data file: an ungated read would
    consume zeros), with a running checksum of the chunk's algo (crc32 or
    crc32c) checked at the end unless ``verify`` is False.

    A data file with a ``.gritc`` sidecar is a codec container: the
    covering blocks are read (gated on their container bytes), decoded and
    checked against their crc-of-raw, and the chunk's checksum is taken
    over the raw bytes, as for a raw file. A torn sidecar or a corrupt
    block raises :class:`SnapshotIntegrityError`."""
    path = _chunk_path(directory, chunk)
    where = f"{chunk['file']}@{chunk['offset']}"
    crc_fn = _running_crc(chunk.get("algo", "crc32")) if verify else None
    try:
        cindex = transport_codec.load_container_index(path)
    except transport_codec.CodecError as exc:
        raise SnapshotIntegrityError(
            f"codec sidecar for {chunk['file']} is torn: {exc}") from exc
    if cindex is None:
        crc = _read_raw_into(path, chunk["offset"], views, crc_fn, monitor,
                             where)
    else:
        try:
            crc = _read_container_into(path, cindex, chunk["offset"], views,
                                       crc_fn, monitor, where)
        except transport_codec.CodecError as exc:
            raise SnapshotIntegrityError(
                f"container decode failed in {where}: {exc}") from exc
    if verify and crc != chunk.get("crc", chunk.get("crc32")):
        raise SnapshotIntegrityError(
            f"crc mismatch ({chunk.get('algo', 'crc32')}) in {where}")


def _read_raw_into(path: str, offset: int, views: list[np.ndarray], crc_fn,
                   monitor: _StageMonitor | None, where: str) -> int:
    """Raw bytes at ``offset`` into ``views``; returns their checksum (0
    without ``crc_fn``)."""
    crc = 0
    end = offset
    if monitor is not None and views:
        # The stager may not have created the file before its first bytes.
        monitor.wait_ready(path, end + views[0].nbytes)
    # Unbuffered: a buffered reader would read ahead past the waterline
    # and later serve those not-yet-staged bytes from its buffer.
    with open(path, "rb", buffering=0) as f:
        f.seek(end)
        for view in views:
            end += view.nbytes
            if monitor is not None:
                monitor.wait_ready(path, end)
            mv, got = memoryview(view), 0
            while got < view.nbytes:
                n = f.readinto(mv[got:])
                if not n:
                    raise SnapshotIntegrityError(f"short read in {where}")
                got += n
            if crc_fn is not None:
                crc = crc_fn(view, crc)
    return crc


def _read_container_into(path: str, cindex, offset: int,
                         views: list[np.ndarray], crc_fn,
                         monitor: _StageMonitor | None, where: str) -> int:
    """Raw bytes ``[offset, offset + sum(views))`` of a container into
    ``views``, block by block; returns their checksum (0 without
    ``crc_fn``). A streamed stage's waterline counts container bytes."""
    nbytes = sum(v.nbytes for v in views)
    flat = [(v, v.nbytes) for v in views]
    vi = vo = 0  # the view and the offset in it that the next byte lands at
    crc = 0
    pos = offset
    with open(path, "rb", buffering=0) as f:
        for rec in cindex.covering(offset, nbytes):
            lo = max(pos, rec.raw_off)
            hi = min(offset + nbytes, rec.raw_off + rec.raw_n)
            if hi <= lo:
                continue
            if monitor is not None:
                monitor.wait_ready(path, rec.comp_off + rec.comp_n)
            payload = os.pread(f.fileno(), rec.comp_n, rec.comp_off)
            if len(payload) != rec.comp_n:
                raise SnapshotIntegrityError(
                    f"short container read in {where} at {rec.comp_off} "
                    f"({len(payload)}/{rec.comp_n})")
            raw = transport_codec.decompress_block(
                rec.codec, payload, rec.raw_n, rec.crc_raw)
            seg = np.frombuffer(raw, np.uint8)[lo - rec.raw_off:hi - rec.raw_off]
            if crc_fn is not None:
                crc = crc_fn(seg, crc)
            while seg.nbytes:
                view, size = flat[vi]
                k = min(size - vo, seg.nbytes)
                view[vo:vo + k] = seg[:k]
                seg = seg[k:]
                vo += k
                if vo == size:
                    vi, vo = vi + 1, 0
            pos = hi
    return crc


def _coverage_complete(shape: list[int], indices: list[list]) -> bool:
    """Exact union coverage of hyperrectangular chunks: each dimension
    coordinate-compressed to the chunks' boundaries, cells marked on that
    grid (at most one cell per chunk tile, never an array-sized mask).
    Overlapping chunks (replicated leaves) are normal."""
    if not shape:  # scalar leaf: any chunk covers it
        return bool(indices)
    bounds = []
    for d, size in enumerate(shape):
        cuts = {0, size}
        for index in indices:
            start, stop = index[d]
            cuts.add(min(max(start, 0), size))
            cuts.add(min(max(stop, 0), size))
        bounds.append(sorted(cuts))
    grid = np.zeros([len(b) - 1 for b in bounds], dtype=bool)
    if grid.size == 0:  # some dimension has size 0: trivially covered
        return True
    for index in indices:
        sl = []
        for d in range(len(shape)):
            start, stop = index[d]
            i0 = bisect.bisect_left(bounds[d], max(start, 0))
            i1 = bisect.bisect_left(bounds[d], min(stop, shape[d]))
            sl.append(slice(i0, i1))
        grid[tuple(sl)] = True
    return bool(grid.all())


def _read_slice_host(directory: str, rec: dict, want: list[list[int]], *,
                     verify: bool, monitor: _StageMonitor | None) -> torch.Tensor:
    """Disk phase of one array's restore (runs on a reader thread): the
    bytes of its slice ``want`` (``[[start, stop], ...]``, the whole array
    or one shard of it) as a CPU tensor. A chunk whose index is ``want``
    is read alone; otherwise the slice is cut from every chunk that
    overlaps it, which must cover it."""
    dtype = _NAME_DTYPES.get(rec["dtype"])
    if dtype is None:
        raise SnapshotIntegrityError(f"array {rec['name']}: unsupported dtype "
                                     f"{rec['dtype']!r}")
    itemsize = torch.empty((), dtype=dtype).element_size()

    def part(c: dict) -> torch.Tensor:
        part_shape = [b - a for a, b in c["index"]]
        nbytes = itemsize * int(np.prod(part_shape, dtype=np.int64))
        if c["nbytes"] != nbytes:
            raise SnapshotIntegrityError(f"array {rec['name']}: chunk "
                                         f"{c['file']}@{c['offset']} size "
                                         "mismatch")
        raw = np.empty(nbytes, dtype=np.uint8)
        _read_chunk_into(directory, c, [raw[o:o + m] for o, m in _spans(nbytes)],
                         verify=verify, monitor=monitor)
        return torch.from_numpy(raw).view(dtype).reshape(part_shape)

    chunks = rec["chunks"]
    exact = _exact_chunk(rec, want)
    if exact is not None:
        return part(exact)  # the read buffer is the slice
    out = torch.empty([b - a for a, b in want], dtype=dtype)
    covered = []
    for c in chunks:
        inter = [[max(a, wa), min(b, wb)]
                 for (a, b), (wa, wb) in zip(c["index"], want)]
        if any(a >= b for a, b in inter) and out.numel():
            continue
        src = part(c)
        out[tuple(slice(a - wa, b - wa) for (a, b), (wa, _) in
                  zip(inter, want))] = src[tuple(
                      slice(a - ca, b - ca)
                      for (a, b), (ca, _) in zip(inter, c["index"]))]
        covered.append([[a - wa, b - wa] for (a, b), (wa, _) in
                        zip(inter, want)])
    if not _coverage_complete(list(out.shape), covered):
        raise SnapshotIntegrityError(
            f"array {rec['name']}: chunks leave uncovered elements")
    return out


def _exact_chunk(rec: dict, want: list[list[int]]) -> dict | None:
    """The chunk of ``rec`` whose index is ``want``, if any."""
    return next((c for c in rec["chunks"] if c["index"] == want), None)


def _like_shard(local: torch.Tensor, like):
    """``local`` as ``like`` holds it: this rank's shard of a DTensor leaf
    wrapped in ``like``'s mesh and placements, a pipe-axis stage with its
    stacked dim dropped, else as it is."""
    if is_dtensor(like):
        return like_dtensor(local, like)
    if isinstance(like, torch.Tensor) and local.shape != like.shape:
        return local.reshape(like.shape)
    return local


def _want(leaf, rec: dict, sharding=None) -> list[list[int]]:
    """The slice of ``rec``'s array that ``leaf`` takes: this rank's shard
    of a DTensor leaf or of a plain leaf placed by ``sharding`` (a pipe
    mesh's stage), else the whole array."""
    if is_dtensor(leaf):
        return dtensor_index(leaf)
    if sharding is not None:
        return sharding.shard_index(rec["shape"])
    return [[0, int(d)] for d in rec["shape"]]


def _chunks_for(rec: dict, want: list[list[int]]) -> list[dict]:
    """The chunks a restore of the slice ``want`` reads: the one of that
    index, else every chunk that overlaps it."""
    exact = _exact_chunk(rec, want)
    if exact is not None:
        return [exact]
    return [c for c in rec["chunks"]
            if all(max(a, wa) < min(b, wb) for (a, b), (wa, wb) in
                   zip(c["index"], want))]


def _begin_restore(directory: str) -> tuple[_StageMonitor | None,
                                            SnapshotManifest, int]:
    """Gate on the stage journal's metadata (a caller racing the stager
    waits for COMMIT and MANIFEST), check the commit, seed the kernel
    libraries the snapshot carries (returning their count), load the
    manifest, and fail fast, naming it, on a referenced base that is
    missing or uncommitted — waiting first on its COMMIT when a journal
    governs it. An armed ``device.snapshot.place`` raises first."""
    faults.fault_point("device.snapshot.place")
    # Closes the restored process's start window (restart.start, where a
    # migration's restore opened one; an unmatched end builds nothing).
    flight.emit_near(directory, "restart.end")
    monitor = _StageMonitor.find(directory)
    if monitor is not None:
        monitor.wait_ready(os.path.join(directory, COMMIT_FILE))
        monitor.wait_ready(os.path.join(directory, MANIFEST_FILE))
    if not snapshot_exists(directory):
        raise FileNotFoundError(
            f"{directory} has no {COMMIT_FILE}: snapshot missing or uncommitted")
    # Before anything can launch a kernel: the carried libraries (if any)
    # spare the destination its nvcc.
    seeded = build.seed_compile_cache(directory)
    manifest = SnapshotManifest.load(directory)
    ref_dirs = {c["ref_dir"] for rec in manifest.arrays
                for c in rec["chunks"] if c.get("ref_dir")}
    for ref in sorted(ref_dirs):
        base_dir = os.path.normpath(os.path.join(directory, ref))
        if monitor is not None:
            monitor.wait_ready(os.path.join(base_dir, COMMIT_FILE))
        if not snapshot_exists(base_dir):
            raise SnapshotIntegrityError(
                f"delta snapshot {directory} references base {base_dir} "
                "which is missing or uncommitted — stage the base snapshot "
                "at the same relative location as on the dump side")
    return monitor, manifest, seeded


def restore_snapshot(directory: str, *, like: Any = None,
                     device: torch.device | str | None = None,
                     verify: bool = True, mesh=None,
                     shardings: Any = None) -> Any:
    """Load a committed snapshot.

    ``like``: a tree of the wanted structure. A tensor leaf on the meta
    device is loaded onto ``device``, by default the current CUDA device
    (with no GPU that raises: pass ``device="cpu"`` to restore onto the
    CPU); any other tensor leaf onto its own device; a Python int/float
    leaf comes back as that type. Dtypes and shapes must match the
    manifest. A DTensor leaf takes this rank's shard, cut from the chunks
    that overlap it. Without ``like`` the result is a flat ``{keystr
    name: CPU tensor}`` dict. ``verify``: check every chunk's crc32.

    ``shardings`` (a tree like ``like`` of
    :class:`~grit_tpu_torch.parallel.sharding.NamedSharding` or None) and
    ``mesh`` place plain ``like`` leaves, as the JAX package's arguments
    do: a leaf's sharding from ``shardings``, else, with ``mesh``, the
    descriptor the manifest records re-realised on ``mesh``. Such a leaf
    comes back a DTensor of that sharding, or on a pipe mesh this rank's
    plain tensor (a stage leaf's stage); the shape it is given is then
    the one a rank holds.

    Reader threads (``GRIT_TPU_RESTORE_WORKERS``; ``GRIT_RESTORE_PIPELINE=0``
    reads serially) read and checksum arrays ahead of the in-order place on
    this thread; under a streamed stage each read waits for its bytes."""
    t0 = time.monotonic()
    monitor, manifest, seeded = _begin_restore(directory)
    by_name = {rec["name"]: rec for rec in manifest.arrays}
    if like is None:
        names = list(by_name)
        recs = [by_name[n] for n in names]
        out = dict(zip(names, _restore_leaves(
            directory, _Placer(recs, [None] * len(recs), None),
            verify=verify, monitor=monitor, seeded=seeded)))
        _record_restore(recs, t0)
        return out
    recs, leaves, layouts, device = _like_plan(directory, by_name, like,
                                               device, mesh, shardings)
    placed = iter(_restore_leaves(directory,
                                  _Placer(recs, leaves, device, layouts),
                                  verify=verify, monitor=monitor,
                                  seeded=seeded))
    _record_restore(recs, t0)
    return map_with_names(lambda _name, _leaf: next(placed), like)


def _record_restore(recs: list[dict], started: float) -> None:
    """A finished restore's ``SNAPSHOT_*{op="restore"}`` and its
    ``snapshot.restore`` span."""
    nbytes = sum(c["nbytes"] for rec in recs for c in rec["chunks"])
    elapsed = time.monotonic() - started
    SNAPSHOT_BYTES.inc(nbytes, op="restore")
    SNAPSHOT_SECONDS.inc(elapsed, op="restore")
    trace.record_span("snapshot.restore", time.time_ns() - int(elapsed * 1e9),
                      bytes=nbytes)


def _placed_like(name: str, leaf, rec: dict, sharding):
    """``(leaf as the restore targets it, the sharding that cuts a plain
    leaf's slice)`` under ``sharding``: on a pipe mesh the leaf stays
    plain and ``sharding`` cuts its slice (a stage leaf's stage); on a
    DTensor mesh a plain tensor leaf that ``sharding`` splits becomes a
    DTensor of it (on the meta device when it was there); one it does not
    split stays whole, as the Trainer keeps its scalars."""
    if sharding is None or is_dtensor(leaf) or not isinstance(
            leaf, torch.Tensor):
        return leaf, None
    from grit_tpu_torch.parallel.mesh import is_pipe_mesh  # noqa: PLC0415

    if is_pipe_mesh(sharding.mesh):
        return leaf, sharding
    if not sharding.shards():
        return leaf, None
    if list(rec["shape"]) != list(leaf.shape):
        raise ValueError(f"{name}: snapshot holds {list(rec['shape'])}, "
                         f"want {list(leaf.shape)}")
    return sharding.zeros(rec["shape"], leaf.dtype, leaf.device), None


def _like_plan(directory: str, by_name: dict, like: Any,
               device: torch.device | str | None, mesh=None,
               shardings: Any = None
               ) -> tuple[list[dict], list, list, torch.device | None]:
    """The manifest records and leaves of ``like`` in its flattening
    order, each placed by ``shardings``/``mesh`` (:func:`restore_snapshot`)
    and checked against the manifest, the sharding that cuts each plain
    leaf's slice (a pipe mesh's) or None, and the device its meta leaves
    go to (resolved only when it has one)."""
    named = flatten_with_names(like)
    missing = [n for n, _ in named if n not in by_name]
    if missing:
        raise KeyError(f"snapshot {directory} lacks arrays: {missing[:5]}")
    given = (dict(flatten_with_names(shardings)) if shardings is not None
             else {})
    leaves, layouts = [], []
    for name, leaf in named:
        rec = by_name[name]
        sharding = given.get(name)
        if (sharding is None and mesh is not None
                and rec["sharding"].get("type") == "named"):
            sharding = NamedSharding(mesh,
                                     spec_from_descriptor(rec["sharding"]))
        leaf, layout = _placed_like(name, leaf, rec, sharding)
        if isinstance(leaf, torch.Tensor):
            held = _NAME_DTYPES.get(rec["dtype"], rec["dtype"])
            shape = (layout.global_shape(leaf.shape) if layout is not None
                     else list(leaf.shape))
            if held != leaf.dtype or list(rec["shape"]) != list(shape):
                raise ValueError(
                    f"{name}: snapshot holds {held} {list(rec['shape'])}, "
                    f"want {leaf.dtype} {list(shape)}")
        leaves.append(leaf)
        layouts.append(layout)
    if any(isinstance(x, torch.Tensor) and x.device.type == "meta"
           for x in leaves):
        device = resolve_device(device)
    elif isinstance(device, str):
        device = torch.device(device)
    return [by_name[n] for n, _ in named], leaves, layouts, device


def restore_snapshot_postcopy(directory: str, *, like: Any,
                              device: torch.device | str | None = None,
                              verify: bool = True, mesh=None,
                              shardings: Any = None) -> "PostcopyRestore":
    """Post-copy (lazy) :func:`restore_snapshot`: place the hot set (arrays
    of at most ``GRIT_RESTORE_POSTCOPY_HOT_MB`` each: step counters,
    norms, serving bookkeeping) now, through the blocking restore's
    readers and placer, and return a :class:`PostcopyRestore` whose
    background tail places the cold bulk in the order its bytes are
    staged. The caller resumes at once; :meth:`PostcopyRestore.wait`
    hands over the whole tree. ``like`` is required (the handle rebuilds
    the caller's tree); ``device``, ``verify``, ``mesh`` and
    ``shardings`` as for :func:`restore_snapshot`, whose checks every
    chunk still passes. On a mesh every rank places its own shards: the
    hot set and the tail each cut a rank's shard from the chunks that
    overlap it, never a whole array, and the split between them, by each
    array's whole size, is the same on every rank."""
    if like is None:
        raise ValueError("post-copy restore requires `like` (the handle "
                         "rebuilds the caller's tree)")
    t0 = time.monotonic()
    monitor, manifest, seeded = _begin_restore(directory)
    by_name = {rec["name"]: rec for rec in manifest.arrays}
    recs, leaves, layouts, device = _like_plan(directory, by_name, like,
                                               device, mesh, shardings)
    hot_cut = max(0.0, config.RESTORE_POSTCOPY_HOT_MB.get_float()) * 1e6
    # The whole array's bytes: every rank of a mesh splits alike.
    sizes = [_DTYPE_BYTES.get(rec["dtype"], 0) * int(
        np.prod(rec["shape"], dtype=np.int64)) for rec in recs]
    hot = [i for i, n in enumerate(sizes) if n <= hot_cut]
    cold = [i for i, n in enumerate(sizes) if n > hot_cut]
    placed = _restore_leaves(
        directory, _Placer([recs[i] for i in hot], [leaves[i] for i in hot],
                           device, [layouts[i] for i in hot]),
        verify=verify, monitor=monitor, seeded=seeded)
    handle = PostcopyRestore(
        directory, like=like, recs=recs, leaves=leaves, layouts=layouts,
        device=device, monitor=monitor, verify=verify,
        results=dict(zip(hot, placed)), cold=cold,
        meta=dict(manifest.meta), mesh=mesh, shardings=shardings)
    handle.hot_s = time.monotonic() - t0
    handle._t0 = t0
    handle.start()
    return handle


class PostcopyRestore:
    """An in-flight post-copy restore: the hot leaves placed, the cold
    ones landing through the tail thread. :meth:`wait` returns the whole
    ``like``-shaped tree.

    The tail reads each cold array into pinned blocks and copies it to
    the device on a side stream of its own, so its copies neither queue
    behind nor hold up the kernels the resumed workload puts on the
    default stream; the host waits for each array's copies before it
    releases the blocks and publishes the tensor, which is therefore
    complete on every stream. The tensor's memory is allocated on the
    tail thread's current stream, which the side stream waits for first,
    so the allocator never hands the copies memory a queued kernel still
    uses."""

    def __init__(self, directory: str, *, like: Any, recs: list[dict],
                 leaves: list, layouts: list, device: torch.device | None,
                 monitor: _StageMonitor | None, verify: bool,
                 results: dict, cold: list[int], meta: dict, mesh=None,
                 shardings: Any = None) -> None:
        self.directory = directory
        self.meta = meta
        self.hot_s = 0.0   # restore call → hot set placed
        self.tail_s = 0.0  # the tail's wall time
        self._like = like
        self._mesh = mesh
        self._shardings = shardings
        self._recs = recs
        self._leaves = leaves
        self._layouts = layouts
        self._names = [rec["name"] for rec in recs]
        self._device = device
        self._monitor = monitor
        self._verify = verify
        self._results: dict[int, Any] = dict(results)
        # Placed before the tail started: what a caller may decide on
        # without racing the tail's progress.
        self._hot = dict(results)
        self._cold = list(cold)
        self._cond = threading.Condition()
        self._err: BaseException | None = None
        self._done = not self._cold
        self._thread: threading.Thread | None = None
        self._t0 = time.monotonic()  # set to the restore call's start
        # The tail's spans join the restoring thread's trace.
        self._trace_ctx = trace.current_context()

    def start(self) -> None:
        self._thread = threading.Thread(target=self._tail,
                                        name="grit-postcopy-tail", daemon=True)
        self._thread.start()

    @property
    def done(self) -> bool:
        with self._cond:
            return self._done

    @property
    def placed(self) -> int:
        """Arrays placed so far (the hot set and the tail's progress)."""
        with self._cond:
            return len(self._results)

    def hot_leaves(self) -> dict:
        """``{keystr name: leaf}`` of the hot set, which the restore placed
        before the tail started: the same set however far the tail has
        got, so a decision made on it does not race the tail."""
        return {self._names[i]: v for i, v in self._hot.items()}

    def placed_leaves(self) -> dict:
        """``{keystr name: leaf}`` of the leaves placed so far: a snapshot
        in time, not a live view (a serving clone starts on the hot
        bookkeeping while its KV cache lands)."""
        with self._cond:
            return {self._names[i]: v for i, v in self._results.items()}

    def _tail(self) -> None:
        with trace.parented(self._trace_ctx):
            self._tail_parented()

    def _tail_parented(self) -> None:
        t0 = time.monotonic()
        ok = False
        flight.emit_near(self.directory, "postcopy.tail.start",
                         arrays=len(self._cold))
        try:
            placer = _Placer([self._recs[i] for i in self._cold],
                             [self._leaves[i] for i in self._cold],
                             self._device,
                             [self._layouts[i] for i in self._cold])
            placer.open_pool(1)
            stream = (torch.cuda.Stream(self._device)
                      if self._device is not None
                      and self._device.type == "cuda" else None)
            pending = list(range(len(self._cold)))
            placed_bytes = 0
            for order in range(len(pending)):
                j = self._pick_ready(pending)
                # The tail's first touch of an array: an armed raise is a
                # cold array whose bytes never arrive, and wait() falls
                # back to the blocking restore.
                faults.fault_point("restore.postcopy_fault")
                got = placer.read(j, self.directory, verify=self._verify,
                                  monitor=self._monitor, order=order)
                leaf = placer.place(j, got, stream=stream)
                pending.remove(j)
                placed_bytes += sum(c["nbytes"]
                                    for c in self._recs[self._cold[j]]["chunks"])
                with self._cond:
                    self._results[self._cold[j]] = leaf
                    self._cond.notify_all()
                flight.emit_near(self.directory, "place.waterline",
                                 array=len(self._results),
                                 arrays=len(self._recs), bytes=placed_bytes,
                                 tail=True)
            ok = True
        except BaseException as exc:  # noqa: BLE001 — surfaced by wait()
            with self._cond:
                self._err = exc
                self._cond.notify_all()
        finally:
            self.tail_s = time.monotonic() - t0
            flight.emit_near(self.directory, "postcopy.tail.end",
                             arrays=len(self._cold), ok=ok,
                             tail_s=round(self.tail_s, 4))
            with self._cond:
                self._done = True
                self._cond.notify_all()

    def _array_ready(self, j: int) -> bool:
        """Every chunk cold array ``j``'s slice reads appears staged (a
        hint)."""
        i = self._cold[j]
        rec = self._recs[i]
        for chunk in _chunks_for(rec, _want(self._leaves[i], rec,
                                            self._layouts[i])):
            d = self.directory
            if chunk.get("ref_dir"):
                d = os.path.normpath(os.path.join(d, chunk["ref_dir"]))
            if not self._monitor.ready_hint(os.path.join(d, chunk["file"]),
                                            chunk["offset"] + chunk["nbytes"]):
                return False
        return True

    def _pick_ready(self, pending: list[int]) -> int:
        """Readiness order: poll briefly for a pending array whose bytes
        have landed; when none has, the head, whose gated read waits for
        exactly the bytes it needs (and raises on a failed stage)."""
        if self._monitor is None:
            return pending[0]
        deadline = time.monotonic() + 2.0
        while time.monotonic() < deadline:
            for j in pending:
                if self._array_ready(j):
                    return j
            time.sleep(0.05)
        return pending[0]

    def wait(self, timeout: float | None = None) -> Any:
        """Block until every cold array is placed; returns the restored
        tree, leaf types as :func:`restore_snapshot` gives them. A tail
        that failed on the snapshot's bytes (a failed or torn stage, an
        OSError, an injected ``restore.postcopy_fault``) falls back, with
        a warning, to a bounded loop of the blocking restore: after a
        stage failure the agent re-stages the tree underneath it. Any
        other error is raised."""
        if timeout is None:
            timeout = _stage_timeout()
        deadline = time.monotonic() + timeout
        with self._cond:
            while not self._done:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    raise TimeoutError(
                        f"post-copy tail still placing after {timeout:.0f}s "
                        f"({len(self._results)}/{len(self._recs)} arrays)")
                self._cond.wait(min(1.0, remaining))
            err = self._err
        if err is not None:
            if isinstance(err, (SnapshotIntegrityError, OSError,
                                faults.FaultInjected)):
                log.warning("post-copy tail failed (%s: %s); falling back to "
                            "the blocking restore", type(err).__name__, err)
                return self._blocking_fallback(deadline)
            raise err
        _record_restore(self._recs, self._t0)
        out = iter([self._results[i] for i in range(len(self._recs))])
        return map_with_names(lambda _name, _leaf: next(out), self._like)

    def _blocking_fallback(self, deadline: float) -> Any:
        """The blocking restore, retried until the stage deadline: each
        attempt fails loudly until the re-staged tree is whole, and never
        hands over partial state."""
        while True:
            try:
                return restore_snapshot(self.directory, like=self._like,
                                        device=self._device,
                                        verify=self._verify, mesh=self._mesh,
                                        shardings=self._shardings)
            except (SnapshotIntegrityError, OSError) as exc:
                if time.monotonic() > deadline:
                    raise SnapshotIntegrityError(
                        "post-copy fallback could not complete a blocking "
                        f"restore before the stage deadline: {exc}") from exc
                time.sleep(0.5)


class _PinnedBlocks:
    """The restore's pinned staging: blocks of ``_PIECE_BYTES`` that
    readers read arrays straight into, each pinned when a reader first
    needs it, at most ``cap`` of them — so pinning runs beside the reads
    already under way, and a restore pins only as many blocks as its
    readers hold at once. A reader reserves a whole array's blocks, and
    readers reserve in array order, so the array the caller places next
    always gets its blocks while later ones wait; the caller returns them
    once that array's copies to the device have completed (an event).
    :meth:`abort` wakes every waiter with an error."""

    def __init__(self, cap: int) -> None:
        self.cap = cap
        self.tensors: list[torch.Tensor] = []  # by block id, pinned so far
        self.host: list[np.ndarray] = []       # the same bytes, as numpy
        self.pin_s = 0.0
        self._free: list[int] = []
        self._turn = 0
        self._aborted = False
        self._cond = threading.Condition()

    def reserve(self, order: int, need: int) -> list[int]:
        """``need`` blocks for the array at ``order`` (every array takes
        its turn, with ``need`` 0 when it reads elsewhere; ``need`` is at
        most ``cap``). On its turn a reader pins the blocks the free list
        lacks while the cap allows, else waits for the caller's release."""
        while True:
            with self._cond:
                while not self._aborted and self._turn != order:
                    self._cond.wait()
                if self._aborted:
                    raise RuntimeError("restore aborted")
                if len(self._free) >= need:
                    blocks, self._free = self._free[:need], self._free[need:]
                    self._turn += 1
                    self._cond.notify_all()
                    return blocks
                if len(self.tensors) >= self.cap:
                    self._cond.wait()
                    continue
            # Only the reader whose turn it is pins, outside the lock, so a
            # release never waits on it.
            t0 = time.perf_counter()
            block = _pinned(_PIECE_BYTES)
            with self._cond:
                self.pin_s += time.perf_counter() - t0
                self._free.append(len(self.tensors))
                self.tensors.append(block)
                self.host.append(block.numpy())

    def release(self, blocks: list[int]) -> None:
        with self._cond:
            self._free.extend(blocks)
            self._cond.notify_all()

    def abort(self) -> None:
        with self._cond:
            self._aborted = True
            self._cond.notify_all()

    def pieces(self, blocks: list[int], nbytes: int, *, host: bool) -> list:
        """Views of ``blocks`` holding ``nbytes``, one a piece, as numpy
        (``host``) or as the pinned tensors."""
        of = self.host if host else self.tensors
        return [of[b][:m] for b, (_, m) in zip(blocks, _spans(nbytes))]


class _Placer:
    """Reads and places a restore's arrays. An array bound for a CUDA
    device in one chunk is read straight into pinned blocks and placed
    from them with asynchronous copies; any other target reads into host
    memory (a CPU target keeps that buffer). Reads run on the reader
    threads, places on the caller's thread in manifest order."""

    def __init__(self, recs: list[dict], leaves: list,
                 device: torch.device | None, layouts: list | None = None
                 ) -> None:
        self.recs = recs
        self.leaves = leaves
        self.targets = [
            (device if leaf.device.type == "meta" else leaf.device)
            if isinstance(leaf, torch.Tensor) else None for leaf in leaves]
        layouts = layouts or [None] * len(leaves)
        self.wants = [_want(leaf, rec, lay)
                      for rec, leaf, lay in zip(recs, leaves, layouts)]
        self.exact = [_exact_chunk(rec, want)
                      for rec, want in zip(recs, self.wants)]
        self.need = [
            -(-c["nbytes"] // _PIECE_BYTES)
            if t is not None and t.type == "cuda" and c is not None else 0
            for c, t in zip(self.exact, self.targets)]
        self.pool: _PinnedBlocks | None = None

    def open_pool(self, window: int) -> None:
        """Size the pinned blocks for ``window`` arrays in flight at once
        (read ahead or being placed): at most window × the largest array,
        as the reference bounds its host buffers, and never more than the
        state."""
        total = sum(self.need)
        if total:
            self.pool = _PinnedBlocks(min(total, window * max(self.need)))

    def read(self, i: int, directory: str, *, verify: bool,
             monitor: _StageMonitor | None, order: int | None = None):
        """Array ``i``'s bytes: its pinned blocks, or a CPU tensor.
        ``order``: its turn at the pinned blocks (by default ``i``: reads
        reserve in array order)."""
        if self.pool is not None:
            blocks = self.pool.reserve(i if order is None else order,
                                       self.need[i])
            if blocks:
                chunk = self.exact[i]
                try:
                    _read_chunk_into(directory, chunk, self.pool.pieces(
                        blocks, chunk["nbytes"], host=True),
                        verify=verify, monitor=monitor)
                except BaseException:
                    self.pool.release(blocks)
                    raise
                return blocks
        return _read_slice_host(directory, self.recs[i], self.wants[i],
                                verify=verify, monitor=monitor)

    def place(self, i: int, got, stream: "torch.cuda.Stream | None" = None):
        """Array ``i`` on its target, from what :meth:`read` returned.
        Pinned blocks are copied on the caller's current stream, or on
        ``stream`` once it has waited for the current one (the memory of
        the result is the current stream's), and released only after
        their copies have landed."""
        target = self.targets[i]
        leaf = self.leaves[i]
        if self.need[i]:
            rec = self.recs[i]
            out = torch.empty([b - a for a, b in self.wants[i]],
                              dtype=_NAME_DTYPES[rec["dtype"]], device=target)
            dst = out.reshape(-1).view(torch.uint8)
            current = torch.cuda.current_stream(target)
            if stream is None:
                stream = current
            else:
                stream.wait_stream(current)
            with torch.cuda.stream(stream):
                for (o, m), src in zip(_spans(dst.numel()), self.pool.pieces(
                        got, dst.numel(), host=False)):
                    dst[o:o + m].copy_(src, non_blocking=True)
                done = torch.cuda.Event()
                done.record(stream)
            done.synchronize()
            self.pool.release(got)
            return _like_shard(out, leaf)
        if isinstance(leaf, torch.Tensor):
            return _like_shard(got.to(target), leaf)
        if isinstance(leaf, (int, float)):
            return type(leaf)(got.item())
        return got

    def abort(self) -> None:
        if self.pool is not None:
            self.pool.abort()


def _restore_workers() -> int:
    """Reader threads of the restore: ``GRIT_TPU_RESTORE_WORKERS`` when
    set (negative clamps to 0, serial), else one per spare core up to
    ``_RESTORE_WINDOW`` and at least one — a reader overlaps its
    GIL-released read and crc with the caller's place even on one core."""
    configured = config.TPU_RESTORE_WORKERS.get_int()
    if configured != int(config.TPU_RESTORE_WORKERS.default):
        return max(0, configured)
    return max(1, min(_RESTORE_WINDOW, (os.cpu_count() or 1) - 1))


def _restore_leaves(directory: str, placer: _Placer, *, verify: bool,
                    monitor: _StageMonitor | None, seeded: int) -> list:
    """Read workers feed the in-order place; the legs are recorded
    (:func:`last_restore_pipeline`). With no workers the loop is serial,
    with the same gating and checks."""
    workers = _restore_workers() if config.RESTORE_PIPELINE.get_flag() else 0
    placer.open_pool(workers + 1)
    wall_t0 = time.monotonic()
    wall_unix_ns = time.time_ns()
    # Journal waits before this point (COMMIT/MANIFEST gating) are serial
    # blocking, not a leg of the pipeline.
    stage_wait0 = monitor.stage_wait_s if monitor is not None else 0.0
    leg_lock = threading.Lock()
    legs = {"read": 0.0, "place": 0.0}

    def timed_read(i: int):
        t0 = time.monotonic()
        try:
            return placer.read(i, directory, verify=verify, monitor=monitor)
        finally:
            with leg_lock:
                legs["read"] += time.monotonic() - t0

    n = len(placer.recs)
    placed_bytes = 0

    def timed_place(i: int, got):
        nonlocal placed_bytes
        t0 = time.monotonic()
        try:
            out = placer.place(i, got)
        finally:
            dt = time.monotonic() - t0
            legs["place"] += dt
            PLACE_CHUNK_SECONDS.observe(dt)
        # The place waterline: bytes resident on the device so far.
        placed_bytes += sum(c["nbytes"] for c in placer.recs[i]["chunks"])
        flight.emit_near(directory, "place.waterline", array=i + 1,
                         arrays=n, bytes=placed_bytes)
        return out

    flight.emit_near(directory, "place.start", arrays=n)
    place_ok = False
    try:
        out = _run_place(workers, n, timed_read, timed_place, placer.abort)
        place_ok = True
    finally:
        # Closed on a failed restore too, or the open interval swallows
        # the rest of the window.
        flight.emit_near(directory, "place.end", arrays=n,
                         bytes=placed_bytes, ok=place_ok)
    wall = time.monotonic() - wall_t0
    stage_wait = (max(0.0, monitor.stage_wait_s - stage_wait0)
                  if monitor is not None else 0.0)
    pool = placer.pool
    pin = pool.pin_s if pool is not None else 0.0
    # Reads include their stage waits and the pinning of their blocks.
    read = max(0.0, legs["read"] - stage_wait - pin)
    serial = stage_wait + pin + read + legs["place"]
    overlap = max(0.0, min(1.0, 1.0 - wall / serial)) if serial > 0 else 0.0
    # The reference's legs: its read holds what the port times as pin.
    RESTORE_PIPELINE_SECONDS.inc(stage_wait, phase="stage_wait")
    RESTORE_PIPELINE_SECONDS.inc(read + pin, phase="read")
    RESTORE_PIPELINE_SECONDS.inc(legs["place"], phase="place")
    RESTORE_OVERLAP_FRACTION.set(overlap)
    trace.record_span("restore_pipeline", wall_unix_ns,
                      stage_wait=round(stage_wait, 4), read=round(read + pin, 4),
                      place=round(legs["place"], 4), wall=round(wall, 4),
                      overlap_fraction=round(overlap, 4),
                      pipelined=workers > 0, streamed=monitor is not None)
    with _RECORD_LOCK:
        _LAST_RESTORE.clear()
        _LAST_RESTORE.update(
            stage_wait=stage_wait, pin=pin, read=read, place=legs["place"],
            wall=wall, overlap_fraction=overlap,
            pipelined=workers > 0, workers=workers,
            streamed=monitor is not None,
            bytes=sum(c["nbytes"] for rec in placer.recs
                      for c in rec["chunks"]),
            pinned_blocks=len(pool.tensors) if pool is not None else 0,
            seeded=seeded,
            staging=(f"readers into pinned blocks of {_PIECE_BYTES >> 20} "
                     f"MiB pinned on first need ({len(pool.tensors)} of at "
                     f"most {pool.cap}), H2D on the caller's stream"
                     if pool is not None else "host"))
    return out


def _run_place(workers: int, n: int, timed_read, timed_place, abort) -> list:
    """The read → place loop: serial, or ``workers`` readers up to
    ``workers + 1`` arrays ahead of the in-order place (one more than the
    readers, so a read is in flight while this thread places). On an
    error, ``abort`` releases readers blocked on the placer before the
    pool is joined."""
    out: list = []
    if workers == 0 or n <= 1:
        for i in range(n):
            out.append(timed_place(i, timed_read(i)))
        return out
    window = workers + 1
    # The readers join the restore's trace.
    read = trace.wrap_parented(timed_read)
    with ThreadPoolExecutor(max_workers=workers) as pool:
        futures: dict[int, Any] = {}
        try:
            for i in range(n):
                for j in range(i, min(i + window, n)):
                    if j not in futures:
                        futures[j] = pool.submit(read, j)
                out.append(timed_place(i, futures.pop(i).result()))
        except BaseException:
            abort()
            for fut in futures.values():
                fut.cancel()
            raise
    return out
