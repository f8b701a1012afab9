"""Device-state snapshot in the JAX package's on-disk format.

Counterpart of the core of ``grit_tpu/device/snapshot.py``: the same
self-describing directory, so a snapshot written by either package
restores through the other::

    <dir>.work/               everything is written here first
        MANIFEST.json         format tag, meta, per-array dtype/shape/chunks
        data-h0000.bin        the arrays' bytes, concatenated
        COMMIT                sentinel written last
    → renamed to <dir>        the atomic commit

Arrays are named by their ``jax.tree_util.keystr`` path
(:mod:`grit_tpu_torch.tree`), dtypes by numpy's names with ``bfloat16``
for bf16, and every array is one chunk with ``{"type": "replicated"}``
sharding. Chunk checksums are ``zlib.crc32`` (``"algo": "crc32"``). A
JAX-written snapshot whose chunks carry ``crc32c`` (the JAX package's
native IO plane) is refused with :class:`SnapshotIntegrityError`: this
package has no crc32c, and a chunk is never read unverified.

Delta dumps (``base=``), the mirror tee, the wire sink, staged and
post-copy restore and speculation belong to later slices of the port;
reading follows a JAX delta's ``ref_dir`` chunk references.
"""

from __future__ import annotations

import json
import os
import shutil
import zlib
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from typing import Any

import numpy as np
import torch

from grit_tpu_torch.device.placement import resolve_device
from grit_tpu_torch.metadata import (
    SNAPSHOT_FORMAT,
    atomic_write_json,
    atomic_write_text,
)
from grit_tpu_torch.tree import flatten_with_names, map_with_names

FORMAT = SNAPSHOT_FORMAT
MANIFEST_FILE = "MANIFEST.json"
COMMIT_FILE = "COMMIT"
WORK_SUFFIX = ".work"
DATA_FILE = "data-h0000.bin"
# Arrays in flight between the device copy and the disk (both ways):
# bounds host memory at about this many of the largest array.
_WINDOW = 2

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


class SnapshotIntegrityError(RuntimeError):
    """A snapshot's bytes cannot be trusted (checksum, size, coverage) or
    cannot be verified by this package."""


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


def _as_tensor(leaf) -> torch.Tensor:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach()
    return torch.as_tensor(np.asarray(leaf))


def _host_bytes(t: torch.Tensor) -> np.ndarray:
    """Device tensor → contiguous host bytes (uint8 view)."""
    t = t.contiguous().cpu()
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
    return t.numpy().reshape(-1).view(np.uint8)


def write_snapshot(directory: str, state: Any, *, meta: dict | None = None) -> str:
    """Serialize the tree ``state`` to ``directory`` atomically; returns it.

    Device→host copies of the next array overlap the checksum and file
    write of the current one (one writer thread). The caller quiesces
    first (:func:`grit_tpu_torch.device.quiesce.quiesce`) so the arrays
    are a consistent cut.

    The data file is not fsynced, as in the JAX package's default: every
    chunk is CRC-verified on restore, so a torn write is detected, and the
    upload to the checkpoint volume is the durability boundary — a
    multi-GB flush inside the blackout buys nothing. The manifest and
    COMMIT are fsynced before the rename that commits."""
    work = directory + WORK_SUFFIX
    old = directory + ".old"
    # Crash recovery: a leftover .old from a crash mid-commit holds the
    # previous committed snapshot — put it back before overwriting.
    if snapshot_exists(old) and not snapshot_exists(directory):
        shutil.rmtree(directory, ignore_errors=True)
        os.rename(old, directory)
    elif os.path.isdir(old):
        shutil.rmtree(old)
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)

    leaves = [(name, _as_tensor(leaf))
              for name, leaf in flatten_with_names(state)]
    records: list[dict] = []
    offset = 0
    with open(os.path.join(work, DATA_FILE), "wb") as f, \
            ThreadPoolExecutor(max_workers=1) as writer:

        def append(buf: np.ndarray) -> int:
            f.write(buf)
            return zlib.crc32(buf) & 0xFFFFFFFF

        pending = []
        for name, t in leaves:
            if len(pending) >= _WINDOW:
                pending[-_WINDOW].result()
            buf = _host_bytes(t)
            pending.append(writer.submit(append, buf))
            records.append({
                "name": name,
                "dtype": _DTYPE_NAMES[t.dtype],
                "shape": list(t.shape),
                "sharding": {"type": "replicated"},
                "chunks": [{
                    "file": DATA_FILE, "offset": offset,
                    "nbytes": int(buf.nbytes),
                    "index": [[0, int(d)] for d in t.shape],
                    "algo": "crc32",
                }],
            })
            offset += buf.nbytes
        for rec, fut in zip(records, pending):
            rec["chunks"][0]["crc"] = fut.result()

    atomic_write_json(os.path.join(work, MANIFEST_FILE), {
        "format": FORMAT, "process_count": 1, "meta": meta or {},
        "arrays": records,
    })
    atomic_write_text(os.path.join(work, COMMIT_FILE), FORMAT + "\n")
    if os.path.isdir(directory):
        os.rename(directory, old)
    os.rename(work, directory)
    shutil.rmtree(old, ignore_errors=True)
    return directory


def _read_chunk(directory: str, chunk: dict) -> np.ndarray:
    if chunk.get("ref_dir"):  # delta chunk: the bytes live in the base
        directory = os.path.normpath(os.path.join(directory, chunk["ref_dir"]))
    where = f"{chunk['file']}@{chunk['offset']}"
    algo = chunk.get("algo", "crc32")
    if algo != "crc32":
        raise SnapshotIntegrityError(
            f"chunk {where} carries a {algo!r} checksum, which this package "
            "cannot verify; re-dump with crc32 chunks")
    out = np.empty(chunk["nbytes"], dtype=np.uint8)
    with open(os.path.join(directory, chunk["file"]), "rb") as f:
        f.seek(chunk["offset"])
        got = f.readinto(memoryview(out))
    if got != chunk["nbytes"]:
        raise SnapshotIntegrityError(f"short read in {where}")
    if zlib.crc32(out) & 0xFFFFFFFF != chunk.get("crc", chunk.get("crc32")):
        raise SnapshotIntegrityError(f"crc mismatch in {where}")
    return out


def _read_array(directory: str, rec: dict) -> torch.Tensor:
    """One array's bytes from its chunks, as a CPU tensor."""
    dtype = _NAME_DTYPES.get(rec["dtype"])
    if dtype is None:
        raise SnapshotIntegrityError(f"array {rec['name']}: unsupported dtype "
                                     f"{rec['dtype']!r}")
    shape = list(rec["shape"])
    itemsize = torch.empty((), dtype=dtype).element_size()
    chunks = rec["chunks"]
    whole = [[0, d] for d in shape]
    if len(chunks) == 1 and chunks[0]["index"] == whole:
        raw = _read_chunk(directory, chunks[0])
        if raw.nbytes != itemsize * int(np.prod(shape, dtype=np.int64)):
            raise SnapshotIntegrityError(f"array {rec['name']}: size mismatch")
        return torch.from_numpy(raw).view(dtype).reshape(shape)
    # Sharded dump: reassemble from the chunks' global indices.
    full = torch.empty(shape, dtype=dtype)
    covered = torch.zeros(shape, dtype=torch.bool)
    for c in chunks:
        sl = tuple(slice(a, b) for a, b in c["index"])
        part_shape = [b - a for a, b in c["index"]]
        raw = _read_chunk(directory, c)
        full[sl] = torch.from_numpy(raw).view(dtype).reshape(part_shape)
        covered[sl] = True
    if not bool(covered.all()):
        raise SnapshotIntegrityError(
            f"array {rec['name']}: chunks leave uncovered elements")
    return full


def restore_snapshot(directory: str, *, like: Any = None,
                     device: torch.device | str | None = None) -> Any:
    """Load a committed snapshot.

    ``like``: a tree of the wanted structure. A tensor leaf on the meta
    device is loaded onto ``device``, by default the current CUDA device
    (with no GPU that raises: pass ``device="cpu"`` to restore onto the
    CPU); any other tensor leaf onto its own device; a Python int/float
    leaf comes back as that type. Dtypes and shapes must match the
    manifest. Without ``like`` the result is a flat ``{keystr name: CPU
    tensor}`` dict.

    Reading (and checksumming) the next array from disk overlaps the
    host→device copy of the current one."""
    if not snapshot_exists(directory):
        raise FileNotFoundError(
            f"{directory} has no {COMMIT_FILE}: snapshot missing or uncommitted")
    manifest = SnapshotManifest.load(directory)
    by_name = {rec["name"]: rec for rec in manifest.arrays}
    if like is None:
        names = list(by_name)
    else:
        leaves = flatten_with_names(like)
        names = [n for n, _ in leaves]
        missing = [n for n in names if n not in by_name]
        if missing:
            raise KeyError(f"snapshot {directory} lacks arrays: {missing[:5]}")
        if any(isinstance(x, torch.Tensor) and x.device.type == "meta"
               for _, x in leaves):
            device = resolve_device(device)

    def place(name: str, leaf, host: torch.Tensor):
        if isinstance(leaf, torch.Tensor):
            if host.dtype != leaf.dtype or list(host.shape) != list(leaf.shape):
                raise ValueError(
                    f"{name}: snapshot holds {host.dtype} {list(host.shape)}, "
                    f"want {leaf.dtype} {list(leaf.shape)}")
            return host.to(device if leaf.device.type == "meta" else leaf.device)
        if isinstance(leaf, (int, float)):
            return type(leaf)(host.item())
        return host

    with ThreadPoolExecutor(max_workers=1) as reader:
        arrays = _prefetch(
            reader, lambda n: _read_array(directory, by_name[n]), names)
        if like is None:
            return dict(zip(names, arrays))
        ordered = iter(arrays)
        return map_with_names(
            lambda name, leaf: place(name, leaf, next(ordered)), like)


def _prefetch(pool: ThreadPoolExecutor, fn, items: list):
    """``fn(item)`` for each item, in order, computed on ``pool`` up to
    ``_WINDOW`` items ahead of the consumer."""
    futs: deque = deque()
    for item in items:
        futs.append(pool.submit(fn, item))
        if len(futs) > _WINDOW:
            yield futs.popleft().result()
    while futs:
        yield futs.popleft().result()

