"""The port's copy of the snapshot-format constants and file helpers.

Counterpart of the parts of ``grit_tpu/metadata.py`` the device snapshot
needs: the format tag, the streamed-staging journal's name, the
crash-atomic small-file write, the whole-file crc32 and the chunk-stream
signature a mirror COMMIT records, and the flight log's name.
"""

from __future__ import annotations

import json
import os
import zlib

# First line of every snapshot COMMIT sentinel and the manifest's
# "format" field; the JAX package reads and writes the same tag.
SNAPSHOT_FORMAT = "grit-tpu-snapshot-v1"

# Streamed-staging journal at the staging destination root, written by the
# restore agent's chunk-streamed transfer and tailed by the restore
# pipeline: one JSON line per staged file or per contiguous-byte waterline
# advance, then a terminal ``{"complete": true}`` or ``{"failed": msg}``.
STAGE_JOURNAL_FILE = ".grit-stage-journal"


def atomic_write_text(path: str, data: str) -> None:
    """Crash-atomic small-file write: tmp + fsync + rename. A reader sees
    the old content or the new, never a torn file. The tmp name is
    pid-qualified so concurrent writers never share a staging file."""
    tmp = f"{path}.tmp-{os.getpid()}"
    try:
        with open(tmp, "w", encoding="utf-8") as f:
            f.write(data)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise


def atomic_write_json(path: str, obj, **dump_kw) -> None:
    atomic_write_text(path, json.dumps(obj, **dump_kw))


def crc32_file(path: str) -> int:
    """Whole-file crc32 in bounded windows (small metadata files)."""
    h = 0
    with open(path, "rb") as f:
        while buf := f.read(1 << 20):
            h = zlib.crc32(buf, h)
    return h & 0xFFFFFFFF


def chunk_stream_signature(chunks) -> int:
    """Order-sensitive signature of a snapshot data file's chunk stream:
    each chunk's ``(crc, nbytes)`` folded into one crc32. The dump side
    derives it from the chunks it appended, the upload-skip side from
    ``MANIFEST.json``, so "mirror bytes == source bytes" is verified from
    metadata alone. ``chunks``: ``(crc, nbytes)`` pairs in file order."""
    sig = 0
    for crc, nbytes in chunks:
        sig = zlib.crc32(f"{crc}:{nbytes};".encode(), sig)
    return sig & 0xFFFFFFFF


def manifest_data_file_signature(manifest: dict, filename: str) -> int:
    """:func:`chunk_stream_signature` recomputed from a parsed
    ``MANIFEST.json`` for one physical data file; reference chunks
    (``ref_dir``) hold no bytes here and are left out."""
    pairs = []
    for rec in manifest.get("arrays", []):
        for c in rec.get("chunks", []):
            if c.get("file") == filename and not c.get("ref_dir"):
                pairs.append(
                    (c["offset"], c.get("crc", c.get("crc32")), c["nbytes"]))
    pairs.sort(key=lambda t: t[0])
    return chunk_stream_signature((crc, n) for _, crc, n in pairs)


# Per-migration flight-recorder log (grit_tpu_torch.obs.flight): one JSONL
# phase-boundary event per line, appended by every process on the
# migration path, in the agent work/stage dir. Node-local: never shipped
# with the checkpoint.
FLIGHT_LOG_FILE = ".grit-flight.jsonl"
