"""The port's copy of the snapshot-format constants and file helpers.

Counterpart of the parts of ``grit_tpu/metadata.py`` the device snapshot
needs: the format tag, the crash-atomic small-file write and the
whole-file crc32.
"""

from __future__ import annotations

import json
import os
import zlib

# First line of every snapshot COMMIT sentinel and the manifest's
# "format" field; the JAX package reads and writes the same tag.
SNAPSHOT_FORMAT = "grit-tpu-snapshot-v1"


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
