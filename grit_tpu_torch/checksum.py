"""CRC-32C, the chunk checksum of the JAX package's native IO plane.

A JAX snapshot written where ``libgritio`` is built records
``"algo": "crc32c"`` for its chunks (``grit_tpu/device/snapshot.py``).
This module verifies them with a C library of its own
(``grit_tpu_torch/csrc/crc32c.c``): SSE4.2's ``crc32`` instruction 8 bytes
at a time where ``cpuid`` has it, slicing-by-8 tables elsewhere
(:func:`path` says which ran). It is compiled at first use with the host
compiler into the build directory of the kernel libraries
(:func:`grit_tpu_torch.ops.build.build_dir`), named by a digest of its
source and flags, and never at import. A failed build raises
:class:`CRC32CUnavailable` with the compiler's output. ctypes releases
the GIL over every call.

:func:`plain_crc32c` is the table-driven plain version, byte by byte in
Python, that the tests hold the library to.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import subprocess
import threading
from pathlib import Path

import numpy as np

from grit_tpu_torch.ops import build

SOURCE = Path(__file__).resolve().parent / "csrc" / "crc32c.c"
COMPILER = "cc"  # the host compiler
POLY = 0x82F63B78  # Castagnoli, reflected


def _flags() -> list[str]:
    flags = ["-O3", "-fPIC", "-shared"]
    if platform.machine() in ("x86_64", "AMD64"):
        flags.insert(1, "-msse4.2")
    return flags


class CRC32CUnavailable(RuntimeError):
    """The crc32c library cannot be built or loaded here."""


_lock = threading.Lock()
_lib = None


def library_path() -> Path:
    """The library in the kernel build directory, named by a digest of
    the compiler flags and the source."""
    h = hashlib.sha256(" ".join(_flags()).encode())
    h.update(SOURCE.read_bytes())
    return build.build_dir() / f"libcrc32c-{h.hexdigest()[:16]}.so"


def _build(out: Path) -> None:
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.tmp-{os.getpid()}-{threading.get_ident()}")
    cmd = [COMPILER, *_flags(), "-o", str(tmp), str(SOURCE)]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    except OSError as exc:
        raise CRC32CUnavailable(f"cannot run the host compiler {COMPILER!r} "
                                f"to build {SOURCE.name}: {exc}") from exc
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise CRC32CUnavailable(
            f"{' '.join(cmd)} failed (rc {proc.returncode}):\n"
            f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)  # atomic: concurrent builds race harmlessly


def library():
    """The loaded library, built first if this checkout's is missing."""
    global _lib
    with _lock:
        if _lib is None:
            out = library_path()
            if not out.exists():
                _build(out)
            try:
                lib = ctypes.CDLL(str(out))
            except OSError as exc:
                raise CRC32CUnavailable(f"{out} does not load: {exc}") from exc
            lib.grit_crc32c.argtypes = [ctypes.c_uint32, ctypes.c_void_p,
                                        ctypes.c_size_t]
            lib.grit_crc32c.restype = ctypes.c_uint32
            lib.grit_crc32c_hw.argtypes = []
            lib.grit_crc32c_hw.restype = ctypes.c_int
            lib.grit_crc32c_force_table.argtypes = [ctypes.c_int]
            lib.grit_crc32c_force_table.restype = None
            _lib = lib
        return _lib


def _bytes_of(data) -> np.ndarray:
    """``data``'s bytes as a flat uint8 array without a copy (a numpy array
    of any dtype, or any object with the buffer protocol)."""
    if isinstance(data, np.ndarray):
        if not data.flags.c_contiguous:
            raise ValueError("crc32c needs a C-contiguous array")
        return data.reshape(-1).view(np.uint8)
    return np.frombuffer(data, dtype=np.uint8)


def crc32c(data, crc: int = 0) -> int:
    """CRC-32C of ``data``, continuing from ``crc`` (the finished CRC of the
    bytes before it, as ``zlib.crc32`` takes it)."""
    arr = _bytes_of(data)
    return int(library().grit_crc32c(crc & 0xFFFFFFFF, arr.ctypes.data,
                                     arr.nbytes))


def path() -> str:
    """Which path the library runs on this host: ``"sse4.2"`` or
    ``"table"``."""
    return "sse4.2" if library().grit_crc32c_hw() else "table"


def force_table(on: bool) -> None:
    """Run the table path even where the hardware path is available (the
    tests hold both paths to the plain version)."""
    library().grit_crc32c_force_table(1 if on else 0)


_PLAIN_TABLE: list[int] = []


def plain_crc32c(data, crc: int = 0) -> int:
    """The plain version: one 256-entry table, one byte at a time."""
    if not _PLAIN_TABLE:
        for n in range(256):
            c = n
            for _ in range(8):
                c = (c >> 1) ^ POLY if c & 1 else c >> 1
            _PLAIN_TABLE.append(c)
    table = _PLAIN_TABLE
    c = ~crc & 0xFFFFFFFF
    for b in _bytes_of(data).tobytes():
        c = table[(c ^ b) & 0xFF] ^ (c >> 8)
    return ~c & 0xFFFFFFFF
