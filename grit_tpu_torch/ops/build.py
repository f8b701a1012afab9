"""Build and load the port's CUDA kernels from ``ops/csrc`` at first use.

Each ``.cu`` source is compiled by ``nvcc`` for ``sm_90a`` into its own
shared library with a plain C interface, loaded with ``ctypes``; no
PyTorch header is involved, so a build takes seconds. All missing
libraries are compiled at once, one ``nvcc`` process per source. A
library is named by a digest of its sources and flags, so an edited
kernel is rebuilt and an unchanged one is reused from the build
directory: ``GRIT_TPU_COMPILE_CACHE`` when set, else the package's
``_build`` (listed in ``.gitignore``). A failed build, or a library that
does not load, raises; nothing falls back to another implementation.

With ``GRIT_TPU_COMPILE_CACHE`` set, the libraries travel with every
snapshot, under ``compile-cache/``: the snapshot writer carries them after
its commit (:func:`save_compile_cache`) and a restore seeds the directory
from them before anything can build (:func:`seed_compile_cache`), so a
destination node runs no ``nvcc``. Only the libraries of this checkout's
sources are carried and seeded, and a library is loaded only under its
own digest name, so one built from other sources is never loaded: the
build then compiles as it would have.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import uuid
from pathlib import Path

from grit_tpu_torch.api import config

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"  # the default
SOURCES = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")
# Subdirectory of a snapshot that carries the kernel libraries.
COMPILE_CACHE_SUBDIR = "compile-cache"
NVCC_FLAGS = (
    "-gencode=arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_lock = threading.Lock()
_fns: dict = {}  # stem -> loaded C entry point (the process holds the .so)
# What this process did: the stems it compiled, and the library each
# loaded stem came from (a workload prints both).
BUILT: list[str] = []
LOADED: dict[str, str] = {}


class KernelBuildError(RuntimeError):
    pass


def nvcc_path() -> str:
    from torch.utils.cpp_extension import CUDA_HOME  # noqa: PLC0415

    cand = os.path.join(CUDA_HOME, "bin", "nvcc") if CUDA_HOME else None
    path = cand if cand and os.path.isfile(cand) else shutil.which("nvcc")
    if path is None:
        raise KernelBuildError("nvcc not found (set CUDA_HOME)")
    return path


def build_dir() -> Path:
    """``GRIT_TPU_COMPILE_CACHE`` when set, else :data:`BUILD_DIR`."""
    d = config.TPU_COMPILE_CACHE.get()
    return Path(d) if d else BUILD_DIR


def library_path(stem: str) -> Path:
    """The library of ``stem`` in :func:`build_dir`, named by a digest of
    the flags and of every source that goes into it."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{stem}.cu"]:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return build_dir() / f"lib{stem}-{h.hexdigest()[:16]}.so"


def _copy_missing(src_dir: str, dst_dir: str) -> int:
    """Copy this checkout's libraries (by digest name) that ``src_dir``
    holds and ``dst_dir`` lacks; returns the count. Atomic per file: a kill
    mid-copy must not leave a truncated library that the existence check
    would then keep (and later dumps carry)."""
    copied = 0
    for name in (library_path(stem).name for stem in SOURCES):
        src, dst = os.path.join(src_dir, name), os.path.join(dst_dir, name)
        if os.path.exists(dst) or not os.path.exists(src):
            continue
        os.makedirs(dst_dir, exist_ok=True)
        tmp = f"{dst}.tmp-{uuid.uuid4().hex[:12]}"
        shutil.copyfile(src, tmp)
        os.replace(tmp, dst)
        copied += 1
    return copied


def save_compile_cache(snapshot_dir: str) -> int:
    """Carry the libraries of ``GRIT_TPU_COMPILE_CACHE`` into
    ``<snapshot_dir>/compile-cache/``. Returns the files copied; 0 with the
    knob unset."""
    src = config.TPU_COMPILE_CACHE.get()
    if not src or not os.path.isdir(src):
        return 0
    return _copy_missing(src, os.path.join(snapshot_dir, COMPILE_CACHE_SUBDIR))


def seed_compile_cache(snapshot_dir: str) -> int:
    """Seed ``GRIT_TPU_COMPILE_CACHE`` with the libraries a snapshot
    carries. Returns the files copied; 0 with the knob unset or nothing
    carried."""
    local = config.TPU_COMPILE_CACHE.get()
    carried = os.path.join(snapshot_dir, COMPILE_CACHE_SUBDIR)
    if not local or not os.path.isdir(carried):
        return 0
    return _copy_missing(carried, local)


def build_all() -> dict[str, Path]:
    """Compile every kernel library that is not built yet, in parallel.
    Returns ``{stem: library path}``. The ptxas report (registers,
    shared memory, spills) of each compile is kept beside the library as
    ``<stem>.ptxas.log``."""
    out_dir = build_dir()
    out_dir.mkdir(parents=True, exist_ok=True)
    paths = {stem: library_path(stem) for stem in SOURCES}
    todo = {stem: p for stem, p in paths.items() if not p.exists()}
    if not todo:
        return paths
    nvcc = nvcc_path()
    procs = {}
    for stem, out in todo.items():
        tmp = out.with_name(f"{out.name}.tmp-{os.getpid()}")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{stem}.cu")]
        procs[stem] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    failed = []
    for stem, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        (out_dir / f"{stem}.ptxas.log").write_text(log)
        if proc.returncode != 0:
            failed.append(f"{stem}.cu (rc {proc.returncode}):\n{log}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, out)
            BUILT.append(stem)
    if failed:
        raise KernelBuildError("nvcc failed for " + "\n".join(failed))
    return paths


# C signatures: pointers and the stream are c_void_p (a c_int would cut
# a 64-bit pointer), shapes c_int, the softmax scale c_float.
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_ARGTYPES = {
    "flash_fwd": ("grit_flash_fwd", [_P] * 5 + [_I] * 4 + [_F, _P]),
    "flash_bwd_dq": ("grit_flash_bwd_dq", [_P] * 7 + [_I] * 4 + [_F, _P]),
    "flash_bwd_dkv": ("grit_flash_bwd_dkv", [_P] * 8 + [_I] * 4 + [_F, _P]),
}


def kernel(stem: str):
    """The C entry point of one kernel library, building all libraries
    first if needed."""
    with _lock:
        if stem not in _fns:
            path = build_all()[stem]
            try:
                lib = ctypes.CDLL(str(path))
            except OSError as exc:
                raise KernelBuildError(f"{path} does not load: {exc}") from exc
            LOADED[stem] = path.name
            name, argtypes = _ARGTYPES[stem]
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
            _fns[stem] = fn
        return _fns[stem]
