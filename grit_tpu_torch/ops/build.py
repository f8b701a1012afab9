"""Build and load the port's CUDA kernels from ``ops/csrc`` at first use.

Each ``.cu`` source is compiled by ``nvcc`` for ``sm_90a`` into its own
shared library with a plain C interface, loaded with ``ctypes``; no
PyTorch header is involved, so a build takes seconds. All missing
libraries are compiled at once, one ``nvcc`` process per source. A
library is named by a digest of its sources and flags, so an edited
kernel is rebuilt and an unchanged one is reused from the build
directory (listed in ``.gitignore``). A failed build raises; nothing
falls back to another implementation.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
SOURCES = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")
NVCC_FLAGS = (
    "-gencode=arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_lock = threading.Lock()
_fns: dict = {}  # stem -> loaded C entry point (the process holds the .so)


class KernelBuildError(RuntimeError):
    pass


def nvcc_path() -> str:
    from torch.utils.cpp_extension import CUDA_HOME  # noqa: PLC0415

    cand = os.path.join(CUDA_HOME, "bin", "nvcc") if CUDA_HOME else None
    path = cand if cand and os.path.isfile(cand) else shutil.which("nvcc")
    if path is None:
        raise KernelBuildError("nvcc not found (set CUDA_HOME)")
    return path


def library_path(stem: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{stem}.cu"]:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"lib{stem}-{h.hexdigest()[:16]}.so"


def build_all() -> dict[str, Path]:
    """Compile every kernel library that is not built yet, in parallel.
    Returns ``{stem: library path}``. The ptxas report (registers,
    shared memory, spills) of each compile is kept beside the library as
    ``<stem>.ptxas.log``."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
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
        (BUILD_DIR / f"{stem}.ptxas.log").write_text(log)
        if proc.returncode != 0:
            failed.append(f"{stem}.cu (rc {proc.returncode}):\n{log}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, out)
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
            lib = ctypes.CDLL(str(build_all()[stem]))
            name, argtypes = _ARGTYPES[stem]
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
            _fns[stem] = fn
        return _fns[stem]
