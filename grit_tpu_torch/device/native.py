"""The node's native device seams of a GPU pod, built at first use.

Two C programs of the port, the counterparts of the JAX package's
``tpu-checkpoint`` CLI and CRIU TPU plugin:

- ``csrc/gpu_checkpoint.c`` → ``gpu-checkpoint``: the toggle CLI (the role
  NVIDIA's ``cuda-checkpoint`` plays for a CRIU plugin) with the reference
  CLI's flags, replies and exit codes, over the agentlet's socket;
- ``csrc/criu_gpu_plugin.c`` (with the port's own ``criu_plugin_api.h``) →
  ``grit_gpu_plugin.so``: a CRIU plugin whose device hooks exec that CLI,
  and which refuses an fd open on ``/dev/nvidia*`` rather than record it,
  since the CUDA context behind it cannot be reopened by path: the device
  state travels in the agentlet's snapshot.

:func:`cli_path` and :func:`plugin_path` compile each with the host
compiler into the kernels' build directory
(:func:`grit_tpu_torch.ops.build.build_dir`), named by a digest of the
flags and of every source that goes into it, and never at import. A
failed build raises :class:`NativeBuildError` with the compiler's output;
nothing falls back to another binary.

Arm a node with them: ``GRIT_TPU_CHECKPOINT_BIN=$(python -c "from
grit_tpu_torch.device import native; print(native.cli_path())")`` in
CRIU's environment, and the plugin's path in CRIU's plugin directory.
"""

from __future__ import annotations

import hashlib
import os
import subprocess
import threading
from pathlib import Path

from grit_tpu_torch.ops import build

CSRC = Path(__file__).resolve().parent.parent / "csrc"
COMPILER = "cc"  # the host compiler
CLI_SOURCES = ("gpu_checkpoint.c",)
PLUGIN_SOURCES = ("criu_gpu_plugin.c", "criu_plugin_api.h")
CLI_FLAGS = ("-O2", "-std=c11", "-D_GNU_SOURCE", "-Wall")
PLUGIN_FLAGS = ("-O2", "-std=c11", "-D_GNU_SOURCE", "-Wall", "-fPIC",
                "-shared")
# The plugin's exported path classifier (int (*)(const char *)).
CLASSIFIER = "grit_gpu_is_nvidia_device"


class NativeBuildError(RuntimeError):
    """A native seam cannot be built here."""


_lock = threading.Lock()


def _output(stem: str, sources: tuple[str, ...], flags: tuple[str, ...],
            suffix: str) -> Path:
    h = hashlib.sha256(" ".join(flags).encode())
    for name in sources:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    return build.build_dir() / f"{stem}-{h.hexdigest()[:16]}{suffix}"


def _build(out: Path, sources: tuple[str, ...], flags: tuple[str, ...]) -> Path:
    with _lock:
        if out.exists():
            return out
        out.parent.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(
            f"{out.name}.tmp-{os.getpid()}-{threading.get_ident()}")
        cmd = [COMPILER, *flags, "-I", str(CSRC), "-o", str(tmp),
               *(str(CSRC / s) for s in sources if s.endswith(".c"))]
        try:
            proc = subprocess.run(cmd, capture_output=True, text=True,
                                  timeout=300)
        except OSError as exc:
            raise NativeBuildError(
                f"cannot run the host compiler {COMPILER!r} to build "
                f"{out.name}: {exc}") from exc
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise NativeBuildError(
                f"{' '.join(cmd)} failed (rc {proc.returncode}):\n"
                f"{proc.stdout}{proc.stderr}")
        os.replace(tmp, out)  # atomic: concurrent builds race harmlessly
        return out


def cli_path() -> str:
    """The ``gpu-checkpoint`` CLI of this checkout, built first if missing."""
    out = _output("gpu-checkpoint", CLI_SOURCES, CLI_FLAGS, "")
    return str(_build(out, CLI_SOURCES, CLI_FLAGS))


def plugin_path() -> str:
    """The CRIU plugin of this checkout, built first if missing."""
    out = _output("grit_gpu_plugin", PLUGIN_SOURCES, PLUGIN_FLAGS, ".so")
    return str(_build(out, PLUGIN_SOURCES, PLUGIN_FLAGS))
