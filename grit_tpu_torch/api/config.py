"""The port's knob registry: only the environment knobs this package reads.

Counterpart of ``grit_tpu/api/config.py``. The names are wire/env
contracts shared with the unchanged node agent, shim and control plane,
so they keep the reference's spelling.
"""

from __future__ import annotations

import logging
import os
from dataclasses import dataclass

log = logging.getLogger(__name__)


@dataclass(frozen=True)
class Knob:
    """One declared string knob; every read goes to ``os.environ``.

    The typed reads follow the reference registry's policy: an empty value
    counts as unset, a malformed number logs a warning and reads as the
    default, and a flag is on unless it is ``"0"``."""

    name: str
    default: str
    help: str

    def get(self) -> str:
        return self._raw()

    def _raw(self) -> str:
        return os.environ.get(self.name) or self.default

    def get_int(self) -> int:
        return int(self._number(int))

    def get_float(self) -> float:
        return float(self._number(float))

    def get_flag(self) -> bool:
        return self._raw() != "0"

    def _number(self, kind):
        raw = self._raw()
        try:
            return kind(raw)
        except ValueError:
            log.warning("%s=%r is not a valid %s; using default %r",
                        self.name, raw, kind.__name__, self.default)
            return kind(self.default)


TPU_SOCKET_DIR = Knob(
    "GRIT_TPU_SOCKET_DIR", "/tmp",
    "Directory of the per-pid agentlet toggle sockets "
    "(grit-tpu-<pid>.sock) shared by workload and agent.")
TPU_RESTORE_DIR = Knob(
    "GRIT_TPU_RESTORE_DIR", "",
    "HBM snapshot dir to restore from; injected by the shim on "
    "restore-mode creates.")
SERVE_DRAIN_MODE = Knob(
    "GRIT_SERVE_DRAIN_MODE", "serialize",
    "Request-drain policy the serving agentlet applies when a quiesce "
    "lands: 'serialize' (default) parks at the next batch boundary and "
    "ships in-flight slots' KV/position state inside the snapshot; "
    "'drain' keeps decoding admitted requests to completion (EOS/"
    "length) before parking — bounded by GRIT_SERVE_DRAIN_TIMEOUT_S. "
    "Unknown values degrade to 'serialize' loudly.")
SERVE_DRAIN_TIMEOUT_S = Knob(
    "GRIT_SERVE_DRAIN_TIMEOUT_S", "30.0",
    "Ceiling, in seconds, on the 'drain' policy's run-to-completion "
    "window. Expiry raises ServingDrainTimeout out of the serving loop — "
    "a drain that cannot finish must fail the migration attempt loudly, "
    "never silently serialize or park a half-drained batch.")
MIRROR_MAX_INFLIGHT_MB = Knob(
    "GRIT_MIRROR_MAX_INFLIGHT_MB", "256",
    "Bound on in-flight BYTES queued between the snapshot dump and its "
    "mirror tee (MiB). Backpressure is by bytes, not item count.")
TPU_STAGE_TIMEOUT_S = Knob(
    "GRIT_TPU_STAGE_TIMEOUT_S", "900",
    "How long a restore waits for streamed-stage bytes that never arrive "
    "(no progress, no terminal journal line) before failing loud.")
RESTORE_PIPELINE = Knob(
    "GRIT_RESTORE_PIPELINE", "1",
    "Pipelined (read/place overlapped) restore data path; =0 forces the "
    "serial fallback.")
TPU_RESTORE_WORKERS = Knob(
    "GRIT_TPU_RESTORE_WORKERS", "-1",
    "Read-ahead worker threads on the restore path; -1 (unset) sizes "
    "from the host's cores, 0 disables read-ahead.")
SNAPSHOT_CODEC = Knob(
    "GRIT_SNAPSHOT_CODEC", "none",
    "Chunk codec of the snapshot's transport (wire frames and the mirror "
    "tee's container format): 'none', 'zlib', or 'zstd' (degrades to zlib "
    "with a loud warning when the zstandard module is absent; unknown "
    "values degrade to none). Compression is adaptive per chunk; see "
    "GRIT_CODEC_MIN_RATIO.")
CODEC_WORKERS = Knob(
    "GRIT_CODEC_WORKERS", "-1",
    "Bounded codec worker-pool size (compression on the dump side); -1 "
    "(unset) sizes from the host's cores.")
CODEC_MIN_RATIO = Knob(
    "GRIT_CODEC_MIN_RATIO", "0.9",
    "Adaptive raw-ship threshold: a chunk whose sample compresses to more "
    "than this fraction of its raw size ships uncompressed.")
CODEC_SAMPLE_KB = Knob(
    "GRIT_CODEC_SAMPLE_KB", "64",
    "KiB of each chunk sample-compressed to decide between compression "
    "and raw-ship.")
WIRE_IFACES = Knob(
    "GRIT_WIRE_IFACES", "",
    "Comma-separated network interface names for multi-NIC striping: "
    "wire stream k is pinned (SO_BINDTODEVICE) to iface k mod N before it "
    "dials. A refused pin logs loudly and the stream dials unpinned. "
    "Unset: no pinning.")
TPU_COMPILE_CACHE = Knob(
    "GRIT_TPU_COMPILE_CACHE", "",
    "Directory the CUDA kernel libraries are built into and loaded from "
    "(default: the package's git-ignored _build). When set, every "
    "snapshot carries its libraries under compile-cache/, and a restore "
    "seeds this directory from the snapshot before the first kernel "
    "build.")
TPU_IMAGE_DIR = Knob(
    "GRIT_TPU_IMAGE_DIR", "",
    "Where the port's CRIU GPU plugin (csrc/criu_gpu_plugin.c) writes the "
    "device snapshot during a criu dump (its tpu/ subdirectory); unset, "
    "CRIU's image dir. Read by native code.")
TPU_CHECKPOINT_BIN = Knob(
    "GRIT_TPU_CHECKPOINT_BIN", "",
    "Path to the gpu-checkpoint toggle CLI (csrc/gpu_checkpoint.c, "
    "device/native.py's cli_path) the port's CRIU GPU plugin execs; unset, "
    "gpu-checkpoint on the PATH. Read by native code.")
SNAP_SPECULATE = Knob(
    "GRIT_SNAP_SPECULATE", "1",
    "Quiesce-free concurrent dump: a quiesce request that carries a dump "
    "spec starts the snapshot speculatively against a generation cloned "
    "at a step boundary while the loop still steps; the parked dump then "
    "re-ships only the leaves the steps since touched (validated delta). "
    "The node agent's pre-copy pass is then a non-parking probe. =0 "
    "restores the fully parked dump path.")
SNAP_SPECULATE_WAIT_S = Knob(
    "GRIT_SNAP_SPECULATE_WAIT_S", "120.0",
    "Bound on joining an in-flight speculative pass at dump time (and on "
    "waiting for the step boundary its clone is taken at); a pass that "
    "outlives it degrades loudly to the parked full dump (bit-identical "
    "either way).")
RESTORE_POSTCOPY = Knob(
    "GRIT_RESTORE_POSTCOPY", "0",
    "Post-copy (lazy) restore: the restored workload resumes once the "
    "manifest and the hot (small) arrays are placed, and the cold bulk is "
    "placed in the background in readiness order; the first touch of the "
    "state waits for it. =0 keeps the blocking restore.")
RESTORE_POSTCOPY_HOT_MB = Knob(
    "GRIT_RESTORE_POSTCOPY_HOT_MB", "8.0",
    "Per-array hot-set threshold of the post-copy restore: arrays of at "
    "most this many MB (scalars, norms, serving bookkeeping) are placed "
    "before the workload resumes; larger ones land through the tail. 0 "
    "sends every array to the tail.")
SLICE_HOSTS = Knob(
    "GRIT_SLICE_HOSTS", "0",
    "Host count of the slice an agent leg belongs to. 0/1 is the "
    "single-host flow; above 1 the device hook asks the workload for the "
    "gang cut: every host parks at the same agreed step boundary.")
SLICE_BARRIER_TIMEOUT_S = Knob(
    "GRIT_SLICE_BARRIER_TIMEOUT_S", "120.0",
    "Bound on the cross-host quiesce barrier: how long one host waits "
    "at the agreed cut step for every other host to arrive before the "
    "barrier fails loudly (the workload keeps training, the quiesce "
    "fails, and the gang aborts) instead of parking a partial slice.")
SLICE_POLL_S = Knob(
    "GRIT_SLICE_POLL_S", "0.2",
    "Poll period of the file rendezvous' barrier and allgather waits "
    "(shared-filesystem coordination).")
SLICE_NONCE = Knob(
    "GRIT_SLICE_NONCE", "",
    "Attempt namespace for the gang's rendezvous names (the manager "
    "stamps the attempt count into every per-host agent Job), so a "
    "retried gang never meets a failed attempt's leftover arrivals. "
    "Empty = attempt 0.")

# -- observability and fault injection --------------------------------------------

TPU_TRACE_FILE = Knob(
    "GRIT_TPU_TRACE_FILE", "",
    "JSONL span sink enabling the tracing layer (unset: tracing off).")
FLIGHT = Knob(
    "GRIT_FLIGHT", "0",
    "Per-migration flight recorder (grit_tpu_torch.obs.flight): "
    "phase-boundary events appended crash-safe to .grit-flight.jsonl in the "
    "agent work/stage dir, analyzed by tools/gritscope. Default off.")
FLIGHT_DIR = Knob(
    "GRIT_FLIGHT_DIR", "",
    "Optional artifact tee for flight events: every event is also appended "
    "to <dir>/flight-<host>-<pid>.jsonl.")
FLIGHT_CLOCK = Knob(
    "GRIT_FLIGHT_CLOCK", "",
    "Manager-stamped wall/monotonic clock pair (JSON) in the agent Job env; "
    "echoed as a clock.manager flight event.")
WORKLOAD_METRICS_PORT = Knob(
    "GRIT_WORKLOAD_METRICS_PORT", "0",
    "Opt-in workload-side /metrics server: when set, the workload process "
    "(the agentlet's start, the restored process's prefetch) serves its own "
    "registry and starts the sampler. 0 (default) serves nothing.")
PROF_HZ = Knob(
    "GRIT_PROF_HZ", "25.0",
    "Sampling rate of the phase-scoped profiler (grit_tpu_torch.obs.profile): "
    "while a flight-recorded phase bracket is open, all threads are sampled "
    "at this rate and each sample is classified python/native/syscall/lock/"
    "idle; collapsed stacks land next to the flight log as "
    ".grit-prof-<phase>-p<pid>.folded. 0 disables sampling entirely.")
PROF_MAX_STACKS = Knob(
    "GRIT_PROF_MAX_STACKS", "512",
    "Unique-stack cardinality cap per profiled phase: beyond it, new stacks "
    "fold into one [overflow] bucket.")
OBS_SAMPLE_S = Knob(
    "GRIT_OBS_SAMPLE_S", "5.0",
    "Period of the observability sampler thread (grit_tpu_torch.obs.sampler): "
    "refreshes the codec queue depth, the resource ledger and the live "
    "migration progress gauges between events.")
TPU_GIT_SHA = Knob(
    "GRIT_TPU_GIT_SHA", "",
    "Build-time git sha override for the /version stamp (container images "
    "have no .git).")
FAULT_POINTS = Knob(
    "GRIT_FAULT_POINTS", "",
    "Fault-injection spec <point>:<mode>[:<arg>][:xN][,...] — see "
    "grit_tpu_torch.faults.")
