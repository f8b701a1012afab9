"""grit-tpu for PyTorch on CUDA: the port of :mod:`grit_tpu` to a Hopper GPU.

The JAX package stays the reference; this package imports ``torch`` and
never ``jax`` or anything of ``grit_tpu``. Module names mirror the JAX
package so each port module's counterpart is found at the same path.

What is ported: the llama training-and-migration path — three
hand-written CUDA flash-attention kernels (``ops``), the llama model
(``models.llama``), the trainer (``train.trainer``), the snapshot format
with delta dumps, the mirror tee and the staged, pipelined restore, the
agentlet and restore hook (``device``) and the migratable workload
(``workload``) — and serving: decode and the KV cache, the lock-step and
continuous-batching engines (``models.serving``) and the request-drain
serving agentlet (``serving``) — and the snapshot's transport: the
migration wire's source half (``wire``), the codec stage and its
container format (``codec``), and a crc32c verifier (``checksum``) for
the JAX package's native-plane chunks — and the observability and fault
seams: the fault registry (``faults``), the flight recorder, trace spans,
metrics, the workload's metrics and debug server, log correlation, the
live progress tracker, the periodic sampler and the phase profiler
(``obs``), the build stamp (``version``) and the restored process's
prefetch (``prefetch``, which opens the flight log's restart window
before ``import torch``), each with the reference's names and file
formats.

This file imports nothing: ``python -m grit_tpu_torch.workload`` runs it
before the workload's prefetch, which must come before ``import torch``.
"""

__version__ = "0.1.0"

