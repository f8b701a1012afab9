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
serving agentlet (``serving``).
"""
