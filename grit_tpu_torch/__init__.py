"""grit-tpu for PyTorch on CUDA: the port of :mod:`grit_tpu` to a Hopper GPU.

The JAX package stays the reference; this package imports ``torch`` and
never ``jax`` or anything of ``grit_tpu``. Module names mirror the JAX
package so each port module's counterpart is found at the same path.

Slice 1 (this package today): the llama training-and-migration path —
three hand-written CUDA flash-attention kernels (``ops``), the training
subset of the llama model (``models.llama``), the trainer
(``train.trainer``), the snapshot format, agentlet and restore hook
(``device``) and the migratable workload (``workload``).
"""
