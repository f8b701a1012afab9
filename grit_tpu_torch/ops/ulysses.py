"""Ulysses attention: all-to-all sequence parallelism.

Counterpart of ``grit_tpu/ops/ulysses.py`` (``_ulysses_local``,
``ulysses_attention``). One all-to-all re-partitions q, k and v from
sequence-sharded to head-sharded, every rank runs ordinary causal
attention over the whole sequence for its share of the heads, and a
second all-to-all restores the sequence sharding. The attention inside
is the port's :func:`~grit_tpu_torch.ops.attention.causal_attention`: on
the card at S % 128 == 0 and head dim 128 the hand-written flash kernels
(the reference's Pallas dispatch, unchanged), plain tensor ops on the
CPU. The all-to-alls hand it contiguous tensors, as the kernels need.

Ulysses needs both head counts to divide by the axis size (heads are the
sharded resource during attention); the ring (:mod:`ring_attention`)
needs neither. As there, the port takes and returns this rank's local
shard of a sequence split over the axis in rank order; the reference
takes global arrays under ``shard_map``.
"""

from __future__ import annotations

import torch

from grit_tpu_torch.ops.attention import causal_attention
from grit_tpu_torch.parallel.collectives import all_to_all, axis_size


def _ulysses_local(q, k, v, axis=None):
    """q (B, S/N, H, hd), k/v (B, S/N, KVH, hd) → out (B, S/N, H, hd)."""
    # Sequence-sharded → head-sharded: split the heads N ways, gather the
    # sequence.
    q = all_to_all(q, 2, 1, axis)
    k = all_to_all(k, 2, 1, axis)
    v = all_to_all(v, 2, 1, axis)
    # (B, S, H/N, hd): causal attention over the whole sequence.
    out = causal_attention(q, k, v)
    # Head-sharded → sequence-sharded.
    return all_to_all(out, 1, 2, axis)


def ulysses_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      axis=None) -> torch.Tensor:
    """Causal self-attention with the sequence sharded over ``axis``:
    this rank's shards in, this rank's shard of the output out, the
    interface of :func:`~grit_tpu_torch.ops.ring_attention.ring_attention`.
    Both head counts must divide by the axis size."""
    n = axis_size(axis)
    if q.shape[2] % n or k.shape[2] % n:
        raise ValueError(
            f"ulysses shards heads during attention: heads {q.shape[2]}/"
            f"kv heads {k.shape[2]} must divide by the axis size {n} "
            "(use ring_attention when they don't)")
    return _ulysses_local(q, k, v, axis)
