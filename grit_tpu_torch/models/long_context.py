"""Long-context llama: sequence parallelism through ring or Ulysses
attention.

Counterpart of ``grit_tpu/models/long_context.py`` (``forward_sp``,
``loss_fn_sp``, ``ATTN_IMPLS``, ``SEQ_AXIS``). A sequence is split over
the ranks of an axis in rank order; every per-token operation
(embedding, norms, MLP, ``lm_head``, the loss) runs on the rank's own
positions, and the one operation across tokens, causal attention, runs
as the ring (:mod:`grit_tpu_torch.ops.ring_attention`) or as Ulysses
(:mod:`grit_tpu_torch.ops.ulysses`) through llama's ``attn_fn`` hook.
The parameter tree is dense llama's, so snapshots interchange with a
dense job's.

Where the reference's SPMD program sees the global sequence, each rank
here holds its shard:

- tokens and logits are this rank's shard (B, S/N), (B, S/N, vocab);
- positions are offset to the shard, ``rank · S/N + arange(S/N)``;
- the parameters enter through
  :func:`~grit_tpu_torch.parallel.collectives.replicate`, so each
  rank's parameter gradient is the sum over ranks of what their
  positions contribute: the dense gradient, the same on every rank;
- :func:`loss_fn_sp` is the global token mean (sums and counts reduced
  over the axis), not a mean of the ranks' means, and is the same value
  on every rank.

So the port's :class:`~grit_tpu_torch.train.trainer.Trainer`, unchanged,
steps every rank identically, and rank 0's snapshot is the whole state.
``SEQ_AXIS`` keeps the reference's name; an axis here is a process
group (or a 1-D ``DeviceMesh``), ``None`` the default group.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from grit_tpu_torch.models import llama
from grit_tpu_torch.models.llama import LlamaConfig
from grit_tpu_torch.ops.ring_attention import ring_attention
from grit_tpu_torch.ops.ulysses import ulysses_attention
from grit_tpu_torch.parallel.collectives import (
    axis_index,
    reduce_sum,
    replicate,
)

SEQ_AXIS = "seq"

ATTN_IMPLS = {"ring": ring_attention, "ulysses": ulysses_attention}


def forward_sp(cfg: LlamaConfig, params: dict, tokens: torch.Tensor, *,
               axis=None, attn_impl: str = "ring") -> torch.Tensor:
    """This rank's tokens (B, S/N) → its logits (B, S/N, vocab) fp32."""
    sp_attention = ATTN_IMPLS[attn_impl]
    B, s = tokens.shape
    start = axis_index(axis) * s
    positions = torch.arange(start, start + s, device=tokens.device).expand(B, s)
    return llama.forward_trunk(
        cfg, replicate(params, axis), tokens,
        attn_fn=lambda q, k, v: sp_attention(q, k, v, axis),
        positions=positions)


def loss_fn_sp(cfg: LlamaConfig, params: dict, tokens: torch.Tensor,
               targets: torch.Tensor, mask: torch.Tensor | None = None, *,
               axis=None, attn_impl: str = "ring") -> torch.Tensor:
    """The sequence-parallel next-token loss: the mean over every rank's
    tokens (``mask``ed as llama's), the same on every rank. A drop-in
    for ``llama.loss_fn`` in the Trainer's loss closure."""
    logits = forward_sp(cfg, params, tokens, axis=axis, attn_impl=attn_impl)
    logp = F.log_softmax(logits.float(), dim=-1)
    nll = F.nll_loss(logp.reshape(-1, logp.shape[-1]), targets.reshape(-1),
                     reduction="none")
    weight = (torch.ones_like(nll) if mask is None
              else mask.reshape(-1).float())
    total = reduce_sum((nll * weight).sum(), axis)
    count = reduce_sum(weight.sum(), axis)
    return total / torch.clamp(count, min=1.0)
