"""Ring attention: causal attention over a sequence sharded across ranks.

Counterpart of ``grit_tpu/ops/ring_attention.py`` (``_block_attention``,
``_ring_body``, ``_ring_attention_local``, ``ring_attention``). Each rank
keeps its own query block and fp32 online-softmax statistics while the
K/V blocks travel around the ring, one
:func:`~grit_tpu_torch.parallel.collectives.ring_shift` hop a step; at
step ``r`` rank ``i`` holds block ``i - r``. Causality at block
granularity gives the flash kernel's trichotomy at the mesh level: a
block from later positions is skipped, the rank's own block is masked
elementwise (the diagonal), an earlier block is attended in full. The
per-block attention is plain tensor code, as it is plain XLA in the
reference; no flash kernel runs on this path.

**Local shards.** The reference takes global (B, S, H, hd) arrays under
``shard_map``; :func:`ring_attention` takes and returns this rank's
local shard (B, S/N, H, hd) of a sequence split over the axis in rank
order.

**The backward.** The whole ring is one autograd function with its own
backward: the standard ring backward, which recomputes each block's
probabilities from the saved logsumexp, accumulates dQ locally and sends
each block's dK/dV around the ring with the block, so that after N hops
they are home. Autograd through the loop instead would keep every
block's scores, and its hops' backward would run only on the ranks that
used the hopped block (a skipped block has no gradient there), which
hangs the ranks that wait for them. Here every rank makes the same hops
in the same order, forward and backward: a skipped block skips its
compute, never its hop. The forward makes N - 1 hops (the reference's
N-th returns the blocks to their owners and feeds nothing); the backward
makes N - 1 hops of K/V and N of dK/dV.
"""

from __future__ import annotations

import math

import torch

from grit_tpu_torch.parallel.collectives import (
    axis_index,
    axis_size,
    process_group,
    shift,
)

_NEG_INF = -1e30
SKIP, DIAGONAL, FULL = 0, 1, 2


def _mask_mode(my: int, kv_idx: int) -> int:
    return SKIP if kv_idx > my else DIAGONAL if kv_idx == my else FULL


def _grouped(x: torch.Tensor, kvh: int) -> torch.Tensor:
    """(B, s, H, hd) → fp32 (B, KVH, groups, s, hd)."""
    B, s, H, hd = x.shape
    return x.float().reshape(B, s, kvh, H // kvh, hd).permute(0, 2, 3, 1, 4)


def _scores(qg: torch.Tensor, k: torch.Tensor, mode: int) -> torch.Tensor:
    """fp32 scores (B, KVH, g, sq, skv) of the grouped queries against one
    K block, masked as ``mode`` says (only DIAGONAL masks: the two blocks
    sit at the same offset, so the mask is the lower triangle)."""
    hd = qg.shape[-1]
    s = torch.einsum("bkgqh,bjkh->bkgqj", qg, k.float()) / math.sqrt(hd)
    if mode == DIAGONAL:
        sq, skv = s.shape[-2:]
        keep = torch.ones(sq, skv, dtype=torch.bool, device=s.device).tril()
        s = s.masked_fill(~keep, _NEG_INF)
    return s


def _block_attention(qg, k, v, m, l, acc, mode):
    """One online-softmax update of the grouped queries against one K/V
    block (``_block_attention`` of the reference); a skipped block keeps
    the old statistics and is never computed."""
    if mode == SKIP:
        return m, l, acc
    s = _scores(qg, k, mode)
    m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
    p = torch.exp(s - m_new)
    alpha = torch.exp(m - m_new)
    l_new = l * alpha + p.sum(dim=-1, keepdim=True)
    acc_new = acc * alpha + torch.einsum("bkgqj,bjkh->bkgqh", p, v.float())
    return m_new, l_new, acc_new


class _Ring(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, group):
        my, n = axis_index(group), axis_size(group)
        B, s, H, hd = q.shape
        kvh = k.shape[2]
        qg = _grouped(q, kvh)
        m = torch.full((*qg.shape[:-1], 1), _NEG_INF, dtype=torch.float32,
                       device=q.device)
        l = torch.zeros_like(m)
        acc = torch.zeros_like(qg)
        kb, vb = k, v
        for r in range(n):
            m, l, acc = _block_attention(qg, kb, vb, m, l, acc,
                                         _mask_mode(my, (my - r) % n))
            if r < n - 1:
                kb, vb = shift(kb, group, 1), shift(vb, group, 1)
        out = acc / l
        ctx.save_for_backward(q, k, v, out, m + torch.log(l))
        ctx.group = group
        return out.permute(0, 3, 1, 2, 4).reshape(B, s, H, hd).to(q.dtype)

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        group = ctx.group
        my, n = axis_index(group), axis_size(group)
        B, s, H, hd = q.shape
        kvh = k.shape[2]
        qg, dog = _grouped(q, kvh), _grouped(do, kvh)
        delta = (dog * out).sum(dim=-1, keepdim=True)
        dq = torch.zeros_like(qg)
        kb, vb = k, v
        dk = torch.zeros(k.shape, dtype=torch.float32, device=k.device)
        dv = torch.zeros_like(dk)
        scale = 1.0 / math.sqrt(hd)
        for r in range(n):
            mode = _mask_mode(my, (my - r) % n)
            if mode != SKIP:
                p = torch.exp(_scores(qg, kb, mode) - lse)
                dv = dv + torch.einsum("bkgqj,bkgqh->bjkh", p, dog)
                dp = torch.einsum("bkgqh,bjkh->bkgqj", dog, vb.float())
                ds = p * (dp - delta)
                dq = dq + torch.einsum("bkgqj,bjkh->bkgqh", ds, kb.float()) * scale
                dk = dk + torch.einsum("bkgqj,bkgqh->bjkh", ds, qg) * scale
            if r < n - 1:
                kb, vb = shift(kb, group, 1), shift(vb, group, 1)
            # The block's dK/dV travel with it: N hops bring them home.
            dk, dv = shift(dk, group, 1), shift(dv, group, 1)
        dq = dq.permute(0, 3, 1, 2, 4).reshape(B, s, H, hd)
        return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), None


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   axis=None) -> torch.Tensor:
    """Causal self-attention with the sequence sharded over ``axis`` in
    rank order. q (B, S/N, H, hd), k/v (B, S/N, KVH, hd): this rank's
    shard. Returns this rank's shard of the output, (B, S/N, H, hd) in
    q's dtype. Differentiable in q, k and v."""
    if q.shape[2] % k.shape[2]:
        raise ValueError(f"n_heads {q.shape[2]} is not a multiple of kv "
                         f"heads {k.shape[2]}")
    return _Ring.apply(q, k, v, process_group(axis))
