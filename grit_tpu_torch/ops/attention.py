"""Causal attention with GQA: the CUDA flash kernels for the training
shape, plain tensor ops otherwise.

Counterpart of ``grit_tpu/ops/attention.py``; same signature and mask
rule. ``q`` is (B, Sq, n_heads, hd), ``k``/``v`` (B, Skv, n_kv_heads, hd);
``q_offset`` is the absolute position of ``q[:, 0]`` in the KV axis and
``kv_len`` the number of valid KV entries. A query at absolute position
``a = q_offset + i`` may attend key ``j`` iff ``j <= a`` and
``j < kv_len``.
"""

from __future__ import annotations

import torch

from grit_tpu_torch.ops.flash_attention import (
    BLOCK,
    flash_attention,
    flash_attention_bwd,
)


class _FlashAttention(torch.autograd.Function):
    """Flash forward with the fused flash backward (the port of the JAX
    package's ``jax.custom_vjp`` around the Pallas kernels): the forward
    keeps only O and the O(S) logsumexp; the backward recomputes P tile by
    tile in the dQ and dK/dV kernels, so the S x S probabilities never
    exist in device memory."""

    @staticmethod
    def forward(ctx, q, k, v):
        out, lse = flash_attention(q, k, v, return_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        return flash_attention_bwd(q, k, v, lse, do.contiguous(), out)


def flash_differentiable(q: torch.Tensor, k: torch.Tensor,
                         v: torch.Tensor) -> torch.Tensor:
    return _FlashAttention.apply(q, k, v)


def causal_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    q_offset: torch.Tensor | int = 0,
    kv_len: torch.Tensor | int | None = None,
) -> torch.Tensor:
    """Dispatch: the flash kernels on CUDA for the training shape, the
    plain reference otherwise (CPU, decode, ragged cases)."""
    if _use_flash(q, k, q_offset, kv_len):
        return flash_differentiable(q, k, v)
    return attention_reference(q, k, v, q_offset=q_offset, kv_len=kv_len)


def _use_flash(q, k, q_offset, kv_len) -> bool:
    if kv_len is not None or not isinstance(q_offset, int) or q_offset != 0:
        return False
    if q.shape[1] != k.shape[1] or not q.is_cuda:
        return False
    # No dtype clause: an fp32 request at this shape reaches the kernel
    # wrapper, which refuses it, rather than quietly taking the plain path.
    return q.shape[1] % BLOCK == 0 and q.shape[-1] % BLOCK == 0


def attention_reference(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    q_offset: torch.Tensor | int = 0,
    kv_len: torch.Tensor | int | None = None,
) -> torch.Tensor:
    """Plain masked attention. ``q_offset`` and ``kv_len`` may be scalars
    or per-batch ``(B,)`` tensors (every sequence at its own position)."""
    B, Sq, H, hd = q.shape
    _, Skv, KVH, _ = k.shape
    groups = H // KVH
    # (B, KVH, groups, Sq, hd) x (B, KVH, Skv, hd): GQA without repeating
    # the KV heads. Scores in fp32, as the JAX einsum's preferred type.
    qg = q.reshape(B, Sq, KVH, groups, hd).permute(0, 2, 3, 1, 4)
    kt = k.transpose(1, 2)
    vt = v.transpose(1, 2)
    scores = torch.einsum("bkgqh,bkjh->bkgqj", qg.float(), kt.float())
    scores = scores / hd ** 0.5

    dev = q.device
    offset = torch.as_tensor(q_offset, device=dev).reshape(-1, 1)
    abs_q = torch.arange(Sq, device=dev)[None, :] + offset.expand(B, 1)
    key_pos = torch.arange(Skv, device=dev)
    mask = key_pos[None, None, :] <= abs_q[:, :, None]        # (B, Sq, Skv)
    if kv_len is not None:
        kv_len_b = torch.as_tensor(kv_len, device=dev).reshape(-1, 1)
        mask = mask & (key_pos[None, None, :] < kv_len_b.expand(B, 1)[:, :, None])
    scores = scores.masked_fill(~mask[:, None, None], -1e30)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    out = torch.einsum("bkgqj,bkjh->bkgqh", probs, vt)
    return out.permute(0, 3, 1, 2, 4).reshape(B, Sq, H, hd)
