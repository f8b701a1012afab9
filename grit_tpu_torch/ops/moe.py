"""Mixture-of-Experts feed-forward (GShard-style top-k routing with a
static capacity, dense one-hot dispatch and combine).

Counterpart of ``grit_tpu/ops/moe.py`` (``init_moe_params``, ``moe_mlp``);
the expert sharding (``expert_shardings``, ``mesh=``) is not ported. Every
shape is static: a token routed past its expert's capacity is dropped by a
zero, never by a data-dependent shape, and the dispatch and combine are
einsums over a (tokens, experts, capacity) one-hot.

The reference builds those one-hots as products and sums of fp32 (T, E,
C) tensors, one per routing slot. Each token's slot lands in at most one
(expert, position) cell, and the slots of one token go to distinct
experts, so the port writes the same values straight into a zero (T, E·C)
grid with one scatter: 1 (dispatch) or the slot's gate (combine) where the
slot is kept, 0 where it is dropped. The cells hold the reference's values
bit for bit (a kept cell's sum is 0 + 1·gate), and the gates' gradient is
the gather of the combine's gradient, which is what the reference's
products give. The one-hots' routing arithmetic then runs on (T, E)
tensors only.

Three points where PyTorch differs from JAX and the port follows JAX:

- ``jax.nn.gelu`` is the tanh approximation by default, so the experts use
  ``F.gelu(approximate="tanh")``.
- ``jax.nn.one_hot`` of an out-of-range index is the zero vector, and that
  is how a dropped token vanishes from the position encoding;
  ``F.one_hot`` raises there, so one-hots here are comparisons against an
  ``arange``.
- ``jax.lax.top_k`` breaks ties toward the lower index; ``torch.topk``
  promises no order among equal values. Router probabilities tie only on
  purpose-built inputs, and the parity tests use tie-free ones.

The routing bookkeeping (expert one-hots, positions, the keep mask)
carries no gradient and runs on exact integers: the positions come from an
int32 cumsum along contiguous rows of the transposed (E, T) one-hot, which
is exact in any order (a floating-point cumsum on the card has no
deterministic implementation).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def moe_param_shapes(dim: int, hidden: int, n_experts: int) -> dict:
    """The expert layer's leaves as ``(shape, scale)``."""
    return {"router": ((dim, n_experts), 1.0 / math.sqrt(dim)),
            "w_in": ((n_experts, dim, hidden), 1.0 / math.sqrt(dim)),
            "w_out": ((n_experts, hidden, dim), 1.0 / math.sqrt(hidden))}


def init_moe_params(generator: torch.Generator, dim: int, hidden: int,
                    n_experts: int, dtype: torch.dtype = torch.float32,
                    device: torch.device | str = "cpu") -> dict:
    """Router (dim, E) and expert weights (E, dim, hidden), (E, hidden,
    dim): N(0, 1) times 1/sqrt(fan_in), drawn in fp32 from ``generator``
    and cast to ``dtype``, as the reference scales and casts them."""
    return {name: (torch.randn(shape, generator=generator,
                               dtype=torch.float32, device=device)
                   * scale).to(dtype)
            for name, (shape, scale) in
            moe_param_shapes(dim, hidden, n_experts).items()}


def _one_hot(index: torch.Tensor, n: int) -> torch.Tensor:
    """fp32 one-hot of ``index`` over ``n`` classes; an index outside
    ``[0, n)`` gives the zero vector, as ``jax.nn.one_hot``'s does."""
    return (index[..., None] == torch.arange(n, device=index.device)).float()


def capacity_of(tokens: int, n_experts: int, top_k: int,
                capacity_factor: float) -> int:
    return max(1, int(math.ceil(tokens * top_k / n_experts * capacity_factor)))


def route(topk_idx: torch.Tensor, gates: torch.Tensor, mask_f: torch.Tensor,
          capacity: int, n_experts: int, dtype: torch.dtype
          ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The dispatch and combine one-hots, (T, E, C) in ``dtype``, and the
    first slot's fp32 expert one-hot (T, E) the aux statistics read.
    ``topk_idx``/``gates`` (T, k): each token's experts and gates, lower
    slots first; ``mask_f`` (T,): 1 for a routed token, 0 for a masked
    one. Only ``combine`` carries a gradient (to ``gates``)."""
    tokens, top_k = topk_idx.shape
    dev = topk_idx.device
    rows = torch.arange(tokens, device=dev)
    with torch.no_grad():
        cells, kept_slots, onehot0 = [], [], None
        kept = torch.zeros(n_experts, 1, dtype=torch.int32, device=dev)
        for j in range(top_k):
            expert = topk_idx[:, j]
            onehot = _one_hot(expert, n_experts) * mask_f[:, None]  # (T, E)
            if j == 0:
                onehot0 = onehot
            routed = onehot.t().to(torch.int32).contiguous()         # (E, T)
            # Slot j's positions start after what slots < j kept.
            position = torch.cumsum(routed, dim=1) - 1 + kept
            keep = (position < capacity) & (routed > 0)
            kept = kept + keep.sum(dim=1, keepdim=True, dtype=torch.int32)
            # The slot's (expert, position) cell; a dropped slot's position
            # may be past the capacity, so it is clamped into the expert's
            # own range, where it writes a zero.
            pos = position[expert, rows].clamp(0, capacity - 1)
            cells.append(expert * capacity + pos)
            kept_slots.append(keep[expert, rows])
        cells = torch.stack(cells, dim=1)                           # (T, k)
        keep_f = torch.stack(kept_slots, dim=1).float()             # (T, k)
        grid = torch.zeros(tokens, n_experts * capacity, dtype=dtype,
                           device=dev)
        dispatch = grid.scatter(1, cells, keep_f.to(dtype))
    combine = grid.scatter(1, cells, (gates * keep_f).to(dtype))
    shape = (tokens, n_experts, capacity)
    return dispatch.reshape(shape), combine.reshape(shape), onehot0


def moe_mlp(params: dict, x: torch.Tensor, *, capacity_factor: float = 1.25,
            top_k: int = 1, token_mask: torch.Tensor | None = None
            ) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-k MoE feed-forward over tokens ``x`` (T, D). Returns ``(y,
    aux)``: y (T, D) in ``x``'s dtype, aux the fp32 load-balancing loss
    (1.0 for a perfectly uniform router).

    A token routed past its expert's capacity contributes zero output (the
    residual around the layer carries it). ``top_k=1`` gates by the raw
    router probability (Switch); ``top_k>1`` renormalises the gates over
    the chosen experts (Mixtral). Lower slots have priority: slot j's
    positions start after the tokens slots < j kept in each expert.
    ``token_mask`` (T,) bool: masked tokens route nowhere, take no
    capacity, give zero output and leave the aux statistics alone."""
    tokens, _dim = x.shape
    n_experts = params["router"].shape[1]
    if not 1 <= top_k <= n_experts:
        raise ValueError(f"top_k={top_k} out of range for {n_experts} experts")
    capacity = capacity_of(tokens, n_experts, top_k, capacity_factor)

    logits = x.float() @ params["router"].float()                 # (T, E)
    probs = torch.softmax(logits, dim=-1)
    topk_probs, topk_idx = torch.topk(probs, top_k, dim=-1)        # (T, k)
    gates = (topk_probs / topk_probs.sum(dim=-1, keepdim=True)
             if top_k > 1 else topk_probs)
    mask_f = (torch.ones(tokens, dtype=torch.float32, device=x.device)
              if token_mask is None else token_mask.float())
    dispatch, combine, onehot0 = route(topk_idx, gates, mask_f, capacity,
                                       n_experts, x.dtype)

    xe = torch.einsum("tec,td->ecd", dispatch, x)                  # (E, C, D)
    h = F.gelu(torch.einsum("ecd,edh->ech", xe,
                            params["w_in"].to(x.dtype)), approximate="tanh")
    ye = torch.einsum("ech,ehd->ecd", h, params["w_out"].to(x.dtype))
    y = torch.einsum("tec,ecd->td", combine, ye)                   # (T, D)

    denom = torch.clamp(mask_f.sum(), min=1.0)
    fraction = onehot0.sum(dim=0) / denom                          # (E,)
    mean_prob = (probs * mask_f[:, None]).sum(dim=0) / denom
    aux = (fraction * mean_prob).sum() * n_experts
    return y, aux
