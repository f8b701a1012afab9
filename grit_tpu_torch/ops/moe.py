"""Mixture-of-Experts feed-forward (GShard-style top-k routing with a
static capacity, dense one-hot dispatch and combine).

Counterpart of ``grit_tpu/ops/moe.py`` (``init_moe_params``,
``expert_shardings``, ``moe_mlp`` with ``mesh=``). Every shape is static:
a token routed past its expert's capacity is dropped by a zero, never by
a data-dependent shape, and the dispatch and combine are einsums over a
(tokens, experts, capacity) one-hot.

**Expert parallelism** (``moe_mlp(mesh=, axis=)``). The reference runs
one program over the global (T, D) tokens and pins the dispatched
activations to the expert axis; the port runs one process a rank, each
holding its shard of the tokens (split over the mesh's other axes, in
batch order) and its ``E / size(axis)`` experts. It keeps the global
semantics exactly:

- the capacity comes from the global token count;
- each routing slot's queue positions are offset by the tokens the batch
  shards before this one routed to each expert (an exclusive prefix over
  one all-gather of every shard's (k, E) counts) and by what lower slots
  kept over the whole batch; these are integers, so the drops are the
  dense layer's;
- the aux statistics are summed over the shards before the division.

The tokens are replicated along ``axis``, so each rank dispatches its own
tokens into its own experts' cells with no exchange; a sum over the token
shards (each (expert, capacity) cell holds at most one token, so the sum
is exact in any order) gives every rank its experts' whole (E/m, C, D)
input. The experts' outputs are then gathered along ``axis``, and each
rank combines its tokens against all E experts as the dense layer does,
so the output does not depend on the layout. In the backward the
gather keeps each rank's own experts' part, the expert outputs' cotangent
is summed over the token shards (each contributes its own tokens'), the
tokens' cotangent through the dispatch over ``axis`` (each rank holds its
own experts'), and the router's over the token shards.

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
from functools import partial

import torch
import torch.nn.functional as F
from torch.distributed.device_mesh import DeviceMesh

from grit_tpu_torch.parallel.collectives import (
    all_gather,
    axis_index,
    axis_size,
    gather_shards,
    reduce_sum,
    replicate,
    shard_index,
)
from grit_tpu_torch.parallel.mesh import EXPERT_AXIS, axis_groups
from grit_tpu_torch.parallel.sharding import NamedSharding, is_dtensor


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


def expert_shardings(mesh: DeviceMesh, axis: str = EXPERT_AXIS) -> dict:
    """The expert layer's shardings: experts split over ``axis``, the
    router replicated."""
    return {"router": NamedSharding(mesh, ()),
            "w_in": NamedSharding(mesh, (axis,)),
            "w_out": NamedSharding(mesh, (axis,))}


def _one_hot(index: torch.Tensor, n: int) -> torch.Tensor:
    """fp32 one-hot of ``index`` over ``n`` classes; an index outside
    ``[0, n)`` gives the zero vector, as ``jax.nn.one_hot``'s does."""
    return (index[..., None] == torch.arange(n, device=index.device)).float()


def capacity_of(tokens: int, n_experts: int, top_k: int,
                capacity_factor: float) -> int:
    return max(1, int(math.ceil(tokens * top_k / n_experts * capacity_factor)))


def route(topk_idx: torch.Tensor, gates: torch.Tensor, mask_f: torch.Tensor,
          capacity: int, n_experts: int, dtype: torch.dtype,
          token_groups=()) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The dispatch and combine one-hots, (T, E, C) in ``dtype``, and the
    first slot's fp32 expert one-hot (T, E) the aux statistics read.
    ``topk_idx``/``gates`` (T, k): each token's experts and gates, lower
    slots first; ``mask_f`` (T,): 1 for a routed token, 0 for a masked
    one. Only ``combine`` carries a gradient (to ``gates``).

    ``token_groups``: the process groups that split the tokens into
    shards, major first (none: these are all the tokens). A slot's
    positions then continue after what the shards before this one routed
    to each expert, and after what lower slots kept over every shard."""
    tokens, top_k = topk_idx.shape
    dev = topk_idx.device
    rows = torch.arange(tokens, device=dev)
    with torch.no_grad():
        onehots = [_one_hot(topk_idx[:, j], n_experts) * mask_f[:, None]
                   for j in range(top_k)]                           # (T, E)
        routed = [oh.t().to(torch.int32).contiguous() for oh in onehots]
        counts = torch.stack([r.sum(dim=1, dtype=torch.int32)
                              for r in routed])                     # (k, E)
        shards = gather_shards(counts, token_groups)             # (n, k, E)
        me = shard_index(token_groups)
        before = shards[:me].sum(dim=0, dtype=torch.int32)          # (k, E)
        total = shards.sum(dim=0, dtype=torch.int32)
        cells, kept_slots = [], []
        kept = torch.zeros(n_experts, dtype=torch.int32, device=dev)
        for j in range(top_k):
            expert = topk_idx[:, j]
            # Slot j's positions start after what slots < j kept, and
            # after the earlier shards' tokens of slot j.
            position = (torch.cumsum(routed[j], dim=1) - 1
                        + (kept + before[j])[:, None])              # (E, T)
            keep = (position < capacity) & (routed[j] > 0)
            kept = kept + torch.minimum((capacity - kept).clamp(min=0),
                                        total[j])
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
    return dispatch.reshape(shape), combine.reshape(shape), onehots[0]


def _reduce(x: torch.Tensor, groups) -> torch.Tensor:
    for group in groups:
        x = reduce_sum(x, group)
    return x


def _replicate(x: torch.Tensor, groups) -> torch.Tensor:
    for group in groups:
        x = replicate(x, group)
    return x


def _moe(router: torch.Tensor, w_in: torch.Tensor, w_out: torch.Tensor,
         x: torch.Tensor, token_mask: torch.Tensor | None, *,
         capacity_factor: float, top_k: int, token_groups=(),
         expert_group=None) -> tuple[torch.Tensor, torch.Tensor]:
    """The layer on this rank's tokens ``x`` (T_local, D): the dense one
    with no groups; see the module's note for the sharded one. ``w_in``/
    ``w_out`` hold every expert or this rank's ``E / size(expert_group)``."""
    tokens, _dim = x.shape
    n_experts = router.shape[1]
    if not 1 <= top_k <= n_experts:
        raise ValueError(f"top_k={top_k} out of range for {n_experts} experts")
    n_shards = math.prod(axis_size(g) for g in token_groups)
    capacity = capacity_of(tokens * n_shards, n_experts, top_k,
                           capacity_factor)
    # Each shard's tokens add their part of the router's gradient.
    router = _replicate(router, token_groups)

    logits = x.float() @ router.float()                           # (T, E)
    probs = torch.softmax(logits, dim=-1)
    topk_probs, topk_idx = torch.topk(probs, top_k, dim=-1)        # (T, k)
    gates = (topk_probs / topk_probs.sum(dim=-1, keepdim=True)
             if top_k > 1 else topk_probs)
    mask_f = (torch.ones(tokens, dtype=torch.float32, device=x.device)
              if token_mask is None else token_mask.float())
    dispatch, combine, onehot0 = route(topk_idx, gates, mask_f, capacity,
                                       n_experts, x.dtype, token_groups)

    x_in = x
    if expert_group is not None:
        m = axis_size(expert_group)
        if n_experts % m:
            raise ValueError(f"{n_experts} experts do not split {m} ways")
        local, j = n_experts // m, axis_index(expert_group)
        mine = slice(j * local, (j + 1) * local)
        dispatch = dispatch[:, mine]
        if w_in.shape[0] == n_experts:  # whole weights: keep this rank's
            w_in, w_out = w_in[mine], w_out[mine]
        # Each rank's dispatch feeds its own experts: the tokens' gradient
        # through it is summed over the expert axis.
        x_in = replicate(x, expert_group)
    xe = _reduce(torch.einsum("tec,td->ecd", dispatch, x_in),
                 token_groups)                                   # (E', C, D)
    h = F.gelu(torch.einsum("ecd,edh->ech", xe, w_in.to(x.dtype)),
               approximate="tanh")
    ye = _replicate(torch.einsum("ech,ehd->ecd", h, w_out.to(x.dtype)),
                    token_groups)
    if expert_group is not None:
        ye = all_gather(ye, 0, expert_group)                     # (E, C, D)
    y = torch.einsum("tec,ecd->td", combine, ye)                   # (T, D)

    stats = _reduce(torch.cat([onehot0.sum(dim=0),
                               (probs * mask_f[:, None]).sum(dim=0),
                               mask_f.sum()[None]]), token_groups)
    denom = torch.clamp(stats[-1], min=1.0)
    fraction = stats[:n_experts] / denom                           # (E,)
    mean_prob = stats[n_experts:2 * n_experts] / denom
    aux = (fraction * mean_prob).sum() * n_experts
    return y, aux


def moe_mlp(params: dict, x: torch.Tensor, *, capacity_factor: float = 1.25,
            mesh: DeviceMesh | None = None, axis: str = EXPERT_AXIS,
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
    capacity, give zero output and leave the aux statistics alone.

    ``mesh`` (a ``DeviceMesh`` with ``axis`` among its axes): the experts
    split over ``axis``, the tokens over the mesh's other axes (see the
    module's note). DTensor inputs (the sharded Trainer's) are taken to
    those layouts, and ``y`` comes back split like the tokens; plain ones
    are this rank's tokens and either every expert's weights or this
    rank's."""
    router, w_in, w_out = params["router"], params["w_in"], params["w_out"]
    if mesh is None:
        return _moe(router, w_in, w_out, x, token_mask,
                    capacity_factor=capacity_factor, top_k=top_k)
    if axis not in mesh.mesh_dim_names:
        raise ValueError(f"the mesh {mesh.mesh_dim_names} has no axis {axis!r}")
    fn = partial(_moe, capacity_factor=capacity_factor, top_k=top_k,
                 token_groups=tuple(axis_groups(
                     mesh, [n for n in mesh.mesh_dim_names if n != axis])),
                 expert_group=(axis_groups(mesh, [axis]) or [None])[0])
    if not is_dtensor(x):
        return fn(router, w_in, w_out, x, token_mask)
    from torch.distributed.tensor import Replicate, Shard  # noqa: PLC0415
    from torch.distributed.tensor.experimental import local_map  # noqa: PLC0415

    names = x.device_mesh.mesh_dim_names
    tok = tuple(Replicate() if n == axis else Shard(0) for n in names)
    exp = tuple(Shard(0) if n == axis else Replicate() for n in names)
    rep = (Replicate(),) * len(names)
    return local_map(fn, out_placements=(tok, rep),
                     in_placements=(rep, exp, exp, tok,
                                    None if token_mask is None else tok),
                     redistribute_inputs=True)(router, w_in, w_out, x,
                                               token_mask)
