"""The collective layer: axes, and collectives with their gradients.

The JAX package runs its multi-device code as one SPMD program under
``shard_map``: ``lax.axis_index``, ``ppermute``, ``all_to_all`` and
``psum``, each with its transpose. The port runs one process per rank
over a ``torch.distributed`` process group, and this module gives those
operations to it:

- an *axis* is a process group (``None``: the default group) or a 1-D
  ``DeviceMesh``; :func:`axis_index` and :func:`axis_size` read it;
- :func:`ring_shift`: the ``ppermute`` ring ``i → i+1``; its backward
  shifts the cotangent the other way;
- :func:`all_to_all`: ``lax.all_to_all(..., tiled=True)``: the input's
  ``split_dim`` is cut into ``size`` chunks, chunk ``j`` goes to rank
  ``j``, and what rank ``i`` sent lands at position ``i`` along
  ``concat_dim``; its backward is the all-to-all back;
- :func:`reduce_sum` and :func:`replicate`, the two halves of ``psum``
  and its transpose. ``reduce_sum`` sums over the axis and passes the
  cotangent through unchanged: every rank then computes the same loss
  from the same sum, so the cotangent each rank holds is the whole one
  (``torch.distributed.nn.functional.all_reduce`` would sum the ranks'
  cotangents too and hand back N times the gradient). ``replicate`` is
  the identity whose backward sums over the axis: a tensor every rank
  holds alike (a parameter, the pipeline's input) gets the sum of what
  each rank's part of the computation contributes.

**Backends.** The caller picks the backend when it starts the ranks
(:func:`grit_tpu_torch.parallel.launch.run_ranks`); nothing here tries
one and takes another. On an NCCL group the tensors stay on the card.
On a gloo group a CUDA tensor goes through a pinned host copy for every
operation (gloo's CUDA support differs from operation to operation, and
this layer depends on none of it), so ranks that share one card talk
through the host.

Every rank must issue the same collectives in the same order. The
operations here are autograd functions whose backward issues its own
collectives, so a graph that differs between ranks (a branch that skips
an operation on some ranks) can hang the backward: the callers keep
their graphs alike and branch on the rank only inside an operation.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from grit_tpu_torch.tree import flatten_with_names, map_with_names


def process_group(axis=None):
    """The process group of ``axis``: a group as given (``None``, the
    default group), or the group of a 1-D ``DeviceMesh``."""
    if isinstance(axis, DeviceMesh):
        if axis.ndim != 1:
            raise ValueError(f"an axis is a 1-D DeviceMesh; this one has "
                             f"{axis.ndim} dims (pass mesh[dim_name])")
        return axis.get_group()
    return axis


def axis_index(axis=None) -> int:
    """This rank's position along ``axis`` (``lax.axis_index``)."""
    return dist.get_rank(process_group(axis))


def axis_size(axis=None) -> int:
    return dist.get_world_size(process_group(axis))


def _peer(group, rank: int) -> int:
    """The global rank of ``rank`` of ``group`` (what P2P ops address)."""
    return rank if group is None else dist.get_global_rank(group, rank)


def _host_hop(x: torch.Tensor, group) -> bool:
    return x.is_cuda and dist.get_backend(group) == dist.Backend.GLOO


def _outbound(x: torch.Tensor, group, fresh: bool = False) -> torch.Tensor:
    """``x`` as the backend takes it: a pinned host copy of a CUDA tensor
    on gloo, else ``x`` contiguous (a copy with ``fresh``, for an
    operation that writes its input)."""
    if _host_hop(x, group):
        h = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
        h.copy_(x)
        return h
    x = x.contiguous()
    return x.clone() if fresh else x


def _inbound(h: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    return h if h.device == like.device else h.to(like.device)


def shift(x: torch.Tensor, group, step: int) -> torch.Tensor:
    """Send ``x`` to rank ``i + step`` of ``group`` and return what rank
    ``i - step`` sent: the hop without a gradient, for an operation that
    writes its own backward (the ring attention)."""
    n = dist.get_world_size(group)
    if n == 1 or step % n == 0:
        return x
    i = dist.get_rank(group)
    send = _outbound(x, group)
    recv = torch.empty_like(send)
    ops = [dist.P2POp(dist.isend, send, _peer(group, (i + step) % n), group),
           dist.P2POp(dist.irecv, recv, _peer(group, (i - step) % n), group)]
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    return _inbound(recv, x)


def _all_to_all(x: torch.Tensor, split_dim: int, concat_dim: int,
                group) -> torch.Tensor:
    n = dist.get_world_size(group)
    split_dim, concat_dim = split_dim % x.dim(), concat_dim % x.dim()
    if x.shape[split_dim] % n:
        raise ValueError(f"all_to_all: dim {split_dim} of {tuple(x.shape)} "
                         f"does not divide by the axis size {n}")
    if n == 1:
        return x.contiguous()
    moved = x.movedim(split_dim, 0)
    # send[j] is chunk j of the split dim (moved to the front), for rank j.
    send = _outbound(moved.reshape(n, -1, *moved.shape[1:]), group)
    recv = torch.empty_like(send)
    dist.all_to_all_single(recv, send, group=group)
    recv = _inbound(recv, x)
    return torch.cat([recv[i].movedim(0, split_dim) for i in range(n)],
                     dim=concat_dim)


def _all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    buf = _outbound(x, group, fresh=True)
    dist.all_reduce(buf, group=group)
    return _inbound(buf, x)


class _RingShift(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return shift(x, group, 1)

    @staticmethod
    def backward(ctx, g):
        return shift(g, ctx.group, -1), None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, split_dim, concat_dim, group):
        ctx.dims, ctx.group = (split_dim, concat_dim), group
        return _all_to_all(x, split_dim, concat_dim, group)

    @staticmethod
    def backward(ctx, g):
        split_dim, concat_dim = ctx.dims
        return _all_to_all(g, concat_dim, split_dim, ctx.group), None, None, None


class _ReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Replicate(torch.autograd.Function):
    @staticmethod
    def forward(ctx, group, *xs):
        ctx.group = group
        return tuple(x.view_as(x) for x in xs)

    @staticmethod
    def backward(ctx, *grads):
        # One call for all of them, in argument order on every rank.
        return (None, *(_all_reduce(g, ctx.group) if need else None
                        for g, need in zip(grads, ctx.needs_input_grad[1:])))


def ring_shift(x: torch.Tensor, axis=None) -> torch.Tensor:
    """Rank ``i``'s ``x`` arrives at rank ``i + 1`` (mod the axis size):
    ``lax.ppermute`` over the ring ``[(i, i + 1)]``. Differentiable."""
    return _RingShift.apply(x, process_group(axis))


def all_to_all(x: torch.Tensor, split_dim: int, concat_dim: int,
               axis=None) -> torch.Tensor:
    """``lax.all_to_all(x, axis, split_dim, concat_dim, tiled=True)``:
    contiguous output. Differentiable."""
    return _AllToAll.apply(x, split_dim, concat_dim, process_group(axis))


def reduce_sum(x: torch.Tensor, axis=None) -> torch.Tensor:
    """The sum of ``x`` over the axis, on every rank; the backward passes
    the cotangent through unchanged (see the module's note)."""
    return _ReduceSum.apply(x, process_group(axis))


def replicate(tree, axis=None):
    """``tree`` unchanged (its leaves as views); in the backward each
    leaf's gradient is summed over the axis, in one call for the whole
    tree, so every rank ends with the same, whole gradient."""
    named = flatten_with_names(tree)
    outs = iter(_Replicate.apply(process_group(axis), *(x for _, x in named)))
    return map_with_names(lambda _name, _leaf: next(outs), tree)
