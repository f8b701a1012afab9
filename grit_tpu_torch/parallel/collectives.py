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
- :func:`all_gather`: ``lax.all_gather(..., tiled=True)``: every rank's
  input concatenated along a dim in rank order; its backward keeps this
  rank's part of the cotangent, which every rank holds whole (every rank
  computes the same thing from the gathered tensor, as after
  :func:`reduce_sum`);
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
A gloo group takes CPU tensors only: a CUDA tensor there raises.
:data:`LOCAL_GLOO` is a process group of the port's (:class:`LocalGloo`)
for ranks of one host, which share a card on the H100 machine: gloo for
barriers and CPU tensors, a CUDA tensor's bytes moved between the ranks'
device buffers (CUDA IPC), so they never cross the host. It serves code
that issues its own collectives too: DTensor's redistributions call the
functional collectives (``torch.distributed._functional_collectives``),
which on a gloo group with CUDA tensors crashed the process on the H100
(PyTorch 2.11). It implements the collectives DTensor and this module
issue and no other (any other raises).

Every rank must issue the same collectives in the same order. The
operations here are autograd functions whose backward issues its own
collectives, so a graph that differs between ranks (a branch that skips
an operation on some ranks) can hang the backward: the callers keep
their graphs alike and branch on the rank only inside an operation.
"""

from __future__ import annotations

import datetime

import torch
import torch.distributed as dist
from torch._C._distributed_c10d import (
    AllgatherOptions,
    AllreduceOptions,
    AllToAllOptions,
    BarrierOptions,
    BroadcastOptions,
    ReduceScatterOptions,
    _create_work_from_future,
)
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


def _contiguous(x: torch.Tensor, group, fresh: bool = False) -> torch.Tensor:
    """``x`` contiguous as the backend takes it (a copy with ``fresh``,
    for an operation that writes its input). A CUDA tensor on a gloo
    group raises: ranks that share a card run over :data:`LOCAL_GLOO`."""
    if x.is_cuda and dist.get_backend(group) == dist.Backend.GLOO:
        raise ValueError(f"a CUDA tensor on a gloo group: ranks that share "
                         f"a card run over {LOCAL_GLOO!r}")
    x = x.contiguous()
    return x.clone() if fresh else x


def shift(x: torch.Tensor, group, step: int) -> torch.Tensor:
    """Send ``x`` to rank ``i + step`` of ``group`` and return what rank
    ``i - step`` sent: the hop without a gradient, for an operation that
    writes its own backward (the ring attention)."""
    n = dist.get_world_size(group)
    if n == 1 or step % n == 0:
        return x
    i = dist.get_rank(group)
    send = _contiguous(x, group)
    recv = torch.empty_like(send)
    ops = [dist.P2POp(dist.isend, send, _peer(group, (i + step) % n), group),
           dist.P2POp(dist.irecv, recv, _peer(group, (i - step) % n), group)]
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    return recv


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
    send = _contiguous(moved.reshape(n, -1, *moved.shape[1:]), group)
    recv = torch.empty_like(send)
    dist.all_to_all_single(recv, send, group=group)
    return torch.cat([recv[i].movedim(0, split_dim) for i in range(n)],
                     dim=concat_dim)


def _all_gather(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    n = dist.get_world_size(group)
    if n == 1:
        return x
    send = _contiguous(x, group).reshape(-1)
    recv = torch.empty(n * send.numel(), dtype=send.dtype, device=send.device)
    dist.all_gather_into_tensor(recv, send, group=group)
    return torch.cat(recv.view(n, *x.shape).unbind(0), dim=dim)


def _all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    buf = _contiguous(x, group, fresh=True)
    dist.all_reduce(buf, group=group)
    return buf


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


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return _all_gather(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        n = dist.get_world_size(ctx.group)
        part = g.chunk(n, dim=ctx.dim)[dist.get_rank(ctx.group)]
        return part.contiguous(), None, None


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


def all_gather(x: torch.Tensor, dim: int, axis=None) -> torch.Tensor:
    """Every rank's ``x`` concatenated along ``dim`` in rank order
    (``lax.all_gather(x, axis, axis=dim, tiled=True)``). Differentiable:
    the backward keeps this rank's part of the cotangent (see the module's
    note)."""
    return _AllGather.apply(x, dim, process_group(axis))


def gather_shards(x: torch.Tensor, groups) -> torch.Tensor:
    """Every shard's ``x`` stacked along a new leading dim in shard order,
    on every rank, without a gradient: ``groups`` split the shards, major
    first (:func:`shard_index` numbers them so)."""
    out = x.detach()[None]
    for group in reversed(list(groups)):  # minor first
        out = _all_gather(out, 0, group)
    return out


def shard_index(groups) -> int:
    """This rank's shard among those ``groups`` split, major first: the
    row-major number of its coordinates along them."""
    index = 0
    for group in groups:
        index = index * dist.get_world_size(group) + dist.get_rank(group)
    return index


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


# -- a process group for the ranks of one host -------------------------------------

LOCAL_GLOO = "gloo_local"


def _completed(tensors) -> dist.Work:
    fut = torch.futures.Future()
    fut.set_result(tensors)
    return _create_work_from_future(fut)


def _accumulator(dtype: torch.dtype) -> torch.dtype:
    """The dtype a reduction of ``dtype`` accumulates in: a floating type
    at least fp32's width, any other its own (an int64 sum stays exact)."""
    if dtype.is_floating_point:
        return torch.promote_types(dtype, torch.float32)
    return dtype


def _reduce_in_order(parts, op) -> torch.Tensor:
    """``parts`` reduced by ``op`` in their order, in :func:`_accumulator`'s
    dtype (the caller casts back): every rank that reduces the same parts
    gets the same bytes. Sum, average, product, maximum and minimum; any
    other op raises."""
    acc = parts[0].to(_accumulator(parts[0].dtype), copy=True)
    if op == dist.ReduceOp.SUM or op == dist.ReduceOp.AVG:
        for part in parts[1:]:
            acc += part
        if op == dist.ReduceOp.AVG:
            if not acc.is_floating_point():
                raise ValueError(f"LocalGloo averages floating tensors, "
                                 f"not {acc.dtype}")
            acc /= len(parts)
        return acc
    combine = {dist.ReduceOp.PRODUCT: torch.mul, dist.ReduceOp.MAX: torch.maximum,
               dist.ReduceOp.MIN: torch.minimum}
    for kind, fn in combine.items():
        if op == kind:
            for part in parts[1:]:
                acc = fn(acc, part.to(acc.dtype))
            return acc
    raise ValueError(f"LocalGloo reduces a CUDA tensor by SUM, AVG, PRODUCT, "
                     f"MAX or MIN, not {op}")


class _Mailboxes:
    """One device buffer a rank, every rank of the group mapping every
    other's through CUDA IPC: the data path of :class:`LocalGloo` for CUDA
    tensors. A collective copies this rank's bytes into its own box,
    waits for the copy, meets the others at a barrier, reads the peers'
    boxes on the device, waits for the reads and meets them again before
    any box is written anew. The boxes grow (every rank at the same call:
    the collectives are symmetric) by publishing new handles through the
    group's store."""

    def __init__(self, store, rank: int, size: int, barrier) -> None:
        self._store, self._rank, self._size = store, rank, size
        self._barrier = barrier
        self._gen = 0
        self._mine: torch.Tensor | None = None
        self._peers: list[torch.Tensor] = []

    def exchange(self, x: torch.Tensor) -> list[torch.Tensor]:
        """Every rank's ``x`` (one shape and dtype on all ranks), as views
        of the boxes, in rank order; :meth:`release` after reading."""
        from multiprocessing.reduction import ForkingPickler  # noqa: PLC0415
        import pickle  # noqa: PLC0415

        flat = x.detach().contiguous().reshape(-1).view(torch.uint8)
        n = flat.numel()
        if self._mine is None or self._mine.numel() < n:
            self._gen += 1
            self._mine = torch.empty(max(n, 1 << 20), dtype=torch.uint8,
                                     device=x.device)
            self._store.set(f"box-{self._gen}-{self._rank}",
                            bytes(ForkingPickler.dumps(self._mine)))
            self._peers = [
                self._mine if r == self._rank else pickle.loads(
                    self._store.get(f"box-{self._gen}-{r}"))
                for r in range(self._size)]
        self._mine[:n].copy_(flat)
        torch.cuda.current_stream(x.device).synchronize()
        self._barrier()
        return [box[:n].view(x.dtype).view(x.shape) for box in self._peers]

    def release(self, device: torch.device) -> None:
        torch.cuda.current_stream(device).synchronize()
        self._barrier()


class LocalGloo(dist.ProcessGroup):
    """A process group for ranks that share one host (four ranks on one
    card, where NCCL refuses): gloo for barriers, and the bytes of a
    CUDA tensor's collective through device buffers every rank maps
    (:class:`_Mailboxes`, CUDA IPC), reduced on the device in rank order
    (:func:`_reduce_in_order`); a CPU tensor's through gloo's own
    collective. Every call waits for its data and returns a completed
    ``Work``.

    Its methods are the collectives DTensor and this module issue
    (all-reduce, all-gather, reduce-scatter, all-to-all, broadcast,
    barrier), under both the names the process group's bindings give
    them, and the symmetric hop of :func:`shift`: every rank sends, then
    receives. A CUDA tensor never goes through the host: a reduction
    :func:`_reduce_in_order` lacks, or an all-to-all with uneven splits,
    raises, as does any other collective. ``counts`` holds
    ``{"<collective> <device type>": [calls, input bytes]}``: a ``cuda``
    entry counts calls through the device buffers, a ``cpu`` one calls
    through gloo."""

    def __init__(self, store, rank: int, size: int,
                 timeout: datetime.timedelta) -> None:
        super().__init__(rank, size)
        self._gloo = dist.ProcessGroupGloo(store, rank, size, timeout)
        self._boxes = _Mailboxes(store, rank, size,
                                 lambda: self._gloo.barrier().wait())
        self._sent: list[torch.Tensor] | None = None
        self.counts: dict[str, list[int]] = {}

    def getBackendName(self) -> str:
        return LOCAL_GLOO

    # The name and description ``new_group`` gives the group. A process
    # group keeps them in its backends, and this one registers none.
    def _set_group_name(self, name: str) -> None:
        self._name = name

    @property
    def group_name(self) -> str:
        return self._name

    def _set_group_desc(self, desc: str) -> None:
        self._desc = desc

    @property
    def group_desc(self) -> str:
        return self._desc

    def _count(self, kind: str, tensors) -> None:
        entry = self.counts.setdefault(f"{kind} {tensors[0].device.type}",
                                       [0, 0])
        entry[0] += 1
        entry[1] += sum(t.numel() * t.element_size() for t in tensors)

    def _gloo_op(self, op: str, outputs, inputs, *args, listed=False):
        """gloo's ``op`` on CPU tensors (``outputs`` as one list argument
        if ``listed``), through contiguous copies where a tensor is not
        contiguous."""
        outs = [t.contiguous() for t in outputs]
        ins = [t.contiguous() for t in inputs]
        call = (outs,) if listed else (*outs, *ins)
        getattr(self._gloo, op)(*call, *args).wait()
        for t, o in zip(outputs, outs):
            if o is not t:
                t.copy_(o)

    # -- the collectives -------------------------------------------------------

    def allreduce(self, tensors, opts=AllreduceOptions()):
        self._count("all_reduce", tensors)
        for t in tensors:
            if t.is_cuda:
                t.copy_(_reduce_in_order(self._boxes.exchange(t),
                                         opts.reduceOp))
                self._boxes.release(t.device)
            else:
                self._gloo_op("allreduce", [t], [], opts, listed=True)
        return _completed(tensors)

    def allreduce_coalesced(self, tensors, opts=AllreduceOptions()):
        return self.allreduce(tensors, opts)

    def _allgather_base(self, output, input, opts=AllgatherOptions()):
        self._count("all_gather", [input])
        if input.is_cuda:
            parts = output.view(self.size(), -1)
            for j, box in enumerate(self._boxes.exchange(input)):
                parts[j].copy_(box.reshape(-1))
            self._boxes.release(input.device)
        else:  # gloo takes the flat bytes: rank j's at j's offset
            self._gloo_op("_allgather_base", [output.view(-1)],
                          [input.reshape(-1)], opts)
        return _completed([output])

    all_gather_single = _allgather_base

    def allgather_into_tensor_coalesced(self, outputs, inputs,
                                        opts=AllgatherOptions()):
        for output, input in zip(outputs, inputs):
            self._allgather_base(output, input, opts)
        return _completed(outputs)

    def allgather(self, output_lists, inputs, opts=AllgatherOptions()):
        for lst, input in zip(output_lists, inputs):
            flat = torch.empty((self.size(), input.numel()), dtype=input.dtype,
                               device=input.device)
            self._allgather_base(flat, input, opts)
            for t, part in zip(lst, flat):
                t.copy_(part.view(t.shape))
        return _completed([t for lst in output_lists for t in lst])

    def _reduce_scatter_base(self, output, input,
                             opts=ReduceScatterOptions()):
        self._count("reduce_scatter", [input])
        if input.is_cuda:
            boxes = self._boxes.exchange(input)
            mine = [box.reshape(self.size(), -1)[self.rank()] for box in boxes]
            output.copy_(_reduce_in_order(mine, opts.reduceOp)
                         .view(output.shape))
            self._boxes.release(input.device)
        else:
            self._gloo_op("_reduce_scatter_base", [output.view(-1)],
                          [input.reshape(-1)], opts)
        return _completed([output])

    reduce_scatter_single = _reduce_scatter_base

    def reduce_scatter_tensor_coalesced(self, outputs, inputs,
                                        opts=ReduceScatterOptions()):
        for output, input in zip(outputs, inputs):
            self._reduce_scatter_base(output, input, opts)
        return _completed(outputs)

    def reduce_scatter(self, outputs, input_lists,
                       opts=ReduceScatterOptions()):
        for output, parts in zip(outputs, input_lists):
            self._reduce_scatter_base(output, torch.stack(parts), opts)
        return _completed(outputs)

    def alltoall_base(self, output, input, output_split_sizes,
                      input_split_sizes, opts=AllToAllOptions()):
        self._count("all_to_all", [input])
        if not input.is_cuda:
            self._gloo_op("alltoall_base", [output], [input],
                          output_split_sizes, input_split_sizes, opts)
            return _completed([output])
        if output_split_sizes or input_split_sizes:
            raise ValueError("LocalGloo's all-to-all of a CUDA tensor takes "
                             "even splits only")
        n, me = self.size(), self.rank()
        parts = output.reshape(n, -1)
        for j, box in enumerate(self._boxes.exchange(input)):
            parts[j].copy_(box.reshape(n, -1)[me])
        self._boxes.release(input.device)
        return _completed([output])

    all_to_all_single = alltoall_base

    def broadcast(self, tensors, opts=BroadcastOptions()):
        self._count("broadcast", tensors)
        for t in tensors:
            if t.is_cuda:
                t.copy_(self._boxes.exchange(t)[opts.rootRank])
                self._boxes.release(t.device)
            else:
                self._gloo_op("broadcast", [t], [], opts, listed=True)
        return _completed(tensors)

    # The symmetric hop: every rank of the group sends one tensor, then
    # receives one of its shape. A CUDA send posts the tensor in this
    # rank's box (every rank at once); the receive reads the sender's box.

    def send(self, tensors, dstRank: int, tag: int = 0):
        self._count("send", tensors)
        if not tensors[0].is_cuda:
            return self._gloo.send(tensors, dstRank, tag)
        if self._sent is not None:
            raise RuntimeError("LocalGloo: a second send before a receive")
        self._sent = self._boxes.exchange(tensors[0])
        return _completed(tensors)

    def recv(self, tensors, srcRank: int, tag: int = 0):
        t = tensors[0]
        if not t.is_cuda:
            return self._gloo.recv(tensors, srcRank, tag)
        sent, self._sent = self._sent, None
        if sent is None or sent[srcRank].shape != t.shape or \
                sent[srcRank].dtype != t.dtype:
            raise RuntimeError("LocalGloo receives a CUDA tensor only as the "
                               "symmetric hop: every rank sends one of the "
                               "same shape and dtype first")
        t.copy_(sent[srcRank])
        self._boxes.release(t.device)
        return _completed(tensors)

    def barrier(self, opts=BarrierOptions()):
        self._gloo.barrier(opts).wait()
        return _completed([])


def register_local_gloo() -> None:
    """Make :data:`LOCAL_GLOO` a backend name ``init_process_group`` and
    ``new_group`` take (once a process)."""
    if LOCAL_GLOO.upper() not in dist.Backend._plugins:
        dist.Backend.register_backend(LOCAL_GLOO, LocalGloo,
                                      devices=["cpu", "cuda"])


def local_gloo_counts(groups) -> dict[str, list[int]]:
    """The summed :attr:`LocalGloo.counts` of ``groups`` (each counted
    once; groups of another backend are skipped)."""
    out: dict[str, list[int]] = {}
    for g in {id(g): g for g in groups}.values():
        for key, (calls, nbytes) in getattr(g, "counts", {}).items():
            entry = out.setdefault(key, [0, 0])
            entry[0] += calls
            entry[1] += nbytes
    return out
