"""Parameter and activation sharding rules: path pattern → partition spec.

Counterpart of ``grit_tpu/parallel/sharding.py``. Partitioning is an
ordered table of ``(regex, spec)`` rules matched against a leaf's path
(``"layers/attn/wq"``): a model declares one table, :func:`shard_tree`
applies it under any mesh, and the same table drives both a fresh
initialisation and a snapshot's restore.

A *spec* is a tuple as ``jax.sharding.PartitionSpec`` holds it: entry
``d`` names the mesh axis that shards tensor dim ``d`` (a tuple of names
shards it over several axes, major first; ``None`` leaves it whole), and
dims past the spec's end are whole. On the port's side a spec becomes
DTensor placements (:func:`placements`): the mesh dim of an axis named
at tensor dim ``d`` is ``Shard(d)``, every other mesh dim
``Replicate()``.

Two rules are the JAX package's: a dim must divide by the product of the
axes that shard it (``jax.sharding.NamedSharding`` raises otherwise),
and an axis shards at most one dim. One is the port's own: DTensor
splits a dim sharded over several mesh dims in mesh-dim order, so a
tuple must list its axes in mesh order (``("data", "fsdp")``, never
``("fsdp", "data")``); another order raises rather than transpose the
shards silently.

A DTensor carries the :class:`NamedSharding` that placed it (:func:`tag`;
``distribute``, ``zeros`` and :func:`like_dtensor` set it), and
:func:`sharding_of` reads it back, as the JAX package reads
``arr.sharding``: a snapshot needs no ``shardings=`` to describe a
sharded leaf, axes of size 1 included, which placements alone cannot
name. A DTensor without one (a pending reduction, a mesh the port did
not build, a copy) raises.

A mesh with the pipe axis (:data:`~grit_tpu_torch.parallel.mesh.PIPE_AXIS`,
a pipeline's mesh: ``pipe`` alone, or with ``data`` and ``expert``)
holds no DTensor: each rank holds its shard of every leaf as a plain
tensor, every split its spec names cut (a staged expert weight's
experts over ``expert``); a leaf whose spec starts with ``pipe`` is
stacked over the stages, and the rank's shard drops that dim (the
port's one-process-a-rank ``stage_slice``). :meth:`NamedSharding.distribute`,
:meth:`~NamedSharding.zeros`, :meth:`~NamedSharding.held_shape` and
:meth:`~NamedSharding.global_shape` agree on that shard. The spec, the
descriptor and the chunk index are the stacked array's, as the JAX
package's.
"""

from __future__ import annotations

import math
import re
import sys
from dataclasses import dataclass, field
from typing import TYPE_CHECKING, Any

import torch
from torch.distributed.device_mesh import DeviceMesh

from grit_tpu_torch.parallel.mesh import (
    PIPE_AXIS,
    active_mesh,
    is_pipe_mesh,
)

if TYPE_CHECKING:
    from torch.distributed.tensor import DTensor, Placement
from grit_tpu_torch.tree import map_with_names

_PART = re.compile(r"\['((?:[^'\\]|\\.)*)'\]|\[(\d+)\]|(\.\w+)")


def path_str(name: str) -> str:
    """The JAX package's rule path of a leaf from its ``keystr`` name:
    ``"['layers']['attn']['wq']"`` → ``"layers/attn/wq"``; a sequence index
    stays a number and a named-tuple field keeps its dot
    (``"['opt_state'][0].mu"`` → ``"opt_state/0/.mu"``), as
    ``grit_tpu.parallel.sharding._path_str`` spells them."""
    parts = []
    for m in _PART.finditer(name):
        key, idx, attr = m.groups()
        parts.append(key if key is not None else idx if idx is not None
                     else attr)
    return "/".join(parts)


@dataclass
class ShardingRules:
    """Ordered first-match rule table."""

    rules: list[tuple[str, tuple]] = field(default_factory=list)
    default: tuple = ()

    def spec_for(self, path: str) -> tuple:
        for pattern, spec in self.rules:
            if re.search(pattern, path):
                return spec
        return self.default

    def tree_specs(self, tree) -> Any:
        """A tree of specs shaped like ``tree`` (its leaves' paths are
        their names in ``tree``)."""
        return map_with_names(lambda name, _leaf: self.spec_for(path_str(name)),
                              tree)

    def tree_shardings(self, tree, mesh: DeviceMesh) -> Any:
        """A tree of :class:`NamedSharding` on ``mesh`` shaped like
        ``tree``: each leaf's spec from the table."""
        return map_with_names(
            lambda name, _leaf: NamedSharding(mesh, self.spec_for(
                path_str(name))), tree)


def spec_for(rules: ShardingRules, tree) -> Any:
    return rules.tree_specs(tree)


def _axes_of(entry) -> tuple:
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, (tuple, list)) else (entry,)


def _check(spec: tuple, mesh: DeviceMesh, ndim: int) -> None:
    names = mesh.mesh_dim_names
    if len(spec) > ndim:
        raise ValueError(f"spec {spec} has more entries than the tensor's "
                         f"{ndim} dims")
    seen: list[str] = []
    for d, entry in enumerate(spec):
        axes = _axes_of(entry)
        for a in axes:
            if a not in names:
                raise ValueError(f"spec {spec} names axis {a!r}, which the "
                                 f"mesh {names} lacks")
            if a in seen:
                raise ValueError(f"spec {spec} uses axis {a!r} twice")
            seen.append(a)
        if PIPE_AXIS in axes and (d or len(axes) > 1):
            raise ValueError(f"spec {spec}: the pipe axis shards the "
                             "stacked stage dim alone, dim 0")
        order = [names.index(a) for a in axes]
        if order != sorted(order):
            raise ValueError(
                f"spec entry {entry} lists its axes out of mesh order "
                f"{names}: DTensor would split the dim in mesh order, not "
                "in the entry's")


def _index(shape, sizes, coord, dims: list[list[int]],
           what) -> list[list[int]]:
    """The slice at mesh coordinate ``coord`` of a ``shape`` tensor whose
    dim ``d`` is split over the mesh dims ``dims[d]``, major first (dims
    past ``dims``' end are whole). A dim must divide by the product of its
    mesh dims' sizes, as ``jax.sharding.NamedSharding`` requires."""
    out = [[0, int(n)] for n in shape]
    for d, mesh_dims in enumerate(dims):
        parts = math.prod(sizes[i] for i in mesh_dims)
        if shape[d] % parts:
            raise ValueError(f"sharding {what} splits dim {d} of "
                             f"{tuple(shape)} {parts} ways, which does not "
                             "divide it")
        pos = 0
        for i in mesh_dims:  # major first
            pos = pos * sizes[i] + coord[i]
        step = shape[d] // parts
        out[d] = [pos * step, (pos + 1) * step]
    return out


def is_dtensor(x) -> bool:
    """Whether ``x`` is a DTensor. Answered without importing DTensor's
    module, whose import lengthens a process's start and which a dense
    workload never needs: no DTensor exists in a process that has not
    imported it."""
    mod = sys.modules.get("torch.distributed.tensor")
    return mod is not None and isinstance(x, mod.DTensor)


def local_shard(x: torch.Tensor) -> torch.Tensor:
    """The tensor ``x``'s bytes live in on this rank: a DTensor's local
    shard (its memory: an in-place update of it updates the DTensor),
    else ``x``."""
    return x.to_local() if is_dtensor(x) else x


def dtensor_index(x: DTensor) -> list[list[int]]:
    """``[[start, stop], ...]`` of this rank's shard of the DTensor ``x`` in
    its global array (the restore's target slice)."""
    mesh = x.device_mesh
    return _index(x.shape, mesh.shape, mesh.get_coordinate(),
                  [[i for i, p in enumerate(x.placements) if p.is_shard(d)]
                   for d in range(x.dim())], x.placements)


def like_dtensor(local: torch.Tensor, like: DTensor) -> DTensor:
    """``local``, this rank's shard, as a DTensor of ``like``'s mesh,
    placements, shape and stride (no communication), carrying its
    sharding (:func:`tag`)."""
    from torch.distributed.tensor import DTensor  # noqa: PLC0415

    out = DTensor.from_local(local, like.device_mesh, like.placements,
                             run_check=False, shape=like.shape,
                             stride=like.stride())
    held = getattr(like, _TAG, None)
    return tag(out, held) if held is not None else out


# The NamedSharding a DTensor was placed by (jax.Array.sharding's role).
_TAG = "_grit_named_sharding"


def tag(x: torch.Tensor, sharding: "NamedSharding") -> torch.Tensor:
    """Record on the DTensor ``x`` the sharding that placed it, which
    :func:`sharding_of` reads back; returns ``x``."""
    setattr(x, _TAG, sharding)
    return x


def sharding_of(x: DTensor) -> "NamedSharding":
    """The :class:`NamedSharding` of the DTensor ``x``, as the JAX package
    takes a leaf's from ``arr.sharding``: the one that placed it
    (:func:`tag`). Raises ``ValueError`` for a DTensor that carries none
    (a pending reduction, a mesh the port did not build, a copy such as
    ``detach()`` or an operator's result): its placements alone cannot
    name the axes of size 1."""
    held = getattr(x, _TAG, None)
    if held is None:
        raise ValueError(
            f"cannot describe a DTensor placed {tuple(x.placements)} on "
            f"{x.device_mesh}: it carries no sharding (distribute, zeros "
            "and like_dtensor give one; a copy or an operator's result "
            "does not)")
    return held


def spec_from_descriptor(desc: dict) -> tuple:
    """A ``named`` descriptor's spec as a spec tuple (lists → tuples)."""
    return tuple(tuple(e) if isinstance(e, list) else e
                 for e in desc["spec"])


def placements(spec: tuple, mesh: DeviceMesh, ndim: int) -> tuple[Placement, ...]:
    """DTensor placements of ``spec`` on ``mesh``, one per mesh dim: the
    mesh dim of an axis named at tensor dim ``d`` is ``Shard(d)``, every
    other ``Replicate()``. Axes of the full (data, fsdp, model) mesh that
    ``mesh`` (an :func:`~grit_tpu_torch.parallel.mesh.active_mesh`) lacks
    have size 1 and are left out."""
    from torch.distributed.tensor import Replicate, Shard  # noqa: PLC0415

    out: list[Placement] = [Replicate()] * mesh.ndim
    names = mesh.mesh_dim_names
    for d, entry in enumerate(spec):
        for a in _axes_of(entry):
            if a in names:
                out[names.index(a)] = Shard(d)
    return tuple(out)


@dataclass(frozen=True)
class NamedSharding:
    """A spec on the full (data, fsdp, model) mesh: where a leaf's shards
    go (``jax.sharding.NamedSharding``'s counterpart)."""

    mesh: DeviceMesh
    spec: tuple = ()

    def __post_init__(self) -> None:
        _check(self.spec, self.mesh, len(self.spec))

    @property
    def active(self) -> DeviceMesh:
        return active_mesh(self.mesh)

    @property
    def stage(self) -> bool:
        """A pipe-axis leaf: stacked over the stages, each rank holding
        its stage with the stacked dim dropped."""
        return bool(self.spec) and _axes_of(self.spec[0]) == (PIPE_AXIS,)

    def global_shape(self, local_shape) -> list[int]:
        """The array's shape of a leaf this rank holds as ``local_shape``:
        on a pipe mesh (a plain shard) each dim times the axes that split
        it, a stage leaf's stacked dim restored; otherwise it is its
        own."""
        shape = [int(d) for d in local_shape]
        if not is_pipe_mesh(self.mesh):
            return shape
        if self.stage:
            shape = [1] + shape
        names = self.mesh.mesh_dim_names
        entries = [*self.spec, *[None] * (len(shape) - len(self.spec))]
        return [d * math.prod(self.mesh.size(names.index(a))
                              for a in _axes_of(entry))
                for d, entry in zip(shape, entries)]

    def held_shape(self, index: list[list[int]]) -> list[int]:
        """The shape a rank holds of the shard at ``index``: the shard's,
        with a stage leaf's stacked dim dropped."""
        shape = [b - a for a, b in index]
        return shape[1:] if self.stage else shape

    def placements(self, ndim: int) -> tuple[Placement, ...]:
        _check(self.spec, self.mesh, ndim)
        return placements(self.spec, self.active, ndim)

    def shard_index(self, shape, coordinate=None) -> list[list[int]]:
        """``[[start, stop], ...]`` of the shard at ``coordinate`` (a full
        mesh coordinate; default this rank's) of a ``shape`` tensor:
        ``NamedSharding.devices_indices_map``'s slice for that device.
        Raises, as the JAX package does, when a dim does not divide by its
        axes' product."""
        _check(self.spec, self.mesh, len(shape))
        names = self.mesh.mesh_dim_names
        return _index(shape, self.mesh.shape,
                      (self.mesh.get_coordinate() if coordinate is None
                       else coordinate),
                      [[names.index(a) for a in _axes_of(entry)]
                       for entry in self.spec], self.spec)

    def writes(self, coordinate=None) -> bool:
        """Whether the rank at ``coordinate`` (default this rank) writes
        its shard in a dump: only the replica at coordinate 0 along every
        mesh dim that does not shard the leaf (the JAX package's
        ``replica_id == 0``), so each distinct shard is written once."""
        used = {a for entry in self.spec for a in _axes_of(entry)}
        coord = (self.mesh.get_coordinate() if coordinate is None
                 else coordinate)
        return all(c == 0 for name, c in zip(self.mesh.mesh_dim_names, coord)
                   if name not in used)

    def descriptor(self) -> dict:
        """The snapshot manifest's ``sharding`` entry, as the JAX package
        writes it: lists for tuples, ``null`` for ``None``."""
        return {"type": "named",
                "mesh_shape": [int(k) for k in self.mesh.shape],
                "mesh_axes": list(self.mesh.mesh_dim_names),
                "spec": [list(e) if isinstance(e, (tuple, list)) else e
                         for e in self.spec]}

    def shards(self) -> bool:
        """Whether the spec splits any dim (else every rank holds the leaf
        whole)."""
        return any(_axes_of(entry) for entry in self.spec)

    def zeros(self, shape, dtype: torch.dtype, device) -> torch.Tensor:
        """A DTensor of this sharding whose local shard is zeros on
        ``device`` (``"meta"``: a shape skeleton): nothing of the whole
        tensor is ever allocated. On a pipe mesh, the plain tensor a rank
        holds (:meth:`distribute`'s shard)."""
        index = self.shard_index(shape)
        if is_pipe_mesh(self.mesh):
            return torch.zeros(self.held_shape(index), dtype=dtype,
                               device=device)
        from torch.distributed.tensor import DTensor  # noqa: PLC0415

        local = torch.zeros([b - a for a, b in index], dtype=dtype,
                            device=device)
        stride = torch.empty(shape, device="meta").stride()
        return tag(DTensor.from_local(local, self.active,
                                      self.placements(len(shape)),
                                      run_check=False,
                                      shape=torch.Size(shape),
                                      stride=stride), self)

    def distribute(self, x: torch.Tensor) -> torch.Tensor:
        """``x``, which every rank holds whole and alike, as a DTensor of
        this sharding: each rank keeps its own shard (no communication).
        On a pipe mesh, the plain tensor a rank holds: a copy of its shard
        (a stage leaf's with the stacked dim dropped), or ``x`` itself
        when the spec splits nothing."""
        index = self.shard_index(x.shape)  # the divisibility check
        if is_pipe_mesh(self.mesh):
            if not self.shards():
                return x
            part = x[tuple(slice(a, b) for a, b in index)]
            return (part[0] if self.stage else part).clone()
        from torch.distributed.tensor import distribute_tensor  # noqa: PLC0415

        return tag(distribute_tensor(x, self.active,
                                     self.placements(x.dim()),
                                     src_data_rank=None), self)


def named_sharding(mesh: DeviceMesh, *spec) -> NamedSharding:
    return NamedSharding(mesh, tuple(spec))


def shard_tree(tree, mesh: DeviceMesh, rules: ShardingRules):
    """Every leaf of ``tree`` as a DTensor on ``mesh`` per the rule table
    (every rank passes the same tree)."""
    return map_with_names(
        lambda name, x: NamedSharding(
            mesh, rules.spec_for(path_str(name))).distribute(x), tree)
