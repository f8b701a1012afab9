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
"""

from __future__ import annotations

import math
import re
import sys
from dataclasses import dataclass, field
from typing import TYPE_CHECKING, Any

import torch
from torch.distributed.device_mesh import DeviceMesh

from grit_tpu_torch.parallel.mesh import active_mesh

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
    for entry in spec:
        axes = _axes_of(entry)
        for a in axes:
            if a not in names:
                raise ValueError(f"spec {spec} names axis {a!r}, which the "
                                 f"mesh {names} lacks")
            if a in seen:
                raise ValueError(f"spec {spec} uses axis {a!r} twice")
            seen.append(a)
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
    placements, shape and stride (no communication)."""
    from torch.distributed.tensor import DTensor  # noqa: PLC0415

    return DTensor.from_local(local, like.device_mesh, like.placements,
                              run_check=False, shape=like.shape,
                              stride=like.stride())


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

    def zeros(self, shape, dtype: torch.dtype, device) -> DTensor:
        """A DTensor of this sharding whose local shard is zeros on
        ``device`` (``"meta"``: a shape skeleton): nothing of the whole
        tensor is ever allocated."""
        from torch.distributed.tensor import DTensor  # noqa: PLC0415

        local = torch.zeros([b - a for a, b in self.shard_index(shape)],
                            dtype=dtype, device=device)
        stride = torch.empty(shape, device="meta").stride()
        return DTensor.from_local(local, self.active,
                                  self.placements(len(shape)),
                                  run_check=False, shape=torch.Size(shape),
                                  stride=stride)

    def distribute(self, x: torch.Tensor) -> DTensor:
        """``x``, which every rank holds whole and alike, as a DTensor of
        this sharding: each rank keeps its own shard (no communication)."""
        from torch.distributed.tensor import distribute_tensor  # noqa: PLC0415

        self.shard_index(x.shape)  # the divisibility check
        return distribute_tensor(x, self.active, self.placements(x.dim()),
                                 src_data_rank=None)


def named_sharding(mesh: DeviceMesh, *spec) -> NamedSharding:
    return NamedSharding(mesh, tuple(spec))


def shard_tree(tree, mesh: DeviceMesh, rules: ShardingRules):
    """Every leaf of ``tree`` as a DTensor on ``mesh`` per the rule table
    (every rank passes the same tree)."""
    return map_with_names(
        lambda name, x: NamedSharding(
            mesh, rules.spec_for(path_str(name))).distribute(x), tree)
