"""Device-mesh construction over ``torch.distributed``.

Counterpart of ``grit_tpu/parallel/mesh.py``, with the same axes,
outermost to innermost:

- ``data``  — pure data parallelism; gradients all-reduced.
- ``fsdp``  — data parallelism with sharded parameters and optimizer
  state (ZeRO-3): parameters gathered for use, gradients
  reduce-scattered.
- ``model`` — tensor parallelism (Megatron style); activations reduced.

All three axes always exist (size 1 when unused), so partition specs and
the sharding descriptors a snapshot records stay stable as a job is
re-laid-out: restoring a dp=8 snapshot onto a dp=4×fsdp=2 mesh is a
sharding change, not a format change.

A pipelined job runs on a mesh of its own, one ``pipe`` axis of one rank
a stage (:func:`build_pipe_mesh`, the JAX package's ``pipe_mesh``), or
``pipe`` between ``data`` and ``expert`` (the JAX dryrun's pp × ep
mesh). Its state is never a DTensor: each rank holds its shard of every
leaf, a stacked layer leaf's stage dim dropped
(``pipeline_llama.stage_slice``, and the experts over ``expert``), and
the pipeline's and the expert layer's own collectives run the step; the
mesh gives a snapshot its descriptors and each rank its chunk
(:mod:`grit_tpu_torch.parallel.sharding`).

The mesh is a ``DeviceMesh`` of one process per device (rank), over the
default process group, which the caller initialises. DTensors live on
its :func:`active_mesh`, the sub-mesh of the axes larger than 1: an
axis of size 1 shards nothing, and DTensor's sharding propagation
searches over every mesh dim it is given.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from grit_tpu_torch.device.placement import resolve_device

DATA_AXIS = "data"
FSDP_AXIS = "fsdp"
MODEL_AXIS = "model"
AXES = (DATA_AXIS, FSDP_AXIS, MODEL_AXIS)
PIPE_AXIS = "pipe"
EXPERT_AXIS = "expert"
DATA_PIPE_EXPERT = (DATA_AXIS, PIPE_AXIS, EXPERT_AXIS)  # a pp × ep mesh


@dataclass(frozen=True)
class MeshSpec:
    """Logical decomposition of the ranks. ``data = -1`` absorbs the
    ranks left over."""

    data: int = -1
    fsdp: int = 1
    model: int = 1

    def resolve(self, n_devices: int) -> tuple[int, int, int]:
        data, fsdp, model = self.data, self.fsdp, self.model
        fixed = fsdp * model
        if data == -1:
            if n_devices % fixed:
                raise ValueError(
                    f"{n_devices} devices not divisible by fsdp*model={fixed}"
                )
            data = n_devices // fixed
        if data * fixed != n_devices:
            raise ValueError(
                f"mesh {data}x{fsdp}x{model} != {n_devices} devices"
            )
        return data, fsdp, model


def build_mesh(spec: MeshSpec | None = None,
               device: torch.device | str | None = None) -> DeviceMesh:
    """A ``DeviceMesh`` with axes (data, fsdp, model) over the ranks of the
    default process group, in rank order (the innermost axis, ``model``,
    pairs neighbouring ranks). ``device`` gives the device type: by default
    CUDA (with no GPU that raises: pass ``"cpu"``)."""
    spec = spec or MeshSpec()
    shape = spec.resolve(dist.get_world_size())
    return init_device_mesh(resolve_device(device).type, shape,
                            mesh_dim_names=AXES)


def build_pipe_mesh(device: torch.device | str | None = None, *,
                    data: int | None = None,
                    expert: int | None = None) -> DeviceMesh:
    """A one-axis ``DeviceMesh`` named ``pipe`` over the default process
    group's ranks in rank order: rank ``s`` is stage ``s``.

    ``data`` and ``expert`` (sizes; 1 keeps its axis) add those axes
    around ``pipe``, which takes the ranks left over: the axes given of
    (data, pipe, expert), outermost first, over the ranks in rank order
    (the JAX dryrun's ``Mesh(devices.reshape(data, pipe, expert),
    ("data", "pipe", "expert"))``; ``expert`` alone is the JAX test's
    (pipe, expert) mesh)."""
    n = dist.get_world_size()
    given = {DATA_AXIS: data, EXPERT_AXIS: expert}
    fixed = math.prod(k for k in given.values() if k is not None)
    if min([k for k in given.values() if k is not None], default=1) < 1 \
            or n % fixed:
        raise ValueError(f"{n} ranks do not split into data={data}, "
                         f"expert={expert} and a pipe axis")
    sizes = {DATA_AXIS: data, PIPE_AXIS: n // fixed, EXPERT_AXIS: expert}
    names = tuple(a for a in DATA_PIPE_EXPERT if sizes[a] is not None)
    return init_device_mesh(resolve_device(device).type,
                            tuple(sizes[a] for a in names),
                            mesh_dim_names=names)


def is_pipe_mesh(mesh: DeviceMesh) -> bool:
    """Whether ``mesh`` is a pipeline's (it has a ``pipe`` axis): its
    state stays plain tensors, a stage a rank."""
    return PIPE_AXIS in (mesh.mesh_dim_names or ())


def active_mesh(mesh: DeviceMesh) -> DeviceMesh:
    """The sub-mesh of ``mesh``'s axes larger than 1 (its innermost axis
    when every one is 1): where the DTensors of a sharded state live."""
    names = [n for n, k in zip(mesh.mesh_dim_names, mesh.shape) if k > 1]
    names = names or [mesh.mesh_dim_names[-1]]
    if len(names) == mesh.ndim:
        return mesh
    return mesh[tuple(names)] if len(names) > 1 else mesh[names[0]]


def axis_groups(mesh: DeviceMesh, names) -> list:
    """The process groups of ``mesh``'s axes among ``names`` that are larger
    than 1, in mesh order (major first): the groups that split what those
    axes shard."""
    return [mesh.get_group(n) for n, k in zip(mesh.mesh_dim_names, mesh.shape)
            if n in names and k > 1]
