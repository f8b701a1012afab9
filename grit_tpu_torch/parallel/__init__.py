"""Multi-rank execution over ``torch.distributed``: the collective layer
(``collectives``, with ``LOCAL_GLOO``, the process group of ranks on one
host), the
rank launcher (``launch``), the (data, fsdp, model) device mesh
(``mesh``), the sharding rules that place a state tree on it as DTensors
(``sharding``), the GPipe pipeline (``pipeline``) and slice
coordination, the gang's cut (``coordination``). The JAX package's
``parallel/compat.py`` is a JAX-version shim and has no counterpart."""

from grit_tpu_torch.parallel.collectives import (  # noqa: F401
    LOCAL_GLOO,
    all_to_all,
    axis_index,
    axis_size,
    process_group,
    reduce_sum,
    replicate,
    ring_shift,
)
from grit_tpu_torch.parallel.mesh import AXES, MeshSpec, build_mesh  # noqa: F401
from grit_tpu_torch.parallel.sharding import (  # noqa: F401
    NamedSharding,
    ShardingRules,
    named_sharding,
    shard_tree,
    spec_for,
)
