"""Multi-rank execution over ``torch.distributed``: the collective layer
(``collectives``), the rank launcher (``launch``) and the GPipe pipeline
(``pipeline``). The JAX package's ``parallel/compat.py`` is a JAX-version
shim and has no counterpart; its mesh, sharding and slice coordination
are not ported yet."""

from grit_tpu_torch.parallel.collectives import (  # noqa: F401
    all_to_all,
    axis_index,
    axis_size,
    process_group,
    reduce_sum,
    replicate,
    ring_shift,
)
