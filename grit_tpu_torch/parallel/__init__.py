"""Multi-rank execution over ``torch.distributed``: the collective layer
(``collectives``), the rank launcher (``launch``), the GPipe pipeline
(``pipeline``) and slice coordination, the gang's cut (``coordination``).
The JAX package's ``parallel/compat.py`` is a JAX-version shim and has no
counterpart; its mesh and sharding are not ported yet."""

from grit_tpu_torch.parallel.collectives import (  # noqa: F401
    all_to_all,
    axis_index,
    axis_size,
    process_group,
    reduce_sum,
    replicate,
    ring_shift,
)
