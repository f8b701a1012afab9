"""Serving workload layer: the request-drain serving agentlet.

Counterpart of ``grit_tpu/serving``. :mod:`grit_tpu_torch.serving.adapter`
generalises the training agentlet's quiesce hook into a request-drain hook
for a :class:`~grit_tpu_torch.models.serving.ContinuousBatchingEngine`.
The snapshot fan-out (``grit_tpu/serving/fanout.py``) needs post-copy
restore and comes with it.
"""

from grit_tpu_torch.serving.adapter import (
    ServingAgentlet,
    ServingDrainTimeout,
    ServingDraining,
)

__all__ = ["ServingAgentlet", "ServingDrainTimeout", "ServingDraining"]
