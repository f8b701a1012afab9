"""Serving workload layer: the request-drain serving agentlet and the
snapshot fan-out.

Counterpart of ``grit_tpu/serving``. :mod:`grit_tpu_torch.serving.adapter`
generalises the training agentlet's quiesce hook into a request-drain hook
for a :class:`~grit_tpu_torch.models.serving.ContinuousBatchingEngine`;
:mod:`grit_tpu_torch.serving.fanout` restores one snapshot into several
clone engines by post-copy, each serving before its KV cache has landed.
"""

from grit_tpu_torch.serving.adapter import (
    ServingAgentlet,
    ServingDrainTimeout,
    ServingDraining,
)
from grit_tpu_torch.serving.fanout import CloneLeg, fan_out_clones

__all__ = ["CloneLeg", "ServingAgentlet", "ServingDrainTimeout",
           "ServingDraining", "fan_out_clones"]
