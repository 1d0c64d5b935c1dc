"""ray_tpu_torch.autoscaler — demand-driven cluster scaling.

Reference: ``python/ray/autoscaler/`` — ``StandardAutoscaler``
(``_private/autoscaler.py``) + ``resource_demand_scheduler.py``
(bin-packing pending demand onto node types) + the ``NodeProvider`` ABC
with the testable ``FakeMultiNodeProvider``
(``_private/fake_multi_node/node_provider.py:236``).

TPU-first: a node type may be a SLICE — ``hosts > 1`` launches that many
hosts atomically (a TPU pod slice is one schedulable unit; scaling half
a slice is meaningless).
"""

from ray_tpu_torch.autoscaler.autoscaler import StandardAutoscaler
from ray_tpu_torch.autoscaler.config import AutoscalerConfig, NodeTypeConfig
from ray_tpu_torch.autoscaler.provider import FakeMultiNodeProvider, NodeProvider

__all__ = [
    "AutoscalerConfig",
    "FakeMultiNodeProvider",
    "NodeProvider",
    "NodeTypeConfig",
    "StandardAutoscaler",
]
