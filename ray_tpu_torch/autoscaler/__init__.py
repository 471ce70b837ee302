"""ray_tpu_torch.autoscaler — demand-driven cluster scaling.

Reference surface: python/ray/autoscaler/ (StandardAutoscaler, the
NodeProvider plugin API, the resource-demand bin-packing scheduler, and
the fake multi-node provider for tests).
"""

from ray_tpu_torch.autoscaler.autoscaler import Monitor, StandardAutoscaler  # noqa: F401
from ray_tpu_torch.autoscaler.load_metrics import LoadMetrics  # noqa: F401
from ray_tpu_torch.autoscaler.node_provider import (  # noqa: F401
    ClusterNodeProvider,
    FakeMultiNodeProvider,
    NodeProvider,
)
from ray_tpu_torch.autoscaler.resource_demand_scheduler import (  # noqa: F401
    get_nodes_to_launch,
)
from ray_tpu_torch.autoscaler.commands import (  # noqa: F401
    ProcessNodeProvider,
    create_or_update_cluster,
    get_head_node_ip,
    get_worker_node_ips,
    load_cluster_config,
    register_node_provider,
    teardown_cluster,
)

__all__ = [
    "StandardAutoscaler", "Monitor", "LoadMetrics", "NodeProvider",
    "FakeMultiNodeProvider", "ClusterNodeProvider", "get_nodes_to_launch",
    "ProcessNodeProvider", "create_or_update_cluster", "teardown_cluster",
    "get_head_node_ip", "get_worker_node_ips", "load_cluster_config",
    "register_node_provider",
]
