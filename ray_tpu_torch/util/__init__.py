"""ray_tpu_torch.util — utility APIs (reference: python/ray/util/)."""

from ray_tpu_torch.util.placement_group import (  # noqa: F401
    get_placement_group,
    placement_group,
    placement_group_table,
    remove_placement_group,
)
from ray_tpu_torch.util.scheduling_strategies import (  # noqa: F401
    NodeAffinitySchedulingStrategy,
    PlacementGroupSchedulingStrategy,
)
from ray_tpu_torch.util.actor_pool import ActorPool  # noqa: F401
