"""Scheduling strategy objects
(reference: python/ray/util/scheduling_strategies.py)."""

from ray_tpu_torch.core.task_spec import (  # noqa: F401
    NodeAffinitySchedulingStrategy,
    PlacementGroupSchedulingStrategy,
)

__all__ = [
    "NodeAffinitySchedulingStrategy",
    "PlacementGroupSchedulingStrategy",
]
