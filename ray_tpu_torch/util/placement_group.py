"""User-facing placement group API
(reference: python/ray/util/placement_group.py)."""

from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional

from ray_tpu_torch._private.ids import PlacementGroupID
from ray_tpu_torch.core import runtime as rt_mod
from ray_tpu_torch.scheduler.placement_group import (
    VALID_STRATEGIES,
    PlacementGroup,
    PlacementGroupState,
)

__all__ = [
    "placement_group",
    "remove_placement_group",
    "get_placement_group",
    "placement_group_table",
    "PlacementGroup",
]


def _manager():
    rt = rt_mod.global_runtime
    if rt is None or rt.is_shutdown:
        from ray_tpu_torch.core.api import init

        rt = init()
    return rt.pg_manager


def placement_group(bundles: List[Dict[str, float]], strategy: str = "PACK",
                    name: str = "", lifetime: Optional[str] = None,
                    _capture_child_tasks: bool = False) -> PlacementGroup:
    if strategy not in VALID_STRATEGIES:
        raise ValueError(
            f"invalid strategy {strategy!r}; one of {VALID_STRATEGIES}")
    if not bundles:
        raise ValueError("placement group requires at least one bundle")
    for bundle in bundles:
        if not isinstance(bundle, dict) or not bundle:
            raise ValueError(f"invalid bundle {bundle!r}")
        if any(v < 0 for v in bundle.values()):
            raise ValueError(f"negative resource in bundle {bundle!r}")
    rt = rt_mod.global_runtime
    if rt is None or rt.is_shutdown:
        from ray_tpu_torch.core.api import init

        rt = init()
    pg = PlacementGroup(
        id=PlacementGroupID.of(rt.job_id),
        bundles=[dict(b) for b in bundles],
        strategy=strategy,
        name=name,
        lifetime=lifetime,
        capture_child_tasks=_capture_child_tasks,
    )
    rt.pg_manager.create(pg)
    return pg


def remove_placement_group(pg: PlacementGroup) -> None:
    _manager().remove(pg.id)


def get_placement_group(name: str) -> PlacementGroup:
    pg = _manager().get_by_name(name)
    if pg is None:
        raise ValueError(f"no placement group named {name!r}")
    return pg


def placement_group_table() -> Dict[str, dict]:
    return _manager().table()
