"""Demand-driven launch planning: bin-pack pending demands over node types.

Reference: python/ray/autoscaler/_private/resource_demand_scheduler.py:56
(get_nodes_to_launch:151). Given

  - node_types: {name: {"resources": {...}, "min_workers", "max_workers"}}
  - currently available capacity per existing node
  - queued task/actor resource demands + placement-group bundle demands

produce {node_type: count} to launch. The packing is vectorized: demands
sort largest-first, each demand first tries the remaining capacity of existing +
already-planned nodes (first-fit), then opens a new node of the
best-scoring type (fewest wasted resources — the reference's
_utilization_score).
"""

from __future__ import annotations

import copy
from typing import Dict, List, Optional, Tuple

import numpy as np

NodeTypes = Dict[str, dict]


def _vec(demand: Dict[str, float], names: List[str]) -> np.ndarray:
    return np.array([float(demand.get(n, 0.0)) for n in names])


def _fits(capacity: np.ndarray, demand: np.ndarray) -> bool:
    return bool(np.all(capacity + 1e-9 >= demand))


def _utilization_score(node_res: np.ndarray, demand: np.ndarray
                       ) -> Optional[float]:
    """Higher = tighter fit (reference: prefers node types the demand
    uses most fully, so big nodes aren't wasted on small demands)."""
    if not _fits(node_res, demand):
        return None
    used = np.minimum(demand, node_res)
    with np.errstate(divide="ignore", invalid="ignore"):
        frac = np.where(node_res > 0, used / node_res, 0.0)
    return float(frac.sum())


def get_nodes_to_launch(
    node_types: NodeTypes,
    existing_nodes: Dict[str, int],
    available_capacity: List[Dict[str, float]],
    resource_demands: List[Dict[str, float]],
    pg_demands: Optional[List[List[Dict[str, float]]]] = None,
    max_workers: int = 100,
) -> Dict[str, int]:
    """Pure planning function — unit-testable with synthetic inputs, like
    the reference's test_resource_demand_scheduler.py drives it."""
    demands = [dict(d) for d in resource_demands]
    for bundles in (pg_demands or []):
        demands.extend(dict(b) for b in bundles)
    # strip PG shadow resources back to their base names so the planner
    # reasons in physical capacity (CPU_group_xxx -> CPU)
    demands = [_strip_pg_shadows(d) for d in demands]
    demands = [d for d in demands if d]
    if not demands:
        return _min_workers_to_launch(node_types, existing_nodes,
                                      max_workers)

    names = sorted({n for d in demands for n in d} |
                   {n for t in node_types.values()
                    for n in t.get("resources", {})})
    cap = [_vec(c, names) for c in available_capacity]
    dvecs = sorted((_vec(d, names) for d in demands),
                   key=lambda v: -float(v.sum()))

    to_launch: Dict[str, int] = {}
    planned_cap: List[np.ndarray] = []
    total_existing = sum(existing_nodes.values())

    def launched_of(t: str) -> int:
        return existing_nodes.get(t, 0) + to_launch.get(t, 0)

    for demand in dvecs:
        placed = False
        for pool in (cap, planned_cap):
            for c in pool:
                if _fits(c, demand):
                    c -= demand
                    placed = True
                    break
            if placed:
                break
        if placed:
            continue
        # open a new node of the best-fitting type
        best_type, best_score = None, None
        for tname, tcfg in node_types.items():
            if launched_of(tname) >= tcfg.get("max_workers", max_workers):
                continue
            if total_existing + sum(to_launch.values()) >= max_workers:
                break
            node_res = _vec(tcfg.get("resources", {}), names)
            score = _utilization_score(node_res, demand)
            if score is not None and (best_score is None
                                      or score > best_score):
                best_type, best_score = tname, score
        if best_type is None:
            continue  # infeasible on every launchable type
        to_launch[best_type] = to_launch.get(best_type, 0) + 1
        node_res = _vec(node_types[best_type].get("resources", {}), names)
        planned_cap.append(node_res - demand)

    # top up min_workers
    for tname, count in _min_workers_to_launch(
            node_types,
            {t: launched_of(t) for t in node_types},
            max_workers).items():
        to_launch[tname] = to_launch.get(tname, 0) + count
    return to_launch


def _min_workers_to_launch(node_types: NodeTypes,
                           existing_nodes: Dict[str, int],
                           max_workers: int) -> Dict[str, int]:
    out: Dict[str, int] = {}
    for tname, tcfg in node_types.items():
        want = tcfg.get("min_workers", 0)
        have = existing_nodes.get(tname, 0)
        if want > have:
            out[tname] = min(want - have, max_workers)
    return out


def _strip_pg_shadows(demand: Dict[str, float]) -> Dict[str, float]:
    out: Dict[str, float] = {}
    for name, amount in demand.items():
        base = name.split("_group_")[0] if "_group_" in name else name
        if base == "bundle":
            continue
        out[base] = out.get(base, 0.0) + amount
    return out
