"""Placement groups: gang-scheduling bundles of resources.

Re-implements the reference's placement-group plane:
  - the GCS-side packer (gcs/gcs_server/gcs_placement_group_scheduler.cc
    GcsScheduleStrategy subclasses; gcs_resource_scheduler.cc
    LeastResourceScorer) as a *vectorized* solve: bundle x node demand
    matrices scored in one shot, then a strategy-specific masked greedy
    assignment;
  - the raylet-side 2-phase commit of bundle resources
    (raylet/placement_group_resource_manager.h:51 Prepare/Commit/Return)
    including the shadow resources tasks schedule against
    (``<R>_group_<index>_<pgid>`` / ``<R>_group_<pgid>``);
  - the user API surface (python/ray/util/placement_group.py).

The strategies (common.proto PlacementStrategy):
  PACK          bundles together, as few nodes as possible (soft)
  SPREAD        bundles apart, best-effort
  STRICT_PACK   all bundles on one node, or fail
  STRICT_SPREAD every bundle on a distinct node, or fail
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from enum import Enum
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ray_tpu_torch._private.ids import NodeID, PlacementGroupID
from ray_tpu_torch.exceptions import PlacementGroupError
from ray_tpu_torch.scheduler.resources import ResourceRequest, to_fixed

VALID_STRATEGIES = ("PACK", "SPREAD", "STRICT_PACK", "STRICT_SPREAD")


class PlacementGroupState(Enum):
    PENDING = 0
    CREATED = 1
    REMOVED = 2
    RESCHEDULING = 3


def _pg_hex(pg_id) -> str:
    # accepts a PlacementGroupID or an already-hex string (process tier)
    return pg_id if isinstance(pg_id, str) else pg_id.hex()


def bundle_resource_name(resource: str, pg_id: PlacementGroupID,
                         bundle_index: Optional[int] = None) -> str:
    """Shadow-resource naming, matching the reference's
    FormatPlacementGroupResource (bundle_spec.cc)."""
    if bundle_index is None:
        return f"{resource}_group_{_pg_hex(pg_id)}"
    return f"{resource}_group_{bundle_index}_{_pg_hex(pg_id)}"


def shadow_resources_for_bundle(bundle: Dict[str, float],
                                pg_id: PlacementGroupID,
                                bundle_index: int) -> Dict[str, float]:
    """Capacities a node gains when a bundle commits: per-index names plus
    the wildcard names that sum across bundles on that node."""
    out: Dict[str, float] = {}
    for resource, amount in bundle.items():
        out[bundle_resource_name(resource, pg_id, bundle_index)] = amount
        wildcard = bundle_resource_name(resource, pg_id)
        out[wildcard] = out.get(wildcard, 0) + amount
    # marker resource so zero-demand tasks can still pin to the bundle
    out[bundle_resource_name("bundle", pg_id, bundle_index)] = 1000
    out[bundle_resource_name("bundle", pg_id)] = (
        out.get(bundle_resource_name("bundle", pg_id), 0) + 1000)
    return out


def rewrite_resources_for_pg(resources: Dict[str, float], pg,
                             bundle_index: int) -> Dict[str, float]:
    """Rewrite a task's demand onto a PG's shadow resources
    (reference: placement group resource mapping in task submission,
    actor.py/remote_function.py _configure_placement_group)."""
    pg_id = pg.id
    out: Dict[str, float] = {}
    idx = bundle_index if bundle_index >= 0 else None
    for resource, amount in resources.items():
        out[bundle_resource_name(resource, pg_id, idx)] = amount
    # always consume a sliver of the bundle marker so placement works even
    # for zero-resource tasks
    out[bundle_resource_name("bundle", pg_id, idx)] = 0.001
    return out


@dataclass
class PlacementGroup:
    """User-facing handle (reference: util/placement_group.py)."""

    id: PlacementGroupID
    bundles: List[Dict[str, float]]
    strategy: str = "PACK"
    name: str = ""
    state: PlacementGroupState = PlacementGroupState.PENDING
    # committed node per bundle, parallel to `bundles`
    bundle_nodes: List[Optional[NodeID]] = field(default_factory=list)
    capture_child_tasks: bool = False
    lifetime: Optional[str] = None
    _ready_event: threading.Event = field(default_factory=threading.Event)

    @property
    def bundle_specs(self) -> List[Dict[str, float]]:
        return self.bundles

    def ready(self):
        """Returns an ObjectRef resolved when the PG is placed
        (reference: util/placement_group.py PlacementGroup.ready)."""
        return _ready_ref(self)

    def wait(self, timeout_seconds: float = 30.0) -> bool:
        return self._ready_event.wait(timeout=timeout_seconds)

    def is_ready(self) -> bool:
        return self.state is PlacementGroupState.CREATED


def _ready_ref(pg: PlacementGroup):
    from ray_tpu_torch._private.ids import ObjectID, TaskID
    from ray_tpu_torch.core import runtime as rt_mod
    from ray_tpu_torch.core.object_ref import ObjectRef

    rt = rt_mod.global_runtime
    ctx = rt.context()
    ctx.put_counter += 1
    oid = ObjectID.for_put(ctx.task_id, ctx.put_counter)
    rt.reference_counter.add_owned_object(oid)

    def _resolver():
        pg._ready_event.wait()
        rt.object_store.put(oid, pg)

    threading.Thread(target=_resolver, daemon=True).start()
    return ObjectRef(oid)


class LeastResourceScorer:
    """Best-fit scoring, vectorized over nodes
    (reference: gcs_resource_scheduler.h:54 LeastResourceScorer — higher
    score == better; prefers nodes left with the least slack)."""

    @staticmethod
    def score(demand: np.ndarray, available: np.ndarray,
              total: np.ndarray) -> np.ndarray:
        # [N] float; -inf where infeasible
        feasible = np.all(available >= demand, axis=1)
        with np.errstate(divide="ignore", invalid="ignore"):
            slack = np.where(
                total > 0,
                (available - demand) / np.maximum(total, 1),
                0.0,
            ).sum(axis=1)
        score = -slack  # least remaining == best fit
        return np.where(feasible, score, -np.inf)


class PlacementGroupManager:
    """GCS-side PG lifecycle: pack -> 2PC -> track
    (reference: gcs_placement_group_manager.cc FSM + scheduler)."""

    def __init__(self, runtime):
        self._rt = runtime
        self._lock = threading.RLock()
        self._groups: Dict[PlacementGroupID, PlacementGroup] = {}
        self._pending: List[PlacementGroup] = []
        self._named: Dict[str, PlacementGroupID] = {}

    # ------------------------------------------------------------- create
    def create(self, pg: PlacementGroup) -> None:
        with self._lock:
            if pg.name:
                if pg.name in self._named:
                    raise ValueError(
                        f"placement group name {pg.name!r} already taken")
                self._named[pg.name] = pg.id
            self._groups[pg.id] = pg
        if not self._try_place(pg):
            with self._lock:
                self._pending.append(pg)

    def pending_pgs(self) -> List["PlacementGroup"]:
        """Unplaced groups — the autoscaler's PG demand feed (reference:
        the monitor forwards pending PG bundles to the demand scheduler)."""
        with self._lock:
            return list(self._pending)

    def retry_pending(self) -> None:
        with self._lock:
            pending, self._pending = self._pending, []
        still = []
        for pg in pending:
            if pg.state is PlacementGroupState.REMOVED:
                continue
            if not self._try_place(pg):
                still.append(pg)
        if still:
            with self._lock:
                self._pending.extend(still)

    # -------------------------------------------------------------- solve
    def _try_place(self, pg: PlacementGroup) -> bool:
        rt = self._rt
        cluster = rt.cluster_state
        with cluster.lock:
            cluster.refresh_locked()
            matrix = cluster.matrix
            node_ids = matrix.node_ids()
            alive = matrix.alive.copy()
            available = matrix.available.copy()
            total = matrix.total.copy()
        width = matrix.width
        demands = np.zeros((len(pg.bundles), width), dtype=np.int64)
        for i, bundle in enumerate(pg.bundles):
            req = ResourceRequest.from_map(bundle, cluster.ids)
            if max(req.demands.keys(), default=-1) >= width:
                return False  # resource no node has yet
            demands[i] = req.dense(width)
        available = np.where(alive[:, None], available, -1)
        assignment = self._solve(pg.strategy, demands, available, total)
        if assignment is None:
            return False
        chosen = [node_ids[slot] for slot in assignment]
        return self._two_phase_commit(pg, chosen)

    def _solve(self, strategy: str, demands: np.ndarray,
               available: np.ndarray, total: np.ndarray
               ) -> Optional[List[int]]:
        """Vectorized packer. Returns node slot per bundle or None."""
        n_bundles, n_nodes = demands.shape[0], available.shape[0]
        if n_nodes == 0:
            return None
        avail = available.copy()
        if strategy == "STRICT_PACK":
            whole = demands.sum(axis=0)
            scores = LeastResourceScorer.score(whole, avail, total)
            best = int(np.argmax(scores))
            if not np.isfinite(scores[best]):
                return None
            return [best] * n_bundles
        assignment: List[int] = []
        used_nodes: set[int] = set()
        for i in range(n_bundles):
            scores = LeastResourceScorer.score(demands[i], avail, total)
            if strategy == "STRICT_SPREAD":
                for slot in used_nodes:
                    scores[slot] = -np.inf
            elif strategy == "SPREAD":
                # soft: penalize already-used nodes
                for slot in used_nodes:
                    if np.isfinite(scores[slot]):
                        scores[slot] -= 1000.0
            elif strategy == "PACK":
                # soft: prefer already-used nodes
                for slot in used_nodes:
                    if np.isfinite(scores[slot]):
                        scores[slot] += 1000.0
            best = int(np.argmax(scores))
            if not np.isfinite(scores[best]):
                return None
            assignment.append(best)
            used_nodes.add(best)
            avail[best] = avail[best] - demands[i]
        return assignment

    # ---------------------------------------------------------------- 2PC
    def _two_phase_commit(self, pg: PlacementGroup,
                          chosen: List[NodeID]) -> bool:
        """PrepareBundleResources on every raylet; all-or-nothing, then
        CommitBundleResources (reference: node_manager.h:475-485,
        placement_group_resource_manager.h:88). Both phases are
        idempotent raylet-side (core/raylet.py keys bundle state by
        (pg_id, bundle_index)), so a retried attempt after a partial
        failure cannot double-reserve or double-apply shadow capacity.
        A node vanishing between prepare and commit rolls the whole
        attempt back instead of leaking the other nodes' reservations."""
        rt = self._rt

        def rollback(entries: List[Tuple[int, NodeID]]) -> None:
            for pidx, pnode in entries:
                pr = rt.cluster_state.raylets.get(pnode)
                if pr is not None:
                    pr.return_bundle(pg.id, pidx, pg.bundles[pidx],
                                     committed=True)

        prepared: List[Tuple[int, NodeID]] = []
        for index, node_id in enumerate(chosen):
            raylet = rt.cluster_state.raylets.get(node_id)
            if raylet is None or not raylet.prepare_bundle(
                    pg.id, index, pg.bundles[index]):
                rollback(prepared)
                return False
            prepared.append((index, node_id))
        for index, node_id in enumerate(chosen):
            raylet = rt.cluster_state.raylets.get(node_id)
            if raylet is None:  # died between prepare and commit
                rollback(prepared)
                return False
            raylet.commit_bundle(pg.id, index, pg.bundles[index])
        pg.bundle_nodes = list(chosen)
        pg.state = PlacementGroupState.CREATED
        pg._ready_event.set()
        return True

    # -------------------------------------------------------------- remove
    def remove(self, pg_id: PlacementGroupID) -> None:
        with self._lock:
            pg = self._groups.get(pg_id)
            if pg is None or pg.state is PlacementGroupState.REMOVED:
                return
            if pg in self._pending:
                self._pending.remove(pg)
            if pg.name:
                self._named.pop(pg.name, None)
            was_created = pg.state is PlacementGroupState.CREATED
            pg.state = PlacementGroupState.REMOVED
        if was_created:
            for index, node_id in enumerate(pg.bundle_nodes):
                raylet = self._rt.cluster_state.raylets.get(node_id)
                if raylet is not None:
                    raylet.return_bundle(pg.id, index, pg.bundles[index],
                                         committed=True)

    def handle_node_death(self, node_id: NodeID) -> None:
        """Bundles on a dead node put the PG into RESCHEDULING
        (reference: gcs_placement_group_manager.cc OnNodeDead)."""
        to_retry = []
        with self._lock:
            for pg in self._groups.values():
                if pg.state is PlacementGroupState.CREATED and any(
                        n == node_id for n in pg.bundle_nodes):
                    pg.state = PlacementGroupState.RESCHEDULING
                    pg._ready_event.clear()
                    # return surviving bundles, then re-place the whole PG
                    for index, n in enumerate(pg.bundle_nodes):
                        if n != node_id:
                            raylet = self._rt.cluster_state.raylets.get(n)
                            if raylet is not None:
                                raylet.return_bundle(
                                    pg.id, index, pg.bundles[index],
                                    committed=True)
                    pg.bundle_nodes = []
                    to_retry.append(pg)
        for pg in to_retry:
            if not self._try_place(pg):
                with self._lock:
                    self._pending.append(pg)

    def get(self, pg_id: PlacementGroupID) -> Optional[PlacementGroup]:
        with self._lock:
            return self._groups.get(pg_id)

    def get_by_name(self, name: str) -> Optional[PlacementGroup]:
        with self._lock:
            pg_id = self._named.get(name)
            return self._groups.get(pg_id) if pg_id else None

    def table(self) -> Dict[str, dict]:
        with self._lock:
            return {
                pg.id.hex(): {
                    "name": pg.name,
                    "strategy": pg.strategy,
                    "state": pg.state.name,
                    "bundles": pg.bundles,
                    "bundle_nodes": [
                        n.hex() if n else None for n in pg.bundle_nodes],
                }
                for pg in self._groups.values()
            }
