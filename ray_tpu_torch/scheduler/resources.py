"""Resource model: fixed-point quantities, interning, and matrix views.

Mirrors the reference's scheduling data model:
  - resources are int64 fixed-point at 1/10000 granularity
    (src/ray/raylet/scheduling/fixed_point.h:24)
  - resource names are interned to dense int ids
    (scheduling_ids.h:26 StringIdMap)
  - a ResourceRequest / NodeResources pair of flat vectors
    (cluster_resource_data.h:62,145)

The TPU-first twist: the whole cluster's resource state is *also* held as a
dense ``[num_nodes, num_resources]`` int64 matrix so the scheduling policy
can be evaluated as one batched device computation instead of a per-node
scan. ``ResourceMatrix`` is that view; it stays allocation-free across
ticks.
"""

from __future__ import annotations

import threading
from typing import Dict, Iterable, List, Mapping, Optional, Tuple

import numpy as np

RESOURCE_UNIT_SCALING = 10000

# Predefined resources get fixed dense ids so matrices line up across
# nodes without consulting the interner (reference: scheduling_ids.h
# PredefinedResources enum).
CPU = "CPU"
MEMORY = "memory"
GPU = "GPU"
TPU = "TPU"
OBJECT_STORE_MEMORY = "object_store_memory"
PREDEFINED_RESOURCES = (CPU, MEMORY, GPU, TPU, OBJECT_STORE_MEMORY)


def to_fixed(value: float) -> int:
    """Convert a float resource quantity to int64 fixed point."""
    return int(round(value * RESOURCE_UNIT_SCALING))


def from_fixed(value: int) -> float:
    return value / RESOURCE_UNIT_SCALING


class StringIdMap:
    """Bidirectional string<->int interning, thread-safe.

    Predefined resources occupy ids [0, len(PREDEFINED_RESOURCES)); custom
    resources get the next free id. Ids are never reused.
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._to_id: Dict[str, int] = {
            name: i for i, name in enumerate(PREDEFINED_RESOURCES)
        }
        self._to_str: List[str] = list(PREDEFINED_RESOURCES)

    def get_id(self, name: str) -> int:
        with self._lock:
            existing = self._to_id.get(name)
            if existing is not None:
                return existing
            new_id = len(self._to_str)
            self._to_id[name] = new_id
            self._to_str.append(name)
            return new_id

    def get_string(self, rid: int) -> str:
        with self._lock:
            return self._to_str[rid]

    def count(self) -> int:
        with self._lock:
            return len(self._to_str)


class ResourceRequest:
    """A task/bundle's resource demand as a sparse {resource_id: fixed}.

    (reference: cluster_resource_data.h:62 ResourceRequest)
    """

    __slots__ = ("demands",)

    def __init__(self, demands: Optional[Dict[int, int]] = None):
        self.demands: Dict[int, int] = {
            k: v for k, v in (demands or {}).items() if v != 0
        }

    @classmethod
    def from_map(cls, resources: Mapping[str, float], ids: StringIdMap
                 ) -> "ResourceRequest":
        return cls({ids.get_id(name): to_fixed(v)
                    for name, v in resources.items() if v != 0})

    def to_map(self, ids: StringIdMap) -> Dict[str, float]:
        return {ids.get_string(k): from_fixed(v) for k, v in self.demands.items()}

    def is_empty(self) -> bool:
        return not self.demands

    def dense(self, width: int) -> np.ndarray:
        out = np.zeros(width, dtype=np.int64)
        for k, v in self.demands.items():
            if k < width:
                out[k] = v
        return out

    def key(self) -> Tuple[Tuple[int, int], ...]:
        """Canonical hashable form — the SchedulingClass dedup key
        (reference: task_spec.h SchedulingClassDescriptor)."""
        return tuple(sorted(self.demands.items()))

    def __eq__(self, other):
        return isinstance(other, ResourceRequest) and self.demands == other.demands

    def __hash__(self):
        return hash(self.key())

    def __repr__(self):
        return f"ResourceRequest({self.demands})"


class NodeResources:
    """Total and available capacity of one node, sparse form.

    (reference: cluster_resource_data.h:145 NodeResources)
    """

    __slots__ = ("total", "available", "labels")

    def __init__(self, total: Optional[Dict[int, int]] = None,
                 available: Optional[Dict[int, int]] = None,
                 labels: Optional[Dict[str, str]] = None):
        self.total: Dict[int, int] = dict(total or {})
        self.available: Dict[int, int] = (
            dict(available) if available is not None else dict(self.total)
        )
        self.labels: Dict[str, str] = labels or {}

    @classmethod
    def from_map(cls, resources: Mapping[str, float], ids: StringIdMap
                 ) -> "NodeResources":
        total = {ids.get_id(name): to_fixed(v) for name, v in resources.items()}
        return cls(total=total)

    def is_feasible(self, req: ResourceRequest) -> bool:
        return all(self.total.get(rid, 0) >= amt for rid, amt in req.demands.items())

    def is_available(self, req: ResourceRequest) -> bool:
        return all(
            self.available.get(rid, 0) >= amt for rid, amt in req.demands.items()
        )

    def allocate(self, req: ResourceRequest) -> bool:
        if not self.is_available(req):
            return False
        for rid, amt in req.demands.items():
            self.available[rid] = self.available.get(rid, 0) - amt
        return True

    def free(self, req: ResourceRequest) -> None:
        for rid, amt in req.demands.items():
            if rid not in self.total:
                # capacity was removed while allocated (e.g. a placement
                # group bundle returned) — nothing to credit back
                continue
            self.available[rid] = min(
                self.available.get(rid, 0) + amt, self.total[rid]
            )

    def add_capacity(self, rid: int, amt: int) -> None:
        self.total[rid] = self.total.get(rid, 0) + amt
        self.available[rid] = self.available.get(rid, 0) + amt

    def remove_capacity(self, rid: int) -> None:
        self.total.pop(rid, None)
        self.available.pop(rid, None)

    def critical_utilization(self, width: Optional[int] = None) -> float:
        """max over resources of used/total — the hybrid policy's node score
        (reference: scheduling_policy.cc:41-57)."""
        score = 0.0
        for rid, tot in self.total.items():
            if tot <= 0:
                continue
            used = tot - self.available.get(rid, 0)
            score = max(score, used / tot)
        return score

    def to_map(self, ids: StringIdMap, available: bool = False) -> Dict[str, float]:
        src = self.available if available else self.total
        return {ids.get_string(k): from_fixed(v) for k, v in src.items()}

    def copy(self) -> "NodeResources":
        return NodeResources(dict(self.total), dict(self.available),
                             dict(self.labels))

    def __repr__(self):
        return f"NodeResources(total={self.total}, available={self.available})"


class ResourceMatrix:
    """Dense [nodes x resources] view of cluster state for the batched policy.

    Rebuilt incrementally: node rows are stable slots; resource columns grow
    as custom resources appear. All int64 fixed-point.
    """

    def __init__(self, ids: StringIdMap):
        self._ids = ids
        self._node_slots: Dict[object, int] = {}
        self._slot_nodes: List[object] = []
        self.total = np.zeros((0, len(PREDEFINED_RESOURCES)), dtype=np.int64)
        self.available = np.zeros((0, len(PREDEFINED_RESOURCES)), dtype=np.int64)
        self.alive = np.zeros((0,), dtype=bool)
        # Delta plumbing for device-resident mirrors (policy.py
        # DeviceMatrixMirror): `version` bumps on any STRUCTURAL change
        # (new node row, wider resource axis, liveness flip) — a mirror
        # seeing a version jump must full-resync; row-level capacity /
        # availability updates land in `_dirty_rows` and can be folded
        # into a mirror as a small per-row delta upload instead of
        # re-coercing and re-uploading the whole matrix every tick.
        # Synchronization contract: like the arrays themselves, these are
        # guarded by the caller's cluster lock.
        self.version = 0
        self._dirty_rows: set = set()

    @property
    def num_nodes(self) -> int:
        return len(self._slot_nodes)

    @property
    def width(self) -> int:
        return self.total.shape[1]

    def node_ids(self) -> List[object]:
        return list(self._slot_nodes)

    def slot_of(self, node_id) -> Optional[int]:
        return self._node_slots.get(node_id)

    def node_at(self, slot: int):
        return self._slot_nodes[slot]

    def _ensure_width(self, width: int) -> None:
        if width > self.total.shape[1]:
            pad = width - self.total.shape[1]
            self.total = np.pad(self.total, ((0, 0), (0, pad)))
            self.available = np.pad(self.available, ((0, 0), (0, pad)))
            self.version += 1

    def upsert(self, node_id, res: NodeResources) -> int:
        width = max(self._ids.count(),
                    max(res.total.keys(), default=-1) + 1,
                    self.total.shape[1])
        self._ensure_width(width)
        slot = self._node_slots.get(node_id)
        if slot is None:
            slot = len(self._slot_nodes)
            self._node_slots[node_id] = slot
            self._slot_nodes.append(node_id)
            self.total = np.vstack(
                [self.total, np.zeros((1, self.total.shape[1]), np.int64)])
            self.available = np.vstack(
                [self.available, np.zeros((1, self.total.shape[1]), np.int64)])
            self.alive = np.append(self.alive, True)
            self.version += 1
        row_t = np.zeros(self.total.shape[1], np.int64)
        row_a = np.zeros(self.total.shape[1], np.int64)
        for rid, amt in res.total.items():
            row_t[rid] = amt
        for rid, amt in res.available.items():
            row_a[rid] = amt
        self.total[slot] = row_t
        self.available[slot] = row_a
        self._dirty_rows.add(slot)
        return slot

    def set_alive(self, node_id, alive: bool) -> None:
        slot = self._node_slots.get(node_id)
        if slot is not None:
            self.alive[slot] = alive
            self.version += 1

    def consume_dirty_rows(self) -> np.ndarray:
        """Slots whose rows changed since the last call, cleared on read.
        A device mirror folds exactly these rows (commit/heartbeat
        deltas); an empty result means its buffers are already fresh."""
        if not self._dirty_rows:
            return np.zeros(0, dtype=np.int64)
        out = np.array(sorted(self._dirty_rows), dtype=np.int64)
        self._dirty_rows.clear()
        return out

    def requests_dense(self, requests: Iterable[ResourceRequest]) -> np.ndarray:
        reqs = list(requests)
        out = np.zeros((len(reqs), self.width), dtype=np.int64)
        for i, r in enumerate(reqs):
            for rid, amt in r.demands.items():
                if rid < self.width:
                    out[i, rid] = amt
                else:
                    # a resource no node has — mark infeasible via sentinel
                    self._ensure_width(rid + 1)
                    out = np.pad(out, ((0, 0), (0, self.width - out.shape[1])))
                    out[i, rid] = amt
        return out
