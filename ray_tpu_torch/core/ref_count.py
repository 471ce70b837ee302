"""Ownership-based distributed reference counting.

Mirrors the reference's ReferenceCounter (core_worker/reference_count.h:56):
the *owner* of an object (the process that created it) tracks

  - local refs:      live ObjectRef instances in this process
  - submitted refs:  in-flight tasks that take the object as an argument
  - borrower refs:   other processes holding deserialized copies of the ref
  - lineage refs:    tasks whose re-execution (reconstruction) needs it

An object is evictable when local + submitted + borrowers == 0; its lineage
entry is releasable when lineage refs also hit zero. Thread-safe; eviction
is delegated to a callback so the store and the counter stay decoupled
(the reference wires this the same way: on_object_evicted callbacks).
"""

from __future__ import annotations

import threading
from dataclasses import dataclass, field
from typing import Callable, Dict, Optional, Set

from ray_tpu_torch._private.ids import ObjectID, TaskID


@dataclass
class Reference:
    local: int = 0
    submitted: int = 0
    lineage: int = 0
    borrowers: Set[str] = field(default_factory=set)  # worker hexes
    owned: bool = False
    # The task that creates this object — lineage pointer for
    # reconstruction (reference: reference_count.h owned_by_us/lineage).
    creating_task: Optional[TaskID] = None
    pinned: bool = False  # e.g. held by the store for a pending get

    def total(self) -> int:
        return self.local + self.submitted + len(self.borrowers)


class ReferenceCounter:
    def __init__(self, on_evict: Optional[Callable[[ObjectID], None]] = None,
                 on_lineage_released: Optional[Callable[[TaskID], None]] = None):
        self._lock = threading.Lock()
        self._refs: Dict[ObjectID, Reference] = {}
        self._on_evict = on_evict
        self._on_lineage_released = on_lineage_released

    def set_eviction_callback(self, cb: Callable[[ObjectID], None]) -> None:
        self._on_evict = cb

    # -- registration ------------------------------------------------------
    def add_owned_object(self, object_id: ObjectID,
                         creating_task: Optional[TaskID] = None) -> None:
        with self._lock:
            ref = self._refs.setdefault(object_id, Reference())
            ref.owned = True
            ref.creating_task = creating_task

    def add_local_ref(self, object_id: ObjectID) -> None:
        with self._lock:
            self._refs.setdefault(object_id, Reference()).local += 1

    def remove_local_ref(self, object_id: ObjectID) -> None:
        self._decrement(object_id, "local")

    def add_submitted_task_ref(self, object_id: ObjectID) -> None:
        with self._lock:
            self._refs.setdefault(object_id, Reference()).submitted += 1

    def remove_submitted_task_ref(self, object_id: ObjectID) -> None:
        self._decrement(object_id, "submitted")

    def add_borrower(self, object_id: ObjectID, worker_hex: str) -> None:
        with self._lock:
            self._refs.setdefault(object_id, Reference()).borrowers.add(worker_hex)

    def remove_borrower(self, object_id: ObjectID, worker_hex: str) -> None:
        with self._lock:
            ref = self._refs.get(object_id)
            if ref is None:
                return
            ref.borrowers.discard(worker_hex)
            evict = self._maybe_release_locked(object_id, ref)
        self._run_evict(evict)

    def add_lineage_ref(self, object_id: ObjectID) -> None:
        with self._lock:
            self._refs.setdefault(object_id, Reference()).lineage += 1

    def remove_lineage_ref(self, object_id: ObjectID) -> None:
        released_task = None
        with self._lock:
            ref = self._refs.get(object_id)
            if ref is None:
                return
            ref.lineage = max(0, ref.lineage - 1)
            if ref.total() == 0 and ref.lineage == 0:
                self._refs.pop(object_id, None)
                released_task = ref.creating_task
        if released_task is not None and self._on_lineage_released:
            self._on_lineage_released(released_task)

    def pin(self, object_id: ObjectID, pinned: bool = True) -> None:
        with self._lock:
            ref = self._refs.get(object_id)
            if ref is not None:
                ref.pinned = pinned

    # -- queries -----------------------------------------------------------
    def local_ref_count(self, object_id: ObjectID) -> int:
        with self._lock:
            ref = self._refs.get(object_id)
            return ref.local if ref else 0

    def is_owned(self, object_id: ObjectID) -> bool:
        with self._lock:
            ref = self._refs.get(object_id)
            return bool(ref and ref.owned)

    def creating_task(self, object_id: ObjectID) -> Optional[TaskID]:
        with self._lock:
            ref = self._refs.get(object_id)
            return ref.creating_task if ref else None

    def num_tracked(self) -> int:
        with self._lock:
            return len(self._refs)

    def dump(self) -> dict:
        """Ownership table dump for `memory` introspection
        (reference: internal/internal_api.py ray memory)."""
        with self._lock:
            return {
                oid.hex(): {
                    "local": r.local,
                    "submitted": r.submitted,
                    "borrowers": len(r.borrowers),
                    "lineage": r.lineage,
                    "owned": r.owned,
                    "pinned": r.pinned,
                }
                for oid, r in self._refs.items()
            }

    # -- internals ---------------------------------------------------------
    def _decrement(self, object_id: ObjectID, kind: str) -> None:
        with self._lock:
            ref = self._refs.get(object_id)
            if ref is None:
                return
            setattr(ref, kind, max(0, getattr(ref, kind) - 1))
            evict = self._maybe_release_locked(object_id, ref)
        self._run_evict(evict)

    def _maybe_release_locked(self, object_id: ObjectID, ref: Reference
                              ) -> Optional[ObjectID]:
        if ref.total() == 0 and not ref.pinned:
            if ref.lineage == 0:
                self._refs.pop(object_id, None)
            return object_id
        return None

    def _run_evict(self, object_id: Optional[ObjectID]) -> None:
        if object_id is not None and self._on_evict is not None:
            self._on_evict(object_id)
