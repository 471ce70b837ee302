"""Pull manager — priority admission over object pull bundles.

North-star component #3 (SURVEY §2.1, reference:
src/ray/object_manager/pull_manager.{h,cc}): pulls are requested as
*bundles* (all args of one task, or one get/wait call) with a strict
priority order — GET_REQUEST > WAIT_REQUEST > TASK_ARGS
(pull_manager.h:37-45) — and admission control activates only the
prefix of bundles whose total size fits the available store budget
(UpdatePullsBasedOnAvailableMemory), always at least one so progress
is never wedged.

The reference walks its queues bundle-by-bundle per update. Here the
admission solve is one vectorized pass over the whole queue: order by
(priority, sequence), prefix-sum the sizes, and threshold against the
budget — numpy for the typical queue, the same arithmetic jnp-jittable
for the 100k-bundle regime (bench.py measures the scheduler twin of
this kernel).

In this build objects restore from spill files rather than remote
nodes, so "activating" a bundle grants restore admission; the same
seam carries node-to-node transfer when raylets are remote.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass, field
from enum import IntEnum
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np


class BundlePriority(IntEnum):
    """Lower value = higher priority (pull_manager.h:37-45)."""

    GET_REQUEST = 0
    WAIT_REQUEST = 1
    TASK_ARGS = 2


@dataclass
class PullBundle:
    bundle_id: int
    priority: BundlePriority
    object_ids: Tuple
    total_size: int
    seq: int
    active: bool = False
    # signalled when the bundle becomes active
    event: threading.Event = field(default_factory=threading.Event)


class PullManager:
    def __init__(self, capacity_bytes: int,
                 admission_fraction: Optional[float] = None,
                 on_activate: Optional[Callable[[PullBundle], None]] = None,
                 on_deactivate: Optional[Callable[[PullBundle], None]] = None):
        from ray_tpu_torch._private.config import Config

        self.capacity = int(capacity_bytes)
        self.admission_fraction = (
            admission_fraction if admission_fraction is not None
            else Config.instance().pull_manager_admission_fraction)
        self.on_activate = on_activate
        self.on_deactivate = on_deactivate
        self._lock = threading.Lock()
        self._bundles: Dict[int, PullBundle] = {}
        self._next_id = 1
        self._next_seq = 0
        self.num_admission_ticks = 0

    # ----------------------------------------------------------------- API
    def pull(self, priority: BundlePriority, object_ids: Sequence,
             sizes: Sequence[int]) -> int:
        """Queue one bundle (reference: PullManager::Pull,
        pull_manager.h:86). Returns the bundle id for cancel()."""
        with self._lock:
            bundle = PullBundle(
                bundle_id=self._next_id,
                priority=BundlePriority(priority),
                object_ids=tuple(object_ids),
                total_size=int(sum(sizes)),
                seq=self._next_seq,
            )
            self._next_id += 1
            self._next_seq += 1
            self._bundles[bundle.bundle_id] = bundle
        self.admission_tick()
        return bundle.bundle_id

    def cancel(self, bundle_id: int) -> None:
        """CancelPull: frees the bundle's budget; the next tick may
        activate queued bundles."""
        with self._lock:
            self._bundles.pop(bundle_id, None)
        self.admission_tick()

    def update_capacity(self, capacity_bytes: int) -> None:
        self.capacity = int(capacity_bytes)
        self.admission_tick()

    def is_active(self, bundle_id: int) -> bool:
        with self._lock:
            bundle = self._bundles.get(bundle_id)
            return bool(bundle and bundle.active)

    def wait_active(self, bundle_id: int, timeout: Optional[float] = None
                    ) -> bool:
        with self._lock:
            bundle = self._bundles.get(bundle_id)
        if bundle is None:
            return False
        return bundle.event.wait(timeout)

    # ------------------------------------------------------- admission tick
    def admission_tick(self) -> None:
        """One vectorized admission solve
        (UpdatePullsBasedOnAvailableMemory): activate the
        (priority, seq)-ordered prefix fitting the budget; always admit
        the head bundle even when oversized so gets can't wedge."""
        newly_active: List[PullBundle] = []
        newly_inactive: List[PullBundle] = []
        with self._lock:
            self.num_admission_ticks += 1
            if not self._bundles:
                return
            bundles = list(self._bundles.values())
            prio = np.fromiter((b.priority for b in bundles), np.int64)
            seq = np.fromiter((b.seq for b in bundles), np.int64)
            sizes = np.fromiter((b.total_size for b in bundles), np.int64)
            order = np.lexsort((seq, prio))
            budget = int(self.capacity * self.admission_fraction)
            csum = np.cumsum(sizes[order])
            admit_sorted = csum <= budget
            admit_sorted[0] = True  # head always progresses
            admitted = np.zeros(len(bundles), dtype=bool)
            admitted[order] = admit_sorted
            for b, adm in zip(bundles, admitted):
                if adm and not b.active:
                    b.active = True
                    b.event.set()
                    newly_active.append(b)
                elif not adm and b.active:
                    b.active = False
                    b.event.clear()
                    newly_inactive.append(b)
        for b in newly_active:
            if self.on_activate:
                self.on_activate(b)
        for b in newly_inactive:
            if self.on_deactivate:
                self.on_deactivate(b)

    # ---------------------------------------------------------------- stats
    def stats(self) -> dict:
        with self._lock:
            active = sum(1 for b in self._bundles.values() if b.active)
            return {
                "num_bundles": len(self._bundles),
                "num_active": active,
                "num_queued": len(self._bundles) - active,
                "active_bytes": sum(b.total_size
                                    for b in self._bundles.values()
                                    if b.active),
                "capacity": self.capacity,
                "admission_ticks": self.num_admission_ticks,
            }
