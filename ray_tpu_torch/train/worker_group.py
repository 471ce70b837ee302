"""Actor fleet for distributed training.

Mirrors the reference's ray.train worker group
(python/ray/train/worker_group.py): BaseWorkerMixin actors that execute
arbitrary closures, created inside an optional placement group.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, TypeVar

import ray_tpu_torch

T = TypeVar("T")


class BaseWorker:
    """Executes arbitrary functions; the session rides on top."""

    def __init__(self):
        self._env: Dict[str, str] = {}

    def _execute(self, fn: Callable[..., T], *args, **kwargs) -> T:
        return fn(*args, **kwargs)

    def node_id(self):
        return ray_tpu_torch.get_runtime_context().get_node_id()


@dataclass
class WorkerMetadata:
    node_id: str


@dataclass
class Worker:
    actor: Any
    metadata: WorkerMetadata


class WorkerGroup:
    def __init__(self, num_workers: int = 1,
                 num_cpus_per_worker: float = 1,
                 num_gpus_per_worker: float = 0,
                 additional_resources_per_worker: Optional[Dict] = None,
                 placement_group: Any = None):
        if num_workers <= 0:
            raise ValueError("num_workers must be positive")
        self.num_workers = num_workers
        self.num_cpus_per_worker = num_cpus_per_worker
        self.num_gpus_per_worker = num_gpus_per_worker
        self.additional_resources_per_worker = additional_resources_per_worker
        self.placement_group = placement_group
        self.workers: List[Worker] = []
        self._remote_cls = None
        self.start()

    def _actor_options(self, bundle_index: int) -> dict:
        opts: dict = dict(num_cpus=self.num_cpus_per_worker,
                          num_gpus=self.num_gpus_per_worker)
        if self.additional_resources_per_worker:
            opts["resources"] = dict(self.additional_resources_per_worker)
        if self.placement_group is not None:
            from ray_tpu_torch.util.scheduling_strategies import (
                PlacementGroupSchedulingStrategy,
            )

            opts["scheduling_strategy"] = PlacementGroupSchedulingStrategy(
                placement_group=self.placement_group,
                placement_group_bundle_index=bundle_index,
            )
        return opts

    def start(self) -> None:
        if self.workers:
            raise RuntimeError("WorkerGroup already started")
        self._remote_cls = ray_tpu_torch.remote(BaseWorker)
        for i in range(self.num_workers):
            actor = self._remote_cls.options(
                **self._actor_options(i)).remote()
            self.workers.append(Worker(actor, None))
        ids = ray_tpu_torch.get(
            [w.actor.node_id.remote() for w in self.workers])
        for w, nid in zip(self.workers, ids):
            w.metadata = WorkerMetadata(node_id=nid)

    def shutdown(self, patience_s: float = 5) -> None:
        for w in self.workers:
            ray_tpu_torch.kill(w.actor)
        self.workers = []

    def __len__(self) -> int:
        return len(self.workers)

    def execute_async(self, fn: Callable[..., T], *args, **kwargs) -> List:
        if not self.workers:
            raise RuntimeError("WorkerGroup is shut down")
        return [w.actor._execute.remote(fn, *args, **kwargs)
                for w in self.workers]

    def execute(self, fn: Callable[..., T], *args, **kwargs) -> List[T]:
        return ray_tpu_torch.get(self.execute_async(fn, *args, **kwargs))

    def execute_single_async(self, worker_index: int,
                             fn: Callable[..., T], *args, **kwargs):
        if worker_index >= len(self.workers):
            raise ValueError(f"worker_index {worker_index} out of range")
        return self.workers[worker_index].actor._execute.remote(
            fn, *args, **kwargs)

    def execute_single(self, worker_index: int, fn: Callable[..., T],
                       *args, **kwargs) -> T:
        return ray_tpu_torch.get(
            self.execute_single_async(worker_index, fn, *args, **kwargs))

    def remove_workers(self, worker_indexes: List[int]) -> None:
        self.workers = [w for i, w in enumerate(self.workers)
                        if i not in set(worker_indexes)]

    def add_workers(self, num_workers: int) -> None:
        new = []
        base = len(self.workers)
        for i in range(num_workers):
            actor = self._remote_cls.options(
                **self._actor_options(base + i)).remote()
            new.append(Worker(actor, None))
        ids = ray_tpu_torch.get([w.actor.node_id.remote() for w in new])
        for w, nid in zip(new, ids):
            w.metadata = WorkerMetadata(node_id=nid)
        self.workers.extend(new)
