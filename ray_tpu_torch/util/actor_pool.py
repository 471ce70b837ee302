"""ActorPool — borrow/submit over a fixed fleet of actors.

Mirrors the reference's ray.util.actor_pool.ActorPool
(python/ray/util/actor_pool.py): submit/get_next/get_next_unordered/map/
map_unordered plus push/pop_idle for fleet surgery.
"""

from __future__ import annotations

from typing import Any, Callable, Iterable, List, Optional, TypeVar

import ray_tpu_torch

V = TypeVar("V")


class ActorPool:
    def __init__(self, actors: Iterable[Any]):
        self._idle_actors: List[Any] = list(actors)
        self._future_to_actor = {}
        self._index_to_future = {}
        self._next_task_index = 0
        self._next_return_index = 0
        self._pending_submits: List[tuple] = []

    def map(self, fn: Callable[[Any, V], Any], values: Iterable[V]):
        """Ordered map over the pool; yields results in submission order."""
        for v in values:
            self.submit(fn, v)
        while self.has_next():
            yield self.get_next()

    def map_unordered(self, fn: Callable[[Any, V], Any],
                      values: Iterable[V]):
        for v in values:
            self.submit(fn, v)
        while self.has_next():
            yield self.get_next_unordered()

    def submit(self, fn: Callable[[Any, V], Any], value: V) -> None:
        if self._idle_actors:
            actor = self._idle_actors.pop()
            future = fn(actor, value)
            future_key = tuple(future) if isinstance(future, list) else future
            self._future_to_actor[future_key] = (self._next_task_index, actor)
            self._index_to_future[self._next_task_index] = future
            self._next_task_index += 1
        else:
            self._pending_submits.append((fn, value))

    def has_next(self) -> bool:
        return bool(self._future_to_actor)

    def get_next(self, timeout: Optional[float] = None) -> Any:
        """Next result in submission order."""
        if not self.has_next():
            raise StopIteration("No more results to get")
        if self._next_return_index >= self._next_task_index:
            raise ValueError("It is not allowed to call get_next() after "
                             "get_next_unordered()")
        future = self._index_to_future[self._next_return_index]
        if timeout is not None:
            res, _ = ray_tpu_torch.wait([future], timeout=timeout)
            if not res:
                raise TimeoutError("Timed out waiting for result")
        del self._index_to_future[self._next_return_index]
        self._next_return_index += 1
        future_key = tuple(future) if isinstance(future, list) else future
        _, actor = self._future_to_actor.pop(future_key)
        self._return_actor(actor)
        return ray_tpu_torch.get(future)

    def get_next_unordered(self, timeout: Optional[float] = None) -> Any:
        """Earliest-finishing result, any order."""
        if not self.has_next():
            raise StopIteration("No more results to get")
        res, _ = ray_tpu_torch.wait(
            list(self._future_to_actor), num_returns=1, timeout=timeout)
        if res:
            [future] = res
        else:
            raise TimeoutError("Timed out waiting for result")
        i, actor = self._future_to_actor.pop(future)
        self._return_actor(actor)
        del self._index_to_future[i]
        self._next_return_index = max(self._next_return_index, i + 1)
        return ray_tpu_torch.get(future)

    def _return_actor(self, actor: Any) -> None:
        self._idle_actors.append(actor)
        while self._pending_submits and self._idle_actors:
            fn, value = self._pending_submits.pop(0)
            self.submit(fn, value)

    def has_free(self) -> bool:
        return bool(self._idle_actors) and not self._pending_submits

    def pop_idle(self) -> Optional[Any]:
        if self.has_free():
            return self._idle_actors.pop()
        return None

    def push(self, actor: Any) -> None:
        busy_actors = [a for _, a in self._future_to_actor.values()]
        if actor in self._idle_actors or actor in busy_actors:
            raise ValueError("Actor already belongs to current ActorPool")
        self._return_actor(actor)
