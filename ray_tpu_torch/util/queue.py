"""Distributed FIFO queue backed by an async actor.

Mirrors the reference's ray.util.queue.Queue (python/ray/util/queue.py):
put/get with block/timeout, *_nowait, batch variants, qsize/empty/full.
The backing actor is asyncio-based so blocked gets don't pin executor
threads.
"""

from __future__ import annotations

import asyncio
from typing import Any, List, Optional

import ray_tpu_torch


class Empty(Exception):
    pass


class Full(Exception):
    pass


class _QueueActor:
    def __init__(self, maxsize: int = 0):
        self.queue = asyncio.Queue(maxsize)

    async def qsize(self):
        return self.queue.qsize()

    async def empty(self):
        return self.queue.empty()

    async def full(self):
        return self.queue.full()

    async def put(self, item, timeout: Optional[float] = None):
        try:
            await asyncio.wait_for(self.queue.put(item), timeout)
        except asyncio.TimeoutError:
            raise Full  # noqa: B904

    async def put_nowait(self, item):
        self.queue.put_nowait(item)

    async def put_nowait_batch(self, items):
        if self.queue.maxsize and (
                self.queue.qsize() + len(items) > self.queue.maxsize):
            raise Full(f"Cannot add {len(items)} items to queue of size "
                       f"{self.queue.qsize()} and maxsize {self.queue.maxsize}.")
        for item in items:
            self.queue.put_nowait(item)

    async def get(self, timeout: Optional[float] = None):
        try:
            return await asyncio.wait_for(self.queue.get(), timeout)
        except asyncio.TimeoutError:
            raise Empty  # noqa: B904

    async def get_nowait(self):
        try:
            return self.queue.get_nowait()
        except asyncio.QueueEmpty:
            raise Empty  # noqa: B904

    async def get_nowait_batch(self, num_items):
        if num_items > self.queue.qsize():
            raise Empty(f"Cannot get {num_items} items from queue of size "
                        f"{self.queue.qsize()}.")
        return [self.queue.get_nowait() for _ in range(num_items)]

    async def shutdown(self):
        return None


class Queue:
    def __init__(self, maxsize: int = 0,
                 actor_options: Optional[dict] = None):
        actor_options = actor_options or {}
        self.maxsize = maxsize
        self.actor = ray_tpu_torch.remote(_QueueActor).options(
            **actor_options).remote(maxsize)

    def __len__(self) -> int:
        return self.size()

    def size(self) -> int:
        return ray_tpu_torch.get(self.actor.qsize.remote())

    def qsize(self) -> int:
        return self.size()

    def empty(self) -> bool:
        return ray_tpu_torch.get(self.actor.empty.remote())

    def full(self) -> bool:
        return ray_tpu_torch.get(self.actor.full.remote())

    def put(self, item: Any, block: bool = True,
            timeout: Optional[float] = None) -> None:
        if not block:
            try:
                ray_tpu_torch.get(self.actor.put_nowait.remote(item))
            except asyncio.QueueFull:
                raise Full  # noqa: B904
        else:
            if timeout is not None and timeout < 0:
                raise ValueError("'timeout' must be a non-negative number")
            ray_tpu_torch.get(self.actor.put.remote(item, timeout))

    def put_nowait(self, item: Any) -> None:
        self.put(item, block=False)

    def put_nowait_batch(self, items: List[Any]) -> None:
        ray_tpu_torch.get(self.actor.put_nowait_batch.remote(items))

    def get(self, block: bool = True, timeout: Optional[float] = None) -> Any:
        if not block:
            return ray_tpu_torch.get(self.actor.get_nowait.remote())
        if timeout is not None and timeout < 0:
            raise ValueError("'timeout' must be a non-negative number")
        return ray_tpu_torch.get(self.actor.get.remote(timeout))

    def get_nowait(self) -> Any:
        return self.get(block=False)

    def get_nowait_batch(self, num_items: int) -> List[Any]:
        return ray_tpu_torch.get(self.actor.get_nowait_batch.remote(num_items))

    def shutdown(self, force: bool = False) -> None:
        if self.actor:
            if not force:
                ray_tpu_torch.get(self.actor.shutdown.remote())
            ray_tpu_torch.kill(self.actor)
        self.actor = None
