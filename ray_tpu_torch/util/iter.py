"""ParallelIterator — lazy sharded iterators over actors.

Mirrors the reference's ray.util.iter (python/ray/util/iter.py):
from_items/from_range/from_iterators build a ParallelIterator of N shards
hosted on ParallelIteratorWorker actors; transformations (for_each,
filter, batch, flatten, ...) are lazy per-shard; gather_sync/gather_async
fold shards back into a LocalIterator on the driver.
"""

from __future__ import annotations

import collections
import random
from typing import Any, Callable, Iterable, Iterator, List, TypeVar

import ray_tpu_torch

T = TypeVar("T")
U = TypeVar("U")


class _NextValueNotReady(Exception):
    pass


class ParallelIteratorWorker:
    """Actor hosting one shard's (possibly infinite) item sequence."""

    def __init__(self, item_generator: Any, repeat: bool):
        self.item_generator = item_generator
        self.repeat = repeat
        self.transforms: List[Callable[[Iterator], Iterator]] = []
        self.local_it: Iterator = None

    def _build_once(self) -> Iterator:
        if callable(self.item_generator):
            it = iter(self.item_generator())
        else:
            it = iter(self.item_generator)
        for t in self.transforms:
            it = t(it)
        return it

    def par_iter_init(self, transforms) -> None:
        self.transforms = transforms
        self.local_it = self._build_once()

    def par_iter_next(self):
        while True:
            try:
                return next(self.local_it)
            except StopIteration:
                if not self.repeat:
                    raise
                self.local_it = self._build_once()

    def par_iter_next_batch(self, batch_size: int):
        batch = []
        for _ in range(batch_size):
            try:
                batch.append(self.par_iter_next())
            except StopIteration:
                if batch:
                    return batch
                raise
        return batch

    def par_iter_slice(self, step: int, start: int):
        # used by union/select_shards-style access; kept for API parity
        out = []
        it = self._build_once()
        for i, item in enumerate(it):
            if i % step == start:
                out.append(item)
        return out


def from_items(items: List[T], num_shards: int = 2,
               repeat: bool = False) -> "ParallelIterator[T]":
    shards = [[] for _ in range(num_shards)]
    for i, item in enumerate(items):
        shards[i % num_shards].append(item)
    name = f"from_items[{items and type(items[0]).__name__ or 'None'}, " \
           f"{len(items)}, shards={num_shards}]"
    return from_iterators(shards, repeat=repeat, name=name)


def from_range(n: int, num_shards: int = 2,
               repeat: bool = False) -> "ParallelIterator[int]":
    generators = []
    shard = n // num_shards
    for i in range(num_shards):
        start = i * shard
        end = (i + 1) * shard if i < num_shards - 1 else n
        generators.append(range(start, end))
    return from_iterators(generators, repeat=repeat,
                          name=f"from_range[{n}, shards={num_shards}]")


def from_iterators(generators: List[Iterable[T]], repeat: bool = False,
                   name=None) -> "ParallelIterator[T]":
    worker_cls = ray_tpu_torch.remote(ParallelIteratorWorker)
    actors = [worker_cls.remote(g, repeat) for g in generators]
    return from_actors(actors, name=name
                       or f"from_iterators[shards={len(generators)}]")


def from_actors(actors: List[Any], name=None) -> "ParallelIterator[T]":
    return ParallelIterator(actors, name or "from_actors", [])


class ParallelIterator:
    def __init__(self, actors: List[Any], name: str,
                 transforms: List[Callable]):
        self.actors = actors
        self.name = name
        self.transforms = transforms

    def __iter__(self):
        raise TypeError(
            "use gather_sync().__iter__() or gather_async().__iter__()")

    def __str__(self):
        return f"ParallelIterator[{self.name}]"

    __repr__ = __str__

    def _with_transform(self, fn: Callable[[Iterator], Iterator], suffix: str):
        return ParallelIterator(self.actors, self.name + suffix,
                                self.transforms + [fn])

    def for_each(self, fn: Callable[[T], U]) -> "ParallelIterator[U]":
        return self._with_transform(
            lambda it: map(fn, it), f".for_each({fn})")

    def filter(self, fn: Callable[[T], bool]) -> "ParallelIterator[T]":
        return self._with_transform(
            lambda it: filter(fn, it), f".filter({fn})")

    def batch(self, n: int) -> "ParallelIterator[List[T]]":
        def batcher(it):
            batch = []
            for item in it:
                batch.append(item)
                if len(batch) >= n:
                    yield batch
                    batch = []
            if batch:
                yield batch
        return self._with_transform(batcher, f".batch({n})")

    def flatten(self) -> "ParallelIterator":
        def flattener(it):
            for item in it:
                yield from item
        return self._with_transform(flattener, ".flatten()")

    def combine(self, fn: Callable[[T], List[U]]) -> "ParallelIterator[U]":
        return self.for_each(fn).flatten()

    def local_shuffle(self, shuffle_buffer_size: int,
                      seed: int = None) -> "ParallelIterator[T]":
        def shuffler(it):
            rng = random.Random(seed)
            buf = []
            for item in it:
                buf.append(item)
                if len(buf) >= shuffle_buffer_size:
                    yield buf.pop(rng.randrange(len(buf)))
            while buf:
                yield buf.pop(rng.randrange(len(buf)))
        return self._with_transform(
            shuffler,
            f".local_shuffle(buffer={shuffle_buffer_size}, seed={seed})")

    def repartition(self, num_partitions: int) -> "ParallelIterator[T]":
        # materialize and reshard (simplified vs reference's all-to-all slices)
        items = self.gather_sync().take(float("inf"))
        return from_items(items, num_shards=num_partitions)

    def num_shards(self) -> int:
        return len(self.actors)

    def shards(self) -> List["LocalIterator"]:
        return [self.select_shards([i]).gather_sync()
                for i in range(self.num_shards())]

    def select_shards(self, shards_to_keep: List[int]) -> "ParallelIterator[T]":
        return ParallelIterator(
            [a for i, a in enumerate(self.actors) if i in shards_to_keep],
            self.name + f".select_shards({shards_to_keep})", self.transforms)

    def gather_sync(self) -> "LocalIterator[T]":
        """Round-robin over shards, strictly in order."""
        for a in self.actors:
            ray_tpu_torch.get(a.par_iter_init.remote(self.transforms))

        def base_iterator(timeout=None):
            actors = list(self.actors)
            while actors:
                for a in list(actors):
                    try:
                        yield ray_tpu_torch.get(a.par_iter_next.remote())
                    except StopIteration:
                        actors.remove(a)
        return LocalIterator(base_iterator, name=self.name + ".gather_sync()")

    def gather_async(self, batch_ms: int = 0,
                     num_async: int = 1) -> "LocalIterator[T]":
        """Completion-order gather with num_async in-flight per shard."""
        for a in self.actors:
            ray_tpu_torch.get(a.par_iter_init.remote(self.transforms))

        def base_iterator(timeout=None):
            in_flight = {}
            for a in self.actors:
                for _ in range(num_async):
                    in_flight[a.par_iter_next.remote()] = a
            while in_flight:
                ready, _ = ray_tpu_torch.wait(
                    list(in_flight), num_returns=1, timeout=timeout)
                if not ready:
                    yield _NextValueNotReady()
                    continue
                [ref] = ready
                actor = in_flight.pop(ref)
                try:
                    value = ray_tpu_torch.get(ref)
                except StopIteration:
                    continue
                except Exception:
                    raise
                in_flight[actor.par_iter_next.remote()] = actor
                yield value
        return LocalIterator(base_iterator, name=self.name + ".gather_async()")

    def take(self, n: int) -> List[T]:
        return self.gather_sync().take(n)

    def show(self, n: int = 20) -> None:
        self.gather_sync().show(n)

    def union(self, other: "ParallelIterator[T]") -> "ParallelIterator[T]":
        if self.transforms or other.transforms:
            # bake transforms into fresh local iterators via gather
            raise ValueError("union() requires untransformed iterators")
        return ParallelIterator(self.actors + other.actors,
                                f"union({self.name}, {other.name})", [])


class LocalIterator:
    """Driver-side iterator over gathered shard output."""

    def __init__(self, base_iterator: Callable[..., Iterator[T]],
                 local_transforms: List[Callable] = None, name: str = ""):
        self.base_iterator = base_iterator
        self.local_transforms = local_transforms or []
        self.name = name or "LocalIterator"

    def __iter__(self):
        it = self.base_iterator()
        for t in self.local_transforms:
            it = t(it)
        for item in it:
            if isinstance(item, _NextValueNotReady):
                continue
            yield item

    def __str__(self):
        return f"LocalIterator[{self.name}]"

    __repr__ = __str__

    def _with(self, fn, suffix):
        return LocalIterator(self.base_iterator,
                             self.local_transforms + [fn], self.name + suffix)

    def for_each(self, fn) -> "LocalIterator":
        return self._with(lambda it: map(fn, it), f".for_each({fn})")

    def filter(self, fn) -> "LocalIterator":
        return self._with(lambda it: filter(fn, it), f".filter({fn})")

    def batch(self, n: int) -> "LocalIterator":
        def batcher(it):
            batch = []
            for item in it:
                batch.append(item)
                if len(batch) >= n:
                    yield batch
                    batch = []
            if batch:
                yield batch
        return self._with(batcher, f".batch({n})")

    def flatten(self) -> "LocalIterator":
        def flattener(it):
            for item in it:
                yield from item
        return self._with(flattener, ".flatten()")

    def combine(self, fn) -> "LocalIterator":
        return self.for_each(fn).flatten()

    def shuffle(self, shuffle_buffer_size: int, seed=None) -> "LocalIterator":
        def shuffler(it):
            rng = random.Random(seed)
            buf = []
            for item in it:
                buf.append(item)
                if len(buf) >= shuffle_buffer_size:
                    yield buf.pop(rng.randrange(len(buf)))
            while buf:
                yield buf.pop(rng.randrange(len(buf)))
        return self._with(shuffler, ".shuffle()")

    def zip_with_source_actor(self):
        raise NotImplementedError(
            "zip_with_source_actor is not supported in ray_tpu_torch")

    def take(self, n) -> List[T]:
        out = []
        for item in self:
            out.append(item)
            if len(out) >= n:
                break
        return out

    def show(self, n: int = 20) -> None:
        for item in self.take(n):
            print(item)

    def union(self, *others: "LocalIterator") -> "LocalIterator":
        iterators = [self] + list(others)

        def base(timeout=None):
            active = [iter(it) for it in iterators]
            while active:
                for it in list(active):
                    try:
                        yield next(it)
                    except StopIteration:
                        active.remove(it)
        return LocalIterator(base, name=f"union({len(iterators)})")

    def duplicate(self, n: int) -> List["LocalIterator"]:
        queues = [collections.deque() for _ in range(n)]
        source = iter(self)

        def make(i):
            def base(timeout=None):
                while True:
                    if queues[i]:
                        yield queues[i].popleft()
                        continue
                    try:
                        item = next(source)
                    except StopIteration:
                        if queues[i]:
                            continue
                        return
                    for q in queues:
                        q.append(item)
            return LocalIterator(base, name=self.name + f".dup[{i}]")
        return [make(i) for i in range(n)]
