"""multiprocessing.Pool drop-in on actors.

Mirrors the reference's ray.util.multiprocessing.Pool
(python/ray/util/multiprocessing/pool.py): apply/apply_async/map/
map_async/imap/imap_unordered/starmap over a fleet of PoolActor actors,
with AsyncResult futures.
"""

from __future__ import annotations

import itertools
import os
import threading
import time
from typing import Any, Callable, Iterable, List, Optional

import ray_tpu_torch


class TimeoutError(Exception):  # noqa: A001 — mirrors mp.TimeoutError
    pass


class _PoolActor:
    def __init__(self, initializer=None, initargs=None):
        if initializer:
            initializer(*(initargs or ()))

    def ping(self):
        return "pong"

    def run_batch(self, func, batch):
        results = []
        for args, kwargs in batch:
            results.append(func(*args, **(kwargs or {})))
        return results


class AsyncResult:
    def __init__(self, refs: List[Any], single: bool = False,
                 callback: Optional[Callable] = None,
                 error_callback: Optional[Callable] = None):
        self._refs = refs
        self._single = single
        self._callback = callback
        self._error_callback = error_callback
        self._result = None
        self._error = None
        self._done = False
        self._lock = threading.Lock()
        if callback is not None or error_callback is not None:
            # a callback fires when the result lands, as multiprocessing's
            # do, not at the first get(): joblib's pool backend waits for
            # it before it asks for any result
            threading.Thread(target=self._collect_when_ready, daemon=True,
                             name="pool-async-result").start()

    def _collect_when_ready(self) -> None:
        ray_tpu_torch.wait(self._refs, num_returns=len(self._refs))
        self._collect()

    def _collect(self, timeout: Optional[float] = None):
        with self._lock:
            if self._done:
                return
            deadline = (time.monotonic() + timeout
                        if timeout is not None else None)
            try:
                chunks = []
                for ref in self._refs:
                    t = (max(0.0, deadline - time.monotonic())
                         if deadline else None)
                    ready, _ = ray_tpu_torch.wait([ref], timeout=t)
                    if not ready:
                        raise TimeoutError("result not ready")
                    chunks.append(ray_tpu_torch.get(ref))
                flat = list(itertools.chain.from_iterable(chunks))
                self._result = flat[0] if self._single else flat
            except TimeoutError:
                raise
            except Exception as e:  # noqa: BLE001
                self._error = e
            self._done = True
        # once, by the call that collected, outside the lock (a callback
        # may ask this result for its value)
        if self._error is None:
            if self._callback:
                self._callback(self._result)
        elif self._error_callback:
            self._error_callback(self._error)

    def get(self, timeout: Optional[float] = None):
        self._collect(timeout)
        if self._error is not None:
            raise self._error
        return self._result

    def wait(self, timeout: Optional[float] = None) -> None:
        try:
            self._collect(timeout)
        except TimeoutError:
            pass

    def ready(self) -> bool:
        if self._done:
            return True
        ready, _ = ray_tpu_torch.wait(self._refs, num_returns=len(self._refs),
                                timeout=0)
        return len(ready) == len(self._refs)

    def successful(self) -> bool:
        if not self._done:
            raise ValueError("Result is not ready")
        return self._error is None


class Pool:
    def __init__(self, processes: Optional[int] = None,
                 initializer: Optional[Callable] = None,
                 initargs: Optional[tuple] = None,
                 maxtasksperchild: Optional[int] = None,
                 ray_address: Optional[str] = None):
        if not ray_tpu_torch.is_initialized():
            ray_tpu_torch.init()
        self._processes = processes or self._default_processes()
        if self._processes < 1:
            raise ValueError("processes must be >= 1")
        self._actor_cls = ray_tpu_torch.remote(_PoolActor)
        self._actors = [
            self._actor_cls.remote(initializer, initargs)
            for _ in range(self._processes)]
        ray_tpu_torch.get([a.ping.remote() for a in self._actors])
        self._rr = itertools.cycle(range(self._processes))
        self._closed = False

    @staticmethod
    def _default_processes() -> int:
        total = ray_tpu_torch.cluster_resources().get("CPU")
        return int(total) if total else (os.cpu_count() or 1)

    def _check_running(self):
        if self._closed:
            raise ValueError("Pool not running")

    # ------------------------------------------------------------- apply
    def apply(self, func, args=None, kwargs=None):
        return self.apply_async(func, args, kwargs).get()

    def apply_async(self, func, args=None, kwargs=None, callback=None,
                    error_callback=None) -> AsyncResult:
        self._check_running()
        actor = self._actors[next(self._rr)]
        ref = actor.run_batch.remote(func, [(args or (), kwargs or {})])
        return AsyncResult([ref], single=True, callback=callback,
                           error_callback=error_callback)

    # --------------------------------------------------------------- map
    def _chunk(self, iterable, chunksize: Optional[int], star: bool):
        items = list(iterable)
        if chunksize is None:
            chunksize = max(1, len(items) // (self._processes * 4) or 1)
        batches = []
        for i in range(0, len(items), chunksize):
            batch = [((it if star else (it,)), {})
                     for it in items[i:i + chunksize]]
            batches.append(batch)
        return batches

    def _map_async(self, func, iterable, chunksize=None, star=False,
                   callback=None, error_callback=None) -> AsyncResult:
        self._check_running()
        refs = []
        for i, batch in enumerate(self._chunk(iterable, chunksize, star)):
            actor = self._actors[i % self._processes]
            refs.append(actor.run_batch.remote(func, batch))
        return AsyncResult(refs, callback=callback,
                           error_callback=error_callback)

    def map(self, func, iterable, chunksize=None) -> list:
        return self._map_async(func, iterable, chunksize).get()

    def map_async(self, func, iterable, chunksize=None, callback=None,
                  error_callback=None) -> AsyncResult:
        return self._map_async(func, iterable, chunksize, False, callback,
                               error_callback)

    def starmap(self, func, iterable, chunksize=None) -> list:
        return self._map_async(func, iterable, chunksize, star=True).get()

    def starmap_async(self, func, iterable, chunksize=None, callback=None,
                      error_callback=None) -> AsyncResult:
        return self._map_async(func, iterable, chunksize, True, callback,
                               error_callback)

    def imap(self, func, iterable, chunksize=1):
        self._check_running()
        refs = []
        for i, batch in enumerate(self._chunk(iterable, chunksize, False)):
            actor = self._actors[i % self._processes]
            refs.append(actor.run_batch.remote(func, batch))
        for ref in refs:
            yield from ray_tpu_torch.get(ref)

    def imap_unordered(self, func, iterable, chunksize=1):
        self._check_running()
        refs = []
        for i, batch in enumerate(self._chunk(iterable, chunksize, False)):
            actor = self._actors[i % self._processes]
            refs.append(actor.run_batch.remote(func, batch))
        pending = list(refs)
        while pending:
            ready, pending = ray_tpu_torch.wait(pending, num_returns=1)
            yield from ray_tpu_torch.get(ready[0])

    # ----------------------------------------------------------- lifecycle
    def close(self):
        self._closed = True

    def terminate(self):
        self._closed = True
        for a in self._actors:
            ray_tpu_torch.kill(a)

    def join(self):
        if not self._closed:
            raise ValueError("Pool is still running")

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.terminate()
