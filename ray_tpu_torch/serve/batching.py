"""@serve.batch — transparent request batching.

Reference: python/ray/serve/batching.py: calls to the wrapped coroutine
are buffered until max_batch_size requests arrive or batch_wait_timeout_s
elapses, then the underlying function runs once on the list of requests.
Inference batches need to be large to keep the tensor cores busy, so the
batcher is where request-level traffic turns into device-sized batches.

A batched method queues per instance, as the reference keeps its queue
on ``self``: replicas of one deployment share a process on the thread
tier, and one replica must not answer another's requests.
"""

from __future__ import annotations

import functools
import threading
from concurrent.futures import Future
from typing import Any, Callable, List, Optional


class _Batcher:
    def __init__(self, fn: Callable[[List[Any]], List[Any]],
                 max_batch_size: int, batch_wait_timeout_s: float):
        self._fn = fn
        self._max = max_batch_size
        self._timeout = batch_wait_timeout_s
        self._queue: List[tuple] = []
        self._lock = threading.Lock()
        self._timer: Optional[threading.Timer] = None

    def submit(self, instance, item: Any) -> Future:
        fut: Future = Future()
        flush_now = False
        with self._lock:
            self._queue.append((instance, item, fut))
            if len(self._queue) >= self._max:
                flush_now = True
            elif self._timer is None:
                self._timer = threading.Timer(self._timeout, self._flush)
                self._timer.daemon = True
                self._timer.start()
        if flush_now:
            self._flush()
        return fut

    def _flush(self) -> None:
        with self._lock:
            if self._timer is not None:
                self._timer.cancel()
                self._timer = None
            batch, self._queue = self._queue, []
        if not batch:
            return
        instance = batch[0][0]
        items = [item for _, item, _ in batch]
        futs = [fut for _, _, fut in batch]
        try:
            if instance is not None:
                results = self._fn(instance, items)
            else:
                results = self._fn(items)
            if len(results) != len(items):
                raise ValueError(
                    f"batch function returned {len(results)} results for "
                    f"{len(items)} requests")
            for fut, r in zip(futs, results):
                fut.set_result(r)
        except BaseException as e:  # noqa: BLE001
            for fut in futs:
                fut.set_exception(e)


def batch(_fn=None, *, max_batch_size: int = 10,
          batch_wait_timeout_s: float = 0.01):
    """Decorator: fn(self, requests: List) -> List (or fn(requests))."""

    def wrap(fn):
        batcher = _Batcher(fn, max_batch_size, batch_wait_timeout_s)
        attr = f"_serve_batcher_{fn.__name__}"

        @functools.wraps(fn)
        def wrapper(*args):
            if len(args) == 2:       # bound method: (self, item)
                instance, item = args
                own = vars(instance).get(attr)
                if own is None:
                    own = vars(instance).setdefault(attr, _Batcher(
                        fn, max_batch_size, batch_wait_timeout_s))
                return own.submit(instance, item).result(timeout=60)
            return batcher.submit(None, args[0]).result(timeout=60)

        wrapper._batcher = batcher
        return wrapper

    if _fn is not None:
        return wrap(_fn)
    return wrap
