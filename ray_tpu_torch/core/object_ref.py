"""ObjectRef — the distributed future handed back by every remote call.

Mirrors the reference's ObjectRef (python/ray/_raylet.pyx ObjectRef class):
identity is the 28-byte ObjectID; the Python object's lifetime *is* the
local reference count (construction registers, ``__del__`` deregisters with
the owner's ReferenceCounter), which drives distributed GC exactly like the
reference's CoreWorker ref-counting hooks.
"""

from __future__ import annotations

import asyncio
import threading
import weakref
from typing import TYPE_CHECKING, Optional

from ray_tpu_torch._private.ids import ObjectID

if TYPE_CHECKING:
    from ray_tpu_torch.core.runtime import Runtime


class ObjectRef:
    __slots__ = ("_id", "_owner_hex", "_counter", "__weakref__")

    def __init__(self, object_id: ObjectID, owner_hex: str = "",
                 skip_adding_local_ref: bool = False):
        self._id = object_id
        self._owner_hex = owner_hex
        # Weakref to the ReferenceCounter that registered this ref, so
        # deregistration on __del__ always hits the *owning* runtime. A
        # stale ref outliving its runtime must never decrement a counter
        # in a newer runtime (object IDs can repeat across runtimes).
        self._counter = None
        if not skip_adding_local_ref:
            rt = _maybe_runtime()
            if rt is not None:
                rt.reference_counter.add_local_ref(object_id)
                self._counter = weakref.ref(rt.reference_counter)

    # -- identity ----------------------------------------------------------
    def id(self) -> ObjectID:
        return self._id

    def binary(self) -> bytes:
        return self._id.binary()

    def hex(self) -> str:
        return self._id.hex()

    def task_id(self):
        return self._id.task_id()

    def owner_hex(self) -> str:
        return self._owner_hex

    def __hash__(self):
        return hash(self._id)

    def __eq__(self, other):
        return isinstance(other, ObjectRef) and other._id == self._id

    def __repr__(self):
        return f"ObjectRef({self._id.hex()})"

    # -- future protocol ---------------------------------------------------
    def future(self) -> "asyncio.Future":
        """Return an asyncio.Future resolved with the object's value
        (or raising its stored error) on the running loop."""
        loop = asyncio.get_event_loop()
        fut: asyncio.Future = loop.create_future()

        def _on_ready():
            from ray_tpu_torch.core import api

            def _set():
                if fut.cancelled():
                    return
                try:
                    fut.set_result(api.get(self, _skip_wait=True))
                except BaseException as e:  # noqa: BLE001
                    fut.set_exception(e)

            loop.call_soon_threadsafe(_set)

        _require_runtime().object_store.on_available(self._id, _on_ready)
        return fut

    def __await__(self):
        return self.future().__await__()

    # -- lifetime ----------------------------------------------------------
    def __del__(self):
        if self._counter is not None:
            try:
                rc = self._counter()
                if rc is not None:
                    rc.remove_local_ref(self._id)
            # __del__ runs at interpreter shutdown, where the logging
            # machinery itself may already be torn down; any raise here
            # prints to stderr unavoidably
            except Exception:  # raycheck: disable=RC05
                pass

    def __reduce__(self):
        # Same-process deserialization re-registers through __init__.
        # When a borrow context is active (the ref is being shipped to
        # another process, core/runtime.py process path), record the
        # borrow with the owner's ReferenceCounter NOW — the borrower
        # holds the ref for the duration the context owner decides
        # (reference: reference_count.cc borrower bookkeeping).
        ctx = getattr(_borrow_ctx, "active", None)
        if ctx is not None:
            borrower_id, collected = ctx
            rt = _maybe_runtime()
            if rt is not None and self._id not in collected:
                rt.reference_counter.add_borrower(self._id, borrower_id)
                collected.add(self._id)
        return (ObjectRef, (self._id, self._owner_hex))


_borrow_ctx = threading.local()


class borrow_context:
    """While active on this thread, every ObjectRef pickled registers
    ``borrower_id`` as a borrower with the owning runtime. The caller
    removes the borrows when the remote holder is done:

        collected: set = set()
        with borrow_context("pworker:abc", collected):
            payload = dumps(args)      # nested refs register borrows
        ... run remote work ...
        for oid in collected:
            rc.remove_borrower(oid, "pworker:abc")
    """

    def __init__(self, borrower_id: str, collected: set):
        self._entry = (borrower_id, collected)

    def __enter__(self):
        self._prev = getattr(_borrow_ctx, "active", None)
        _borrow_ctx.active = self._entry
        return self._entry[1]

    def __exit__(self, *exc):
        _borrow_ctx.active = self._prev
        return False


def _maybe_runtime() -> Optional["Runtime"]:
    from ray_tpu_torch.core import runtime as rt_mod

    return rt_mod.global_runtime


def _require_runtime() -> "Runtime":
    rt = _maybe_runtime()
    if rt is None:
        raise RuntimeError("ray_tpu_torch.init() has not been called")
    return rt
