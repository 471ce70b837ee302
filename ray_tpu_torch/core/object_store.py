"""In-process object store.

Equivalent of the reference's CoreWorkerMemoryStore
(core_worker/store_provider/memory_store/memory_store.cc): holds task
results and puts for the owning process, wakes synchronous getters and
async waiters, and feeds the reference counter's eviction decisions.

TPU-first note: values are stored *by reference* (zero-copy) in-process;
serialization happens only at a process or device boundary. Large arrays
therefore move to workers/devices without a host copy, the moral
equivalent of plasma's mmap zero-copy path.
"""

from __future__ import annotations

import logging
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence

logger = logging.getLogger(__name__)

from ray_tpu_torch._private.ids import ObjectID
from ray_tpu_torch.exceptions import GetTimeoutError, ObjectLostError


def _sizeof(value: Any) -> int:
    try:
        import numpy as np

        if isinstance(value, np.ndarray):
            return int(value.nbytes)
    except Exception as e:
        # numpy unavailable: the generic estimators below apply
        logger.debug("numpy sizeof probe failed: %r", e)
    nbytes = getattr(value, "nbytes", None)
    if isinstance(nbytes, int):
        return nbytes
    if isinstance(value, (bytes, bytearray, memoryview)):
        return len(value)
    if isinstance(value, str):
        return len(value)
    return 64  # nominal


@dataclass
class StoredObject:
    value: Any = None
    is_error: bool = False
    size: int = 0
    create_time: float = field(default_factory=time.monotonic)
    # set when the payload lives on disk, not in memory (spilled)
    spilled_path: Optional[str] = None
    # integrity plane: put-time digest of buffer-typed values (bytes/
    # ndarray), verified at get when integrity_verify_on_get is on;
    # spill files carry their own digest in the file header
    crc: Optional[int] = None


class MemoryStore:
    def __init__(self, capacity: Optional[int] = None,
                 spill_directory: Optional[str] = None,
                 spill_threshold: Optional[float] = None):
        from ray_tpu_torch._private.config import Config

        cfg = Config.instance()
        self._lock = threading.Lock()
        self._objects: Dict[ObjectID, StoredObject] = {}
        self._waiters: Dict[ObjectID, List[Callable[[], None]]] = {}
        self._cv = threading.Condition(self._lock)
        self._cv_waiters = 0  # gate notify_all on the put hot path
        self.total_bytes = 0
        self.num_puts = 0
        self.capacity = capacity or cfg.object_store_memory
        self.spill_threshold = (spill_threshold
                                if spill_threshold is not None
                                else cfg.object_spilling_threshold)
        self._spill_dir = spill_directory or cfg.spill_directory or None
        self.num_spilled = 0
        self.num_restored = 0
        self.spilled_bytes = 0
        # integrity plane: spilled copies dropped on a failed digest
        self.num_corrupt_dropped = 0
        # admission control for restores (scheduler/pull_manager.py);
        # attached by the runtime, None -> restore immediately
        self.pull_manager = None

    # -- write -------------------------------------------------------------
    def put(self, object_id: ObjectID, value: Any, is_error: bool = False) -> None:
        size = _sizeof(value)
        # in-process values are held by reference (zero-copy) — there
        # is no byte seam to protect at put time, so the put digest is
        # computed only when the verify-on-get knob asks for the
        # end-to-end re-check (and only for buffer-typed values, which
        # have a stable byte representation). Spill files always carry
        # their own digest, computed at spill time.
        crc = None
        if not is_error:
            from ray_tpu_torch.cluster import integrity

            if integrity.verify_on_get():
                crc = integrity.checksum_value(value)
        with self._lock:
            if object_id in self._objects:
                return  # objects are immutable; first write wins
            self._objects[object_id] = StoredObject(value, is_error,
                                                    size, crc=crc)
            self.total_bytes += size
            self.num_puts += 1
            callbacks = self._waiters.pop(object_id, ())
            if self._cv_waiters:
                self._cv.notify_all()
        for cb in callbacks:
            cb()
        if self.total_bytes > self.capacity * self.spill_threshold:
            self._spill_until_under()

    def delete(self, object_id: ObjectID) -> None:
        with self._lock:
            obj = self._objects.pop(object_id, None)
            if obj is not None:
                if obj.spilled_path is None:
                    self.total_bytes -= obj.size
                else:
                    self._delete_spill_file(obj)

    # -- spilling ----------------------------------------------------------
    # Reference: raylet/local_object_manager.h SpillObjects — when the
    # store crosses the threshold, the oldest unspilled objects move to
    # external storage; reads transparently restore them.
    def _spill_dir_path(self) -> str:
        import os

        if self._spill_dir is None:
            import tempfile

            # pid in the name: cluster/byte_store.sweep_stale_segments
            # reclaims spill dirs by parsing the owner pid from it (a
            # pid-less random suffix would be unsweepable — or worse,
            # misparsed)
            self._spill_dir = tempfile.mkdtemp(
                prefix=f"ray_tpu_torch_spill_{os.getpid()}_")
        else:
            os.makedirs(self._spill_dir, exist_ok=True)
        return self._spill_dir

    def _spill_until_under(self) -> None:
        target = self.capacity * self.spill_threshold
        while True:
            with self._lock:
                if self.total_bytes <= target:
                    return
                candidates = [
                    (oid, obj) for oid, obj in self._objects.items()
                    if obj.spilled_path is None and not obj.is_error
                    and obj.size >= 1024]
                if not candidates:
                    return
                oid, obj = min(candidates,
                               key=lambda kv: kv[1].create_time)
            self._spill_one(oid, obj)

    def _spill_one(self, object_id: ObjectID, obj: StoredObject) -> None:
        import os

        try:
            import cloudpickle as pickle
        except ImportError:  # pragma: no cover
            import pickle
        from ray_tpu_torch.cluster import fault_plane as _fault
        from ray_tpu_torch.cluster import integrity

        path = os.path.join(self._spill_dir_path(),
                            f"{object_id.hex()}.spill")
        # Two threads can race here for the same object: each put() past
        # the threshold runs _spill_until_under, and candidate selection
        # happens under the lock while the write happens outside it. Both
        # losers used to unlink the *shared* per-object path, deleting the
        # winner's just-recorded spill file and leaving spilled_path
        # dangling. Each spiller therefore writes a private tmp file and
        # only the lock winner os.replace()s it onto the canonical path;
        # a loser can only ever remove its own tmp.
        tmp = f"{path}.{threading.get_ident()}.tmp"
        try:
            data = pickle.dumps(obj.value)
        except Exception:  # unpicklable values just stay resident
            return
        # integrity plane: digest of the pickled payload rides the
        # spill-file header and is verified at restore — a flipped bit
        # at rest becomes a typed error + lineage recompute, not a
        # silently-wrong get
        crc = integrity.checksum(data) if integrity.enabled() else None
        plane = _fault.get_plane()
        if plane is not None:
            fault = plane.decide("spill", "memory_store",
                                 object_id.hex())
            if fault is not None and fault["action"] == "corrupt":
                data = _fault.apply_corruption(data, fault)
        try:
            with open(tmp, "wb") as f:
                f.write(integrity.pack_spill_header(False, crc))
                f.write(data)
        except Exception:
            return
        with self._lock:
            cur = self._objects.get(object_id)
            if cur is not obj or obj.spilled_path is not None:
                os.unlink(tmp)
                return
            os.replace(tmp, path)
            obj.spilled_path = path
            obj.value = None
            self.total_bytes -= obj.size
            self.spilled_bytes += obj.size
            self.num_spilled += 1

    def _restore(self, object_id: ObjectID, obj: StoredObject) -> None:
        try:
            import cloudpickle as pickle
        except ImportError:  # pragma: no cover
            import pickle
        from ray_tpu_torch.cluster import integrity
        from ray_tpu_torch.exceptions import ObjectCorruptedError

        with open(obj.spilled_path, "rb") as f:
            raw = f.read()
        try:
            _, payload, crc = integrity.parse_spill(raw)
            integrity.verify(payload, crc, "spill_restore",
                             bytes(object_id.binary())
                             if hasattr(object_id, "binary") else b"")
        except (ObjectCorruptedError, ValueError) as err:
            # failed digest or torn header: the spilled copy is gone
            # for good — drop the OBJECT (its bytes are unrecoverable
            # here) and surface the typed error; Runtime.get recovers
            # via lineage reconstruction
            with self._lock:
                cur = self._objects.get(object_id)
                if cur is obj and obj.spilled_path is not None:
                    self._delete_spill_file(obj)
                    self._objects.pop(object_id, None)
                    self.spilled_bytes -= obj.size
                    obj.spilled_path = None
            self.num_corrupt_dropped += 1
            if isinstance(err, ObjectCorruptedError):
                raise
            integrity.record_corruption("spill_restore")
            raise ObjectCorruptedError(
                object_id.hex(), "spill_restore",
                f"spill file of {object_id.hex()[:16]} unreadable: "
                f"{err!r}") from err
        value = pickle.loads(payload)
        with self._lock:
            if obj.spilled_path is None:
                return
            self._delete_spill_file(obj)
            obj.value = value
            obj.spilled_path = None
            self.total_bytes += obj.size
            self.spilled_bytes -= obj.size
            self.num_restored += 1

    def _delete_spill_file(self, obj: StoredObject) -> None:
        import os

        try:
            os.unlink(obj.spilled_path)
        except OSError as e:
            logger.debug("removing spill file %s failed: %r",
                         obj.spilled_path, e)

    def _materialized(self, object_id: ObjectID,
                      obj: StoredObject) -> StoredObject:
        if obj.spilled_path is not None:
            self._restore(object_id, obj)
        return obj

    def restore_spilled(self, object_ids: Sequence[ObjectID],
                        priority=None,
                        timeout: Optional[float] = None) -> None:
        """Restore any spilled objects among `object_ids`, gated by the
        pull manager's admission queue when one is attached (reference:
        PullManager activation triggers spill-restore for local spilled
        objects, pull_manager.cc). With a finite timeout, failing to win
        admission in time raises GetTimeoutError — it never restores
        around the admission gate."""
        with self._lock:
            spilled = [(oid, self._objects[oid]) for oid in object_ids
                       if oid in self._objects
                       and self._objects[oid].spilled_path is not None]
        if not spilled:
            return
        pm = self.pull_manager
        if pm is None:
            for oid, obj in spilled:
                self._restore(oid, obj)
            return
        from ray_tpu_torch.scheduler.pull_manager import BundlePriority

        if priority is None:
            priority = BundlePriority.GET_REQUEST
        bundle_id = pm.pull(priority, object_ids,
                            [obj.size for _, obj in spilled])
        try:
            if not pm.wait_active(bundle_id, timeout) and \
                    timeout is not None:
                raise GetTimeoutError(
                    f"restore of {len(spilled)} spilled objects not "
                    f"admitted within {timeout}s")
            for oid, obj in spilled:
                self._restore(oid, obj)
        finally:
            pm.cancel(bundle_id)

    # -- read --------------------------------------------------------------
    def contains(self, object_id: ObjectID) -> bool:
        with self._lock:
            return object_id in self._objects

    def peek(self, object_id: ObjectID) -> Optional[StoredObject]:
        with self._lock:
            obj = self._objects.get(object_id)
        if obj is None:
            return None
        return self._materialized(object_id, obj)

    def get(
        self,
        object_ids: Sequence[ObjectID],
        timeout: Optional[float] = None,
    ) -> List[StoredObject]:
        """Block until all ids are present; returns StoredObjects in order.

        Raises GetTimeoutError on timeout (reference: CoreWorker::Get,
        core_worker.cc:1010).
        """
        deadline = None if timeout is None else time.monotonic() + timeout
        while True:
            # Countdown latch over the per-object waiter callbacks: one
            # event wake when the LAST missing object lands, instead of a
            # notify_all + O(missing) rescan per put. Constructed only
            # when something is actually missing.
            with self._lock:
                missing = [o for o in object_ids if o not in self._objects]
                if not missing:
                    found = [self._objects[o] for o in object_ids]
                    break
                latch_lock = threading.Lock()
                done = threading.Event()
                state = {"n": len(missing)}

                def _one_ready():
                    with latch_lock:
                        state["n"] -= 1
                        if state["n"] == 0:
                            done.set()

                for oid in missing:
                    self._waiters.setdefault(oid, []).append(_one_ready)
            if deadline is None:
                done.wait()
            else:
                remaining = deadline - time.monotonic()
                if remaining <= 0 or not done.wait(remaining):
                    with self._lock:  # unregister our callbacks
                        for oid in missing:
                            cbs = self._waiters.get(oid)
                            if cbs is not None:
                                try:
                                    cbs.remove(_one_ready)
                                except ValueError as e:
                                    # a concurrent ready-callback
                                    # already consumed the entry
                                    logger.debug(
                                        "wait callback for %s already "
                                        "removed: %r", oid, e)
                                if not cbs:
                                    self._waiters.pop(oid, None)
                        still = sum(1 for o in object_ids
                                    if o not in self._objects)
                    if still == 0:
                        # everything landed right at the deadline: the
                        # top-of-loop rescan will collect and return it
                        continue
                    raise GetTimeoutError(
                        f"Get timed out: {still} of "
                        f"{len(object_ids)} objects not ready"
                    )
            # loop: revalidate the FULL list — an initially-present
            # object may have been evicted while we waited
        remaining = (None if deadline is None
                     else max(0.0, deadline - time.monotonic()))
        self.restore_spilled(object_ids, timeout=remaining)
        out = [self._materialized(oid, o)
               for oid, o in zip(object_ids, found)]
        from ray_tpu_torch.cluster import integrity

        if integrity.verify_on_get():
            # knob-gated end-to-end re-check at deserialization: a
            # buffer value mutated in place between put and get fails
            # its put-time digest here
            for oid, obj in zip(object_ids, out):
                if obj.crc is not None and not obj.is_error:
                    actual = integrity.checksum_value(obj.value)
                    if actual is not None and actual != obj.crc:
                        from ray_tpu_torch.exceptions import (
                            ObjectCorruptedError,
                        )

                        integrity.record_corruption("get")
                        raise ObjectCorruptedError(
                            oid.hex(), "get",
                            f"object {oid.hex()[:16]} failed its "
                            f"put-time digest at get")
        return out

    def wait(
        self,
        object_ids: Sequence[ObjectID],
        num_returns: int,
        timeout: Optional[float],
    ) -> tuple[list[ObjectID], list[ObjectID]]:
        """ray.wait semantics: first num_returns ready (in request order),
        rest unready (reference: wait_manager / CoreWorker::Wait)."""
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._lock:
            while True:
                ready = [o for o in object_ids if o in self._objects]
                if len(ready) >= num_returns:
                    ready_set = set(ready[:num_returns])
                    break
                if deadline is not None:
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        ready_set = set(ready)
                        break
                    self._cv_waiters += 1
                    try:
                        self._cv.wait(remaining)
                    finally:
                        self._cv_waiters -= 1
                else:
                    self._cv_waiters += 1
                    try:
                        self._cv.wait()
                    finally:
                        self._cv_waiters -= 1
            ready_list = [o for o in object_ids if o in ready_set]
            unready_list = [o for o in object_ids if o not in ready_set]
            return ready_list, unready_list

    def peek(self, object_id: ObjectID):
        """Non-materializing lookup: the StoredObject if resident (its
        ``is_error``/``value`` let completion hooks classify an outcome
        without a full get), else None. Does not restore spills."""
        with self._lock:
            return self._objects.get(object_id)

    # -- notifications -----------------------------------------------------
    def on_available(self, object_id: ObjectID, callback: Callable[[], None]
                     ) -> None:
        """Invoke callback once the object exists (immediately if present)."""
        with self._lock:
            if object_id not in self._objects:
                self._waiters.setdefault(object_id, []).append(callback)
                return
        callback()

    # -- stats -------------------------------------------------------------
    def stats(self) -> dict:
        with self._lock:
            return {
                "num_objects": len(self._objects),
                "total_bytes": self.total_bytes,
                "num_puts": self.num_puts,
                "num_spilled": self.num_spilled,
                "num_restored": self.num_restored,
                "spilled_bytes": self.spilled_bytes,
                "num_corrupt_dropped": self.num_corrupt_dropped,
            }
