"""Actor execution: ordered delivery, concurrency, restarts.

Re-implements the reference's direct actor transport + scheduling queues
(core_worker/transport/direct_actor_task_submitter.cc,
actor_scheduling_queue.cc, fiber.h, concurrency_group_manager.cc):

  - actor method calls bypass the raylet: the caller enqueues straight to
    the actor's executor with a per-caller sequence number; a sync actor
    executes strictly in sequence-number order, max_concurrency>1 relaxes
    that within the declared window, and async actors interleave
    coroutines on a dedicated event loop capped by a semaphore.
  - while the actor is pending creation or restarting, calls buffer
    client-side and flush on ALIVE (direct_actor_task_submitter.cc
    pending-queue behavior).
  - the actor FSM matches src/ray/design_docs/actor_states.rst:
    DEPENDENCIES_UNREADY -> PENDING_CREATION -> ALIVE <-> RESTARTING -> DEAD.
"""

from __future__ import annotations

import asyncio
import heapq
import inspect
import logging
import threading
from dataclasses import dataclass, field
from enum import Enum
from typing import Any, Callable, Dict, List, Optional, Tuple

from ray_tpu_torch._private.config import Config
from ray_tpu_torch._private.ids import ActorID, NodeID
from ray_tpu_torch.cluster.threads import ThreadRegistry
from ray_tpu_torch.exceptions import (
    ActorDiedError,
    AsyncioActorExit,
    PendingCallsLimitExceeded,
    RayActorError,
)

logger = logging.getLogger(__name__)


class ActorState(Enum):
    DEPENDENCIES_UNREADY = 0
    PENDING_CREATION = 1
    ALIVE = 2
    RESTARTING = 3
    DEAD = 4


@dataclass(order=True)
class _QueuedCall:
    seq_no: int
    # non-ordering payload:
    method_name: str = field(compare=False, default="")
    execute: Callable[[], None] = field(compare=False, default=None)
    fail: Optional[Callable[[], None]] = field(compare=False, default=None)


class ActorExecutor:
    """Runs one actor instance's methods with ordering guarantees."""

    def __init__(self, actor_id: ActorID, instance: Any,
                 max_concurrency: int, is_async: bool,
                 concurrency_groups: Optional[Dict[str, int]] = None,
                 execute_out_of_order: bool = False):
        self.actor_id = actor_id
        self.instance = instance
        self.is_async = is_async
        self.max_concurrency = max_concurrency
        # reference out_of_order_actor_scheduling_queue.cc: dispatch in
        # ARRIVAL order — never park waiting for a missing seq_no (a
        # caller whose earlier call is still resolving dependencies must
        # not head-of-line-block the actor when the user opted out of
        # ordering)
        self.execute_out_of_order = execute_out_of_order
        self.dead = False
        self._lock = threading.Lock()
        self._cv = threading.Condition(self._lock)
        self._heap: List[_QueuedCall] = []
        self._next_seq = 0
        self._inflight = 0
        self._async_pending = 0
        # executor threads spawn through the registry: kill() joins
        # them by name so a method wedged past death is WARN-logged
        # instead of silently leaking (raycheck RC09)
        self._threads = ThreadRegistry(f"actor-{actor_id.hex()[:6]}")
        self._loop: Optional[asyncio.AbstractEventLoop] = None
        self._sem: Optional[asyncio.Semaphore] = None
        self._group_sems: Dict[str, asyncio.Semaphore] = {}
        self._group_pools: Dict[str, "ActorExecutor"] = {}
        if is_async:
            self._start_async_loop(concurrency_groups or {})
        else:
            self._start_threads(max_concurrency)

    # ---------------------------------------------------------- sync actors
    def _start_threads(self, n: int) -> None:
        for i in range(max(1, n)):
            self._threads.spawn(
                self._thread_main,
                f"actor-{self.actor_id.hex()[:6]}-{i}")

    def _thread_main(self) -> None:
        while True:
            with self._cv:
                while not self._runnable_locked():
                    if self.dead:
                        return
                    # periodic wake (RC17): the loop re-checks
                    # dead/runnable, so a lost notify costs one wake
                    # period instead of a wedged executor thread
                    self._cv.wait(
                        Config.instance().actor_executor_wake_s)
                call = heapq.heappop(self._heap)
                if self.max_concurrency == 1:
                    self._next_seq = call.seq_no + 1
                self._inflight += 1
            try:
                call.execute()
            finally:
                # no notify: workers only wait for heap items, and
                # completion never makes a queued item newly runnable
                # (for max_concurrency==1, _next_seq advanced at pop)
                with self._lock:
                    self._inflight -= 1

    def _runnable_locked(self) -> bool:
        if not self._heap:
            return False
        if self.max_concurrency == 1 and not self.execute_out_of_order:
            # strict sequence order (sequential_actor_submit_queue.cc)
            return self._heap[0].seq_no <= self._next_seq
        # out-of-order (or concurrent): anything queued is dispatchable
        # (out_of_order_actor_scheduling_queue.cc)
        return True

    # --------------------------------------------------------- async actors
    def _start_async_loop(self, concurrency_groups: Dict[str, int]) -> None:
        started = threading.Event()

        def _loop_main():
            loop = asyncio.new_event_loop()
            asyncio.set_event_loop(loop)
            self._loop = loop
            self._sem = asyncio.Semaphore(self.max_concurrency)
            for name, limit in concurrency_groups.items():
                self._group_sems[name] = asyncio.Semaphore(limit)
            started.set()
            loop.run_forever()
            # drain cancelled tasks on exit
            pending = asyncio.all_tasks(loop)
            for task in pending:
                task.cancel()
            if pending:
                loop.run_until_complete(
                    asyncio.gather(*pending, return_exceptions=True))
            loop.close()

        self._threads.spawn(
            _loop_main, f"actor-{self.actor_id.hex()[:6]}-loop")
        started.wait()

    # ------------------------------------------------------------ submission
    def submit(self, seq_no: int, method_name: str, execute: Callable[[], None],
               fail: Optional[Callable[[], None]] = None,
               concurrency_group: str = "") -> None:
        if self.dead:
            if fail is not None:
                fail()
            return
        if self.is_async:
            sem = self._group_sems.get(concurrency_group, self._sem)
            with self._lock:
                self._async_pending += 1

            async def _run():
                try:
                    async with sem:
                        if self.dead:
                            if fail is not None:
                                fail()
                            return
                        result = execute()
                        if inspect.isawaitable(result):
                            await result
                finally:
                    with self._lock:
                        self._async_pending -= 1

            def _schedule():
                asyncio.ensure_future(_run())

            self._loop.call_soon_threadsafe(_schedule)
        else:
            with self._cv:
                if self.dead:
                    call_fail = fail
                else:
                    heapq.heappush(
                        self._heap,
                        _QueuedCall(seq_no=seq_no, method_name=method_name,
                                    execute=execute, fail=fail),
                    )
                    self._cv.notify_all()
                    call_fail = None
            if call_fail is not None:
                call_fail()

    def pending_count(self) -> int:
        with self._lock:
            return len(self._heap) + self._inflight + self._async_pending

    # -------------------------------------------------------------- shutdown
    def kill(self) -> None:
        with self._cv:
            self.dead = True
            dropped = list(self._heap)
            self._heap.clear()
            self._cv.notify_all()
        # process-backed actors: terminate the dedicated worker process
        on_kill = getattr(self.instance, "__ray_on_kill__", None)
        if on_kill is not None:
            try:
                on_kill()
            except Exception:
                logger.exception("error terminating actor worker process")
        for call in dropped:
            if call.fail is not None:
                try:
                    call.fail()
                except Exception:
                    logger.exception("error failing dropped actor call")
        if self.is_async and self._loop is not None:
            try:
                self._loop.call_soon_threadsafe(self._loop.stop)
            except RuntimeError as e:
                # loop already closed by a prior kill
                logger.debug("async actor loop stop raced a prior "
                             "kill: %r", e)
        # executor threads saw `dead` (or the loop stop): join them by
        # name under a short budget — a method call wedged past death
        # surfaces as a WARN instead of a leaked thread
        self._threads.join_all(timeout=1.0)


@dataclass
class ActorRecord:
    actor_id: ActorID
    state: ActorState
    creation_spec: Any                      # ActorCreationSpec
    node_id: Optional[NodeID] = None
    executor: Optional[ActorExecutor] = None
    name: Optional[str] = None
    namespace: str = ""
    detached: bool = False
    restarts_remaining: int = 0
    num_restarts: int = 0
    death_cause: str = ""
    # calls buffered while pending/restarting: (submit_fn)
    buffered_calls: List[Callable[[], None]] = field(default_factory=list)
    seq_counter: int = 0
    lock: threading.Lock = field(default_factory=threading.Lock)

    def next_seq(self) -> int:
        with self.lock:
            seq = self.seq_counter
            self.seq_counter += 1
            return seq


class ActorDirectory:
    """GCS-side actor bookkeeping: FSM + named-actor registry
    (reference: gcs/gcs_server/gcs_actor_manager.cc)."""

    def __init__(self):
        self._lock = threading.RLock()
        self._actors: Dict[ActorID, ActorRecord] = {}
        self._named: Dict[Tuple[str, str], ActorID] = {}

    def register(self, record: ActorRecord) -> None:
        with self._lock:
            if record.name:
                key = (record.namespace, record.name)
                existing = self._named.get(key)
                if existing is not None:
                    rec = self._actors.get(existing)
                    if rec is not None and rec.state is not ActorState.DEAD:
                        raise ValueError(
                            f"Actor name {record.name!r} already taken in "
                            f"namespace {record.namespace!r}")
                self._named[key] = record.actor_id
            self._actors[record.actor_id] = record

    def get(self, actor_id: ActorID) -> Optional[ActorRecord]:
        with self._lock:
            return self._actors.get(actor_id)

    def get_by_name(self, name: str, namespace: str) -> Optional[ActorRecord]:
        with self._lock:
            aid = self._named.get((namespace, name))
            return self._actors.get(aid) if aid else None

    def set_state(self, actor_id: ActorID, state: ActorState) -> None:
        with self._lock:
            rec = self._actors.get(actor_id)
            if rec:
                rec.state = state

    def mark_dead(self, actor_id: ActorID, cause: str = "") -> None:
        with self._lock:
            rec = self._actors.get(actor_id)
            if rec:
                rec.state = ActorState.DEAD
                rec.death_cause = cause
                if rec.name:
                    self._named.pop((rec.namespace, rec.name), None)

    def list(self) -> List[ActorRecord]:
        with self._lock:
            return list(self._actors.values())

    def flush_buffered(self, actor_id: ActorID) -> None:
        with self._lock:
            rec = self._actors.get(actor_id)
            if not rec:
                return
            calls, rec.buffered_calls = rec.buffered_calls, []
        for call in calls:
            call()
