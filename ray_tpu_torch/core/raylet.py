"""Per-node scheduling and dispatch — the raylet.

Re-implements the reference raylet's scheduling pipeline
(src/ray/raylet/node_manager.h, cluster_task_manager.h:111-125):

  submit -> [schedule: pick node over cluster matrix] -> local? queue for
  dispatch -> [resolve arg dependencies] -> [allocate resources]
  -> run on a worker | remote? forward (spillback) | nowhere? infeasible

Differences from the reference, by design:
  - Scheduling is *batched*: each tick drains the pending queue, groups
    tasks by SchedulingClass, and runs one vectorized placement solve over
    the dense [nodes x resources] matrix (BatchedHybridPolicy) instead of
    an O(nodes) scan per task.
  - In-process mode workers are threads with stable WorkerIDs; the
    multiprocess runtime swaps in OS-process workers behind the same
    WorkerPool interface (reference: worker_pool.h:144).

All cluster state a raylet needs is injected (ClusterState), mirroring the
reference's callback-injected ClusterTaskManager (cluster_task_manager.h:
127-145) so the whole pipeline is unit-testable with synthetic state.
"""

from __future__ import annotations

import logging
import threading
import time
from collections import defaultdict, deque
from operator import attrgetter

from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Set

import numpy as np

from ray_tpu_torch._private.config import Config
from ray_tpu_torch._private.device import resolve_device
from ray_tpu_torch._private.ids import NodeID, TaskID, WorkerID
from ray_tpu_torch.core.task_spec import (
    NodeAffinitySchedulingStrategy,
    PlacementGroupSchedulingStrategy,
    TaskSpec,
)
from ray_tpu_torch.scheduler.policy import (
    BatchedHybridPolicy,
    DeviceMatrixMirror,
    HybridPolicy,
    SchedulingOptions,
    shared_batched_policy,
)
from ray_tpu_torch.scheduler.resources import (
    NodeResources,
    ResourceMatrix,
    ResourceRequest,
    StringIdMap,
)

logger = logging.getLogger(__name__)

# dispatch fast lane: C-level accessor for the bulk-dispatch hot loop
# (any(map(...)) over this beats a Python-level genexpr pass)
_GET_CANCELLED = attrgetter("cancelled")


class _TickRateLimiter:
    """Per-raylet sampling gate for tick anatomy.

    Replaces the old ``_TickPhases._last_start`` class global, which was
    read and written unsynchronized from every scheduling thread AND
    shared between unrelated Raylet instances — in an in-process
    cluster one chatty raylet could starve every other raylet's anatomy
    for the whole interval. One limiter per Raylet, one lock per
    decision; a fresh raylet's first tick is always instrumented."""

    __slots__ = ("_lock", "_last")

    def __init__(self):
        self._lock = threading.Lock()
        self._last = 0.0

    def try_acquire(self, now: float, min_interval: float) -> bool:
        # Lock-free fast reject: `_last` is a monotonically increasing
        # float, so a torn/stale read can only UNDER-estimate it — the
        # worst case is falling through to the locked re-check, never a
        # wrongly suppressed sample. A micro-tick storm (the submit hot
        # path: one task per tick) pays a clock read + compare here and
        # skips the lock entirely between samples.
        if now - self._last < min_interval:
            return False
        with self._lock:
            if now - self._last < min_interval:
                return False
            self._last = now
            return True

    def reset(self) -> None:
        """Forget the last instrumented tick (bench/tests defeat the
        rate limit deterministically through this)."""
        with self._lock:
            self._last = 0.0


class _TickPhases:
    """Named-phase timer for one scheduling tick (observability plane).

    Phase semantics: collect (drain pending under the raylet lock) |
    refresh (fold matrix deltas, incl. the device-mirror sync) | solve
    (host solve, or time BLOCKED pulling a device result) | overlap
    (host commit/placement work done while a device solve is still in
    flight — the pipelined tick's win shows up here) | commit
    (placement bookkeeping with no solve in flight, incl. the per-task
    scan for strategy tasks and the single-node fast path) | spillback
    (remote re-submits) | dispatch (worker fan-out). Marks are
    monotonic deltas and ACCUMULATE per phase, so the pipelined drain
    loop's repeated passes still report disjoint, truthful sums;
    flush() feeds the scheduler_phase_ms histogram and, when a sampled
    trace is active, a per-tick span tree — which is how BENCH prints
    where the tick wall time goes (ROADMAP Open item 2: the
    80 k/s-vs-3.4 M gap lives between the solves).

    Cost control: instrumented ticks are rate-limited to one per
    ``MIN_INTERVAL_S`` per raylet (via its :class:`_TickRateLimiter`) —
    a storm of micro-ticks (one task each, the submit hot path) pays
    only a clock read + lock + compare per tick, while any tick that
    runs longer than the interval is always captured (the window has
    necessarily elapsed by the time the next tick constructs its
    timer). Zero-cost when the plane is off: one bool check per mark.
    """

    __slots__ = ("enabled", "phases", "_t", "wall_start")

    PHASES = ("collect", "refresh", "solve", "overlap", "commit",
              "spillback", "dispatch")
    MIN_INTERVAL_S = 0.01

    def __init__(self, enabled: bool,
                 limiter: Optional[_TickRateLimiter] = None):
        self.phases: Dict[str, float] = {}
        if enabled:
            now = time.monotonic()
            if limiter is not None and not limiter.try_acquire(
                    now, self.MIN_INTERVAL_S):
                enabled = False  # anatomy sampled out for this tick
            else:
                self._t = now
                # raycheck: disable=RC02 — wall-clock span timestamp for trace correlation, not deadline arithmetic
                self.wall_start = time.time()
        self.enabled = enabled
        if not enabled:
            self._t = 0.0
            self.wall_start = 0.0

    def mark(self, phase: str) -> None:
        if not self.enabled:
            return
        now = time.monotonic()
        self.phases[phase] = self.phases.get(phase, 0.0) \
            + (now - self._t)
        self._t = now

    def flush(self) -> None:
        if not self.enabled or not self.phases:
            return
        try:
            from ray_tpu_torch.observability.metrics import scheduler_phase_ms

            for phase, dt in self.phases.items():
                scheduler_phase_ms.observe(dt * 1e3,
                                           tags={"phase": phase})
        except Exception as e:
            logger.debug("tick phase metrics failed: %r", e)
        from ray_tpu_torch.util import tracing

        if tracing.enabled():
            tracing.record_span_tree(
                "scheduler.tick", self.wall_start,
                [(f"scheduler.tick.{p}", self.phases[p])
                 for p in self.PHASES if p in self.phases],
                attributes={f"{p}_ms": round(dt * 1e3, 3)
                            for p, dt in self.phases.items()})


class ClusterState:
    """Shared cluster resource view: the dense matrix + raylet registry.

    In-process this is literally shared; in multiprocess mode each node
    holds a replica kept fresh by the GCS resource broadcast (reference:
    gcs_resource_manager.cc + grpc_based_resource_broadcaster.cc).

    ``device`` is where the cluster's device placement solves and its
    matrix mirror live: CUDA unless the caller asks for the CPU.
    """

    def __init__(self, device=None):
        self.device = resolve_device(device)
        self.ids = StringIdMap()
        self.matrix = ResourceMatrix(self.ids)
        self.raylets: Dict[NodeID, "Raylet"] = {}
        self.lock = threading.RLock()
        # topology epoch: bumped on every node death/removal, read by
        # the pipelined tick's fencing check (Config.tick_epoch_fencing)
        # — a device solve launched under epoch E commits only if the
        # topology is still E; otherwise its counts were computed
        # against a matrix with a dead node in it and are re-solved on
        # host. Guarded by ``lock``.
        self.epoch = 0
        # invoked whenever a node frees resources (PG retries hook here)
        self.freed_callbacks: List[Callable[[], None]] = []
        # raylets whose local_resources changed since the matrix was last
        # refreshed; rows are folded in lazily at the next read (the
        # resource-report batching of gcs_resource_report_poller.cc, in
        # lazy form) so the per-task dispatch/finish path stays O(1)
        self._dirty: set = set()
        # lazy device-resident mirror of `matrix` — only pipelined
        # device ticks pay for it (one per cluster: the matrix it
        # shadows is cluster-wide)
        self.device_mirror: Optional[DeviceMatrixMirror] = None

    def device_mirror_locked(self) -> DeviceMatrixMirror:
        """The cluster's device matrix mirror. Caller holds ``lock``."""
        if self.device_mirror is None:
            # on the shared policy's stream: mirror updates and solves
            # are ordered on one queue
            self.device_mirror = DeviceMatrixMirror(
                self.device, shared_batched_policy(self.device).stream)
        return self.device_mirror

    def notify_freed(self) -> None:
        for cb in list(self.freed_callbacks):
            try:
                cb()
            except Exception:
                logger.exception("resource-freed callback failed")

    def register(self, raylet: "Raylet") -> None:
        with self.lock:
            self.raylets[raylet.node_id] = raylet
            self.matrix.upsert(raylet.node_id, raylet.local_resources)

    def unregister(self, node_id: NodeID) -> None:
        with self.lock:
            self.raylets.pop(node_id, None)
            self.matrix.set_alive(node_id, False)
            self.epoch += 1  # fences any in-flight pipelined solve

    def set_draining(self, node_id: NodeID) -> None:
        """Drain plane: exclude NODE from every placement solve via the
        matrix alive mask (the same row every tick, spillback, and PG
        pack reads) while the raylet itself keeps running — queued and
        running work finishes or spills; nothing new lands. The epoch
        bump fences in-flight pipelined device solves exactly like
        unregister, so a double-buffered batch solved against the
        pre-drain mask is discarded instead of committed."""
        with self.lock:
            if node_id not in self.raylets:
                return
            self.matrix.set_alive(node_id, False)
            self.epoch += 1

    def sync(self, raylet: "Raylet") -> None:
        """Mark a raylet's matrix row stale; folded in by refresh_locked
        at the next scheduling read."""
        with self.lock:
            self._dirty.add(raylet)

    def refresh_locked(self) -> None:
        """Fold pending resource changes into the dense matrix. Caller
        must hold ``self.lock``."""
        if self._dirty:
            for raylet in self._dirty:
                if raylet.node_id in self.raylets:
                    self.matrix.upsert(raylet.node_id,
                                       raylet.local_resources)
            self._dirty.clear()

    def alive_raylets(self) -> List["Raylet"]:
        with self.lock:
            self.refresh_locked()
            return [
                r for r in self.raylets.values()
                if self.matrix.alive[self.matrix.slot_of(r.node_id)]
            ]


@dataclass(eq=False)
class _PendingTask:
    # eq=False keeps object-identity hashing, so the raylet's running
    # set can hold the tasks themselves and register a whole dispatch
    # grant with one C-level set.update — a TaskID-keyed dict paid a
    # Python-level __hash__ call per insert on the hottest tick path
    spec: TaskSpec
    on_dispatch: Callable[["Raylet", WorkerID], None]
    spillback_count: int = 0
    cancelled: bool = False


class WorkerPool:
    """Thread-backed worker pool with stable worker identities.

    PopWorker/PushWorker shaped like the reference (worker_pool.h:74) but
    leases are implicit: dispatch just runs on a pool thread and the
    executing thread adopts a WorkerID. Work travels through a C-level
    SimpleQueue — cheaper per task than ThreadPoolExecutor, which builds
    a Future (with its Condition) per submit on the hottest path.
    Threads spawn on demand up to max_workers, like the reference's
    worker-pool prestart-on-demand."""

    def __init__(self, node_id: NodeID, max_workers: int = 256):
        import queue

        from ray_tpu_torch.cluster.threads import ThreadRegistry

        self.node_id = node_id
        self.max_workers = max_workers
        # raycheck: disable=RC10 — admission happens upstream: an item only enqueues after local_resources.allocate() succeeded, so depth is bounded by the node's resource capacity
        self._queue: "queue.SimpleQueue" = queue.SimpleQueue()
        self._tls = threading.local()
        self._lock = threading.Lock()
        self._num_started = 0
        self._num_threads = 0
        self._idle = 0
        self._claimed = 0  # idle slots pre-claimed by in-flight submits
        self._shutdown = False
        self._name_prefix = f"worker-{node_id.hex()[:6]}"
        # worker threads spawn through the registry so shutdown() can
        # join them by name and surface a hung task (raycheck RC09)
        self._threads = ThreadRegistry(self._name_prefix)

    def current_worker_id(self) -> WorkerID:
        wid = getattr(self._tls, "worker_id", None)
        if wid is None:
            wid = WorkerID.from_random()
            self._tls.worker_id = wid
            with self._lock:
                self._num_started += 1
        return wid

    def submit(self, fn: Callable, *args) -> bool:
        """False when the pool is already shut down (node died)."""
        if self._shutdown:
            return False
        # Reserve an idle worker for this item ATOMICALLY, or spawn a new
        # thread. Two concurrent submits must not both claim one idle
        # worker and neither spawn (ThreadPoolExecutor reserves via its
        # idle semaphore; this lock plays that role).
        with self._lock:
            if self._shutdown:
                return False
            if self._idle > 0:
                self._idle -= 1  # claimed; the dequeuing worker skips its
                #                  own decrement via _claimed
                self._claimed += 1
            elif self._num_threads < self.max_workers:
                self._num_threads += 1
                self._threads.spawn(
                    self._worker_loop,
                    f"{self._name_prefix}-{self._num_threads}")
        self._queue.put((fn, args))
        return True

    def submit_batch(self, items: List[tuple]) -> bool:
        """Batched submit (the dispatch fast lane's worker fan-out):
        claim idle workers and spawn threads for the WHOLE group under
        one lock acquisition, then enqueue every item — instead of one
        lock round trip per task. ``items`` are ``(fn, args)`` tuples,
        exactly what :meth:`_worker_loop` dequeues. False when the pool
        is already shut down (node died) — no item was enqueued."""
        if self._shutdown:
            return False
        n = len(items)
        if not n:
            return True
        with self._lock:
            if self._shutdown:
                return False
            claim = self._idle if self._idle < n else n
            if claim:
                self._idle -= claim
                self._claimed += claim
            spawn = n - claim
            if spawn > self.max_workers - self._num_threads:
                spawn = self.max_workers - self._num_threads
            for _ in range(spawn):
                self._num_threads += 1
                self._threads.spawn(
                    self._worker_loop,
                    f"{self._name_prefix}-{self._num_threads}")
        put = self._queue.put
        for item in items:
            put(item)
        return True

    def _worker_loop(self) -> None:
        self.current_worker_id()
        while True:
            with self._lock:
                self._idle += 1
            item = self._queue.get()
            with self._lock:
                if self._claimed > 0:
                    # a submit already decremented _idle on our behalf
                    self._claimed -= 1
                else:
                    self._idle -= 1
            if item is None or self._shutdown:
                return
            fn, args = item
            try:
                fn(*args)
            except Exception:
                logger.exception("uncaught error in worker task")

    def shutdown(self) -> None:
        self._shutdown = True
        with self._lock:
            for _ in range(self._num_threads):
                self._queue.put(None)
        # sentinels unblock every worker; join them by name so a task
        # wedged past shutdown is WARN-logged instead of leaking (a
        # short budget: in-process shutdown must stay snappy)
        self._threads.join_all(timeout=0.5)

    @property
    def num_started(self) -> int:
        return self._num_started


class DependencyManager:
    """Waits for a task's ObjectRef arguments to be locally available
    (reference: raylet/dependency_manager.h:49 driving the PullManager)."""

    def __init__(self, object_store):
        self._store = object_store

    def wait_ready(self, spec: TaskSpec, callback: Callable[[], None]) -> None:
        if not spec.args and not spec.kwargs:  # hot path: no deps at all
            callback()
            return
        from ray_tpu_torch.core.object_ref import ObjectRef

        deps = [a.id() for a in spec.args if isinstance(a, ObjectRef)]
        deps += [v.id() for v in spec.kwargs.values() if isinstance(v, ObjectRef)]
        if not deps:
            callback()
            return
        remaining = len(deps)
        lock = threading.Lock()

        def _one_ready():
            nonlocal remaining
            with lock:
                remaining -= 1
                done = remaining == 0
            if done:
                # spilled args restore under TASK_ARGS admission — below
                # get/wait requests in the pull manager's priority order
                # (reference: DependencyManager drives the PullManager
                # with TASK_ARGS bundles)
                from ray_tpu_torch.exceptions import ObjectCorruptedError
                from ray_tpu_torch.scheduler.pull_manager import BundlePriority

                try:
                    self._store.restore_spilled(
                        deps, priority=BundlePriority.TASK_ARGS)
                except ObjectCorruptedError as e:
                    # a spilled arg failed its digest and dropped
                    # itself (integrity plane). This callback runs on
                    # the PUTTING thread, so recovery can't block
                    # here: proceed — the task's own arg resolution
                    # surfaces the miss, and ray.get-driven lineage
                    # reconstruction recovers the object
                    logger.warning("task arg corrupt at restore: %s", e)
                callback()

        for oid in deps:
            self._store.on_available(oid, _one_ready)

    def wait_ready_batch(self, tasks: List["_PendingTask"],
                         ready_cb: Callable[[List["_PendingTask"]], None],
                         one_cb: Callable[["_PendingTask"], None]) -> None:
        """Batched readiness check (dispatch fast lane). Tasks with no
        arguments at all — the hot case; there is nothing to wait for —
        are collected and handed to ``ready_cb`` in ONE call so the
        caller can fan them out to workers as a group. Everything else
        takes the exact per-task :meth:`wait_ready` path with
        ``one_cb`` (per-dependency callbacks cannot batch: each task
        becomes ready at its own time)."""
        ready: List["_PendingTask"] = []
        for task in tasks:
            spec = task.spec
            if not spec.args and not spec.kwargs:
                ready.append(task)
            else:
                self.wait_ready(spec, lambda t=task: one_cb(t))
        if ready:
            ready_cb(ready)


class Raylet:
    def __init__(
        self,
        node_id: NodeID,
        resources: Dict[str, float],
        cluster: ClusterState,
        dependency_manager: DependencyManager,
        labels: Optional[Dict[str, str]] = None,
        max_workers: int = 256,
    ):
        self.node_id = node_id
        self.cluster = cluster
        self.local_resources = NodeResources.from_map(resources, cluster.ids)
        if labels:
            self.local_resources.labels.update(labels)
        self.worker_pool = WorkerPool(node_id, max_workers=max_workers)
        self.deps = dependency_manager
        self._lock = threading.RLock()
        # pending placement decisions, FIFO within scheduling class
        # raycheck: disable=RC10 — bounded by the submit() admission check (raylet_max_queued_tasks): over-bound fresh submits are pushed back with RetryLaterError
        self._pending: deque[_PendingTask] = deque()
        # placed locally, waiting for deps+resources; one FIFO queue per
        # resource-demand key so a dispatch tick is O(demand shapes), not
        # O(tasks) (reference: per-SchedulingClass lease queues in
        # cluster_task_manager.cc:295)
        self._dispatch_queues: Dict[tuple, deque] = {}
        self._dispatch_len = 0
        self._infeasible: List[_PendingTask] = []
        self._by_task_id: Dict[TaskID, _PendingTask] = {}
        # running tasks by identity — finish_task recovers the grant to
        # free from the spec's memoized resource_request (warm for every
        # task by submit time), so dispatch writes nothing per task
        self._running_tasks: Set[_PendingTask] = set()
        # PG 2PC bundle states ("prepared"|"committed") keyed by
        # (pg_id, bundle_index) — prepare/commit/return are idempotent,
        # mirroring the process tier's contract (raylet_server.py)
        self._pg_bundles: Dict[tuple, str] = {}
        self.policy = HybridPolicy()
        # numpy water-filling for ticks under the device threshold; the
        # device solve goes through shared_batched_policy(cluster.device)
        self.batched_policy = BatchedHybridPolicy()
        self._spread_rr = 0  # round-robin cursor for SPREAD strategy
        self._tick_limiter = _TickRateLimiter()
        self.num_scheduled = 0
        self.num_spilled_back = 0
        self.dead = False

    @property
    def _running(self) -> Dict[TaskID, ResourceRequest]:
        """Monitoring/test view of the running set, keyed by TaskID
        like the dict it replaced (load_metrics truthiness, test-suite
        iteration). Built on demand — callers hold ``_lock``; the hot
        paths only touch ``_running_tasks``."""
        return {t.spec.task_id: t.spec.resource_request(self.cluster.ids)
                for t in tuple(self._running_tasks)}

    # ------------------------------------------------------------------ API
    def submit(self, spec: TaskSpec,
               on_dispatch: Callable[["Raylet", WorkerID], None],
               spillback_count: int = 0) -> None:
        """QueueAndScheduleTask (reference cluster_task_manager.cc:500).

        Fresh submits (spillback_count == 0) pass an admission check: a
        backlog at or over ``raylet_max_queued_tasks`` raises
        :class:`~ray_tpu_torch.exceptions.RetryLaterError` so Runtime.submit
        slows the producer down instead of the queues growing without
        bound. Spillbacks are exempt — they already hold a placement
        decision, and bouncing them mid-schedule_tick would lose work.
        """
        task = _PendingTask(spec, on_dispatch, spillback_count)
        if spillback_count == 0:
            from ray_tpu_torch.observability.metrics import tasks_submitted

            cfg = Config.instance()
            if cfg.overload_enabled:
                with self._lock:
                    backlog = len(self._pending) + self._dispatch_len
                if backlog >= cfg.raylet_max_queued_tasks:
                    from ray_tpu_torch.exceptions import RetryLaterError
                    from ray_tpu_torch.observability.metrics import tasks_shed

                    tasks_shed.inc()
                    raise RetryLaterError(
                        f"raylet {self.node_id.hex()[:8]} backlog is "
                        f"full ({backlog} queued); slow down",
                        retry_after_s=min(2.0, 0.02 + 1e-4 * backlog))
            tasks_submitted.inc()
            # FAST PATH — the lease-reuse analogue (reference: tasks with
            # a known SchedulingKey pipeline onto an already-leased local
            # worker, direct_task_transport.cc:150 OnWorkerIdle): a plain
            # task with no backlog and local capacity skips the placement
            # solve and dispatches immediately.
            if (spec.scheduling_strategy is None
                    and not self._pending and not self._dispatch_len):
                req = spec.resource_request(self.cluster.ids)
                with self._lock:
                    if self.local_resources.allocate(req):
                        self._running_tasks.add(task)
                        self._by_task_id[spec.task_id] = task
                        self.num_scheduled += 1
                        dispatched = True
                    else:
                        dispatched = False
                if dispatched:
                    self.cluster.sync(self)
                    self.deps.wait_ready(
                        spec, lambda t=task: self._run_task(t))
                    return
        with self._lock:
            self._pending.append(task)
            self._by_task_id[spec.task_id] = task
        self.schedule_tick()

    def submit_batch(self, tasks: List[_PendingTask]) -> None:
        """Spillback fan-in: accept a whole batch of already-placed
        tasks from a peer raylet in ONE frame — one lock acquisition
        and one scheduling tick for the group, instead of the per-task
        submit()/tick cycle the old spillback loop paid. Spillbacks are
        admission-exempt exactly as in :meth:`submit`: they already
        hold a placement decision and bouncing them would lose work."""
        if not tasks:
            return
        with self._lock:
            for task in tasks:
                self._pending.append(task)
                self._by_task_id[task.spec.task_id] = task
        self.schedule_tick()

    def cancel(self, task_id: TaskID) -> bool:
        with self._lock:
            task = self._by_task_id.get(task_id)
            if task is None:
                return False
            task.cancelled = True
            return True

    # ------------------------------------------------------- scheduling tick
    def schedule_tick(self) -> None:
        """Drain the pending queue through batched placement solves.

        Two implementations behind the ``scheduler_pipeline_enabled``
        master switch:

        - OFF: :meth:`_schedule_tick_single`, the exact single-buffered
          tick (one batch, solve blocks inside the cluster lock, the
          per-task commit walk) — bit-for-bit the pre-pipeline path.
        - ON: :meth:`_schedule_tick_pipelined`, the drain loop that
          double-buffers device solves against host commit work,
          solves against the cluster's device-resident matrix mirror,
          and commits/spills in vectorized batches.

        Observability plane: either tick is split into the named phases
        of :class:`_TickPhases` (collect → refresh → solve → overlap →
        commit → spillback → dispatch), observed into the
        ``scheduler_phase_ms`` histogram per tick so bench/status
        readouts can pin which phase the tick wall time goes to."""
        from ray_tpu_torch.cluster import overload as _overload
        from ray_tpu_torch.observability.metrics import scheduler_ticks

        scheduler_ticks.inc()
        cfg = Config.instance()
        # lane_enabled = the master switch AND'd with the scheduler
        # lane breaker: K consecutive fenced/failed pipelined ticks
        # degrade to the single-buffered tick until a half-open probe
        # tick survives (Config.fastlane_breaker_*)
        if _overload.lane_enabled("scheduler"):
            try:
                fenced = self._schedule_tick_pipelined(cfg)
            except BaseException:
                _overload.lane_failed("scheduler")
                raise
            if fenced:
                _overload.lane_failed("scheduler")
            else:
                _overload.lane_ok("scheduler")
        else:
            self._schedule_tick_single(cfg)

    def _schedule_tick_single(self, cfg: Config) -> None:
        """The single-buffered tick: one batch per call, the device
        solve (if any) pulled synchronously, per-task commit. Kept
        verbatim as the ``scheduler_pipeline_enabled=False`` reference
        semantics — same placements for the same seed as every release
        before the pipeline landed."""
        ph = _TickPhases(cfg.observability_plane_enabled,
                         self._tick_limiter)
        with self._lock:
            if not self._pending:
                self._dispatch_tick()
                return
            batch: List[_PendingTask] = []
            while self._pending and len(batch) < cfg.scheduler_max_tasks_per_tick:
                batch.append(self._pending.popleft())
        ph.mark("collect")
        placed_remote: List[tuple[_PendingTask, "Raylet"]] = []
        with self.cluster.lock:
            self.cluster.refresh_locked()
            ph.mark("refresh")
            matrix = self.cluster.matrix
            local_slot = matrix.slot_of(self.node_id)
            # Single-alive-node fast path: every placement answer is
            # "here" (or infeasible) — skip the policy solve entirely.
            # NodeAffinity to a *missing* node is the one strategy that
            # can still answer differently; route those to the slow path.
            if (local_slot is not None
                    and int(matrix.alive.sum()) == 1
                    and bool(matrix.alive[local_slot])):
                for task in batch:
                    if task.cancelled:
                        self._finish_cancelled(task)
                        continue
                    strategy = task.spec.scheduling_strategy
                    if isinstance(strategy, NodeAffinitySchedulingStrategy):
                        slot = self._schedule_one_locked(
                            task, matrix, local_slot)
                    else:
                        req = task.spec.resource_request(self.cluster.ids)
                        slot = (local_slot
                                if self.local_resources.is_feasible(req)
                                else None)
                    if slot is None:
                        self._mark_infeasible(task)
                        continue
                    self._commit_placement(task, slot, matrix, placed_remote)
                batch = []
            # Partition: plain tasks batch through the vectorized solve,
            # strategy/spillback-constrained ones take the per-task scan.
            per_class: Dict[int, List[_PendingTask]] = defaultdict(list)
            singles: List[_PendingTask] = []
            for task in batch:
                if task.cancelled:
                    self._finish_cancelled(task)
                elif (task.spec.scheduling_strategy is None
                      and task.spillback_count == 0):
                    per_class[task.spec.scheduling_class].append(task)
                else:
                    singles.append(task)
            threshold = cfg.scheduler_batch_threshold
            big_classes: List[List[_PendingTask]] = []
            for tasks in per_class.values():
                if len(tasks) < threshold:
                    singles.extend(tasks)
                else:
                    big_classes.append(tasks)
            if big_classes:
                reqs = np.stack([
                    tasks[0].spec.resource_request(self.cluster.ids)
                    .dense(matrix.width) for tasks in big_classes])
                ks = np.array([len(tasks) for tasks in big_classes],
                              dtype=np.int64)
                opts = SchedulingOptions.default()
                cells = matrix.total.shape[0] * len(big_classes)
                if (cfg.scheduler_use_vectorized_policy
                        and cfg.scheduler_device_solve_min_cells >= 0
                        and cells >= cfg.scheduler_device_solve_min_cells):
                    # Device path on the LIVE tier: one whole-tick solve
                    # on the cluster's device, then the exact int64
                    # repair (north-star: scheduling_policy.cc:150
                    # replaced behind the ISchedulingPolicy-shaped seam).
                    # Ticks under the cell threshold stay on numpy: the
                    # JAX package's routing, not a device fallback.
                    dev = shared_batched_policy(self.cluster.device)
                    counts_dev = dev.schedule_tick_fused(
                        reqs, ks, matrix.total, matrix.available,
                        matrix.alive, local_slot, opts)
                    counts = dev.repair_oversubscription(
                        reqs, counts_dev.pull(), matrix.available)
                else:
                    counts = self.batched_policy.schedule_classes(
                        reqs, ks, matrix.total, matrix.available,
                        matrix.alive, local_slot, opts)
                ph.mark("solve")
                for tasks, row in zip(big_classes, counts):
                    it = iter(tasks)
                    for slot in np.flatnonzero(row):
                        for _ in range(int(row[slot])):
                            self._commit_placement(
                                next(it), int(slot), matrix, placed_remote)
                    # capacity-exhausted leftovers: feasible-but-
                    # unavailable nodes are still legal targets (they
                    # queue for dispatch)
                    singles.extend(it)
            for task in singles:
                slot = self._schedule_one_locked(task, matrix, local_slot)
                if slot is None:
                    self._mark_infeasible(task)
                    continue
                self._commit_placement(task, slot, matrix, placed_remote)
            ph.mark("commit")
        for task, raylet in placed_remote:
            self.num_spilled_back += 1
            with self._lock:
                self._by_task_id.pop(task.spec.task_id, None)
            raylet.submit(task.spec, task.on_dispatch,
                          spillback_count=task.spillback_count + 1)
        ph.mark("spillback")
        self._dispatch_tick()
        ph.mark("dispatch")
        ph.flush()

    # drain-loop runaway guard: leftovers past this many batches stay
    # queued for the next tick call (the old path's one-batch-per-call
    # bound, relaxed enough for the 100k drain to finish in one call)
    _MAX_PIPELINE_BATCHES = 4096

    def _schedule_tick_pipelined(self, cfg: Config) -> bool:
        """Pipelined drain loop (ROADMAP Open item 2). Per iteration::

          host:   collect_i·refresh_i·dispatch-solve_i·singles_i | commit_{i-1}·spill_{i-1}·dispatch_{i-1}
          device:  ...___solve_{i-1}___________________________/ \\___solve_i___...

        (a) Double-buffered solves: the fused device solve for batch i
        is DISPATCHED asynchronously under the cluster lock (torch ops
        queue on the solve stream without a host sync) and its counts are pulled
        one iteration later, OUTSIDE every lock, after the host has
        finished committing batch i-1 — solve and commit wall time
        overlap instead of summing. (b) The solve reads the cluster's
        :class:`~ray_tpu_torch.scheduler.policy.DeviceMatrixMirror` (dirty-
        row delta copies into the device buffers in place) instead of
        re-coercing and re-uploading the full matrix every batch.
        (c) Commit and spillback fan out vectorized (_commit_counts /
        _spillback_batched).

        Soundness: a pipelined solve is stale by at most the previous
        batch's dispatch allocations, so its counts pass
        ``repair_oversubscription`` against the CURRENT exact int64
        host availability before committing — a stale solve can only
        under-place (leftovers re-route through the per-task path),
        and allocation itself stays exact at dispatch time (placement
        is a queueing decision, not an allocation). The OFF switch
        (``scheduler_pipeline_enabled=False``) reproduces the old
        single-buffered tick bit-for-bit.

        Epoch fencing (``tick_epoch_fencing``): each dispatched solve
        carries the cluster topology epoch it was launched under; a
        node death between launch and commit bumps the epoch, and the
        commit discards the stale device counts and re-solves on host
        against the repaired matrix. Returns True when any batch in
        this tick was fenced (the scheduler lane breaker's failure
        signal)."""
        ph = _TickPhases(cfg.observability_plane_enabled,
                         self._tick_limiter)
        opts = SchedulingOptions.default()
        inflight = None  # prev batch's (big_classes, reqs, counts_dev, epoch)
        fenced = False
        batches = 0
        while batches < self._MAX_PIPELINE_BATCHES:
            with self._lock:
                batch: List[_PendingTask] = []
                while (self._pending
                       and len(batch) < cfg.scheduler_max_tasks_per_tick):
                    batch.append(self._pending.popleft())
            ph.mark("collect")
            if not batch and inflight is None:
                break
            batches += 1
            placed_remote: List[tuple] = []
            solve_ctx = None
            if batch:
                solve_ctx, placed_remote = self._pipeline_front_half(
                    cfg, opts, batch, ph)
            if placed_remote:
                self._spillback_batched(placed_remote)
                ph.mark("spillback")
            if inflight is not None:
                # OVERLAP: the device is (possibly) solving THIS batch
                # while the host repairs/commits the PREVIOUS one
                fenced |= self._finish_device_batch(
                    inflight, ph, cfg, solving=solve_ctx is not None)
            inflight = solve_ctx
            self._dispatch_tick()
            ph.mark("dispatch")
        if batches == 0:
            self._dispatch_tick()
            ph.mark("dispatch")
        ph.flush()
        return fenced

    def _pipeline_front_half(self, cfg: Config, opts: SchedulingOptions,
                             batch: List[_PendingTask], ph: _TickPhases):
        """Collect-side half of one drain iteration: refresh cluster
        state, DISPATCH (not pull) the device solve for this batch, and
        place everything needing per-task treatment (fast path,
        strategy singles, host-solved classes). Returns ``(solve_ctx,
        placed_remote)``; solve_ctx carries the in-flight device solve
        or is None when the batch fully resolved on host."""
        placed_remote: List[tuple] = []
        solve_ctx = None
        with self.cluster.lock:
            self.cluster.refresh_locked()
            ph.mark("refresh")
            matrix = self.cluster.matrix
            local_slot = matrix.slot_of(self.node_id)
            # Single-alive-node fast path — identical to the single tick.
            if (local_slot is not None
                    and int(matrix.alive.sum()) == 1
                    and bool(matrix.alive[local_slot])):
                for task in batch:
                    if task.cancelled:
                        self._finish_cancelled(task)
                        continue
                    strategy = task.spec.scheduling_strategy
                    if isinstance(strategy, NodeAffinitySchedulingStrategy):
                        slot = self._schedule_one_locked(
                            task, matrix, local_slot)
                    else:
                        req = task.spec.resource_request(self.cluster.ids)
                        slot = (local_slot
                                if self.local_resources.is_feasible(req)
                                else None)
                    if slot is None:
                        self._mark_infeasible(task)
                        continue
                    self._commit_placement(task, slot, matrix,
                                           placed_remote)
                batch = []
            per_class: Dict[int, List[_PendingTask]] = defaultdict(list)
            singles: List[_PendingTask] = []
            for task in batch:
                if task.cancelled:
                    self._finish_cancelled(task)
                elif (task.spec.scheduling_strategy is None
                      and task.spillback_count == 0):
                    per_class[task.spec.scheduling_class].append(task)
                else:
                    singles.append(task)
            threshold = cfg.scheduler_batch_threshold
            big_classes: List[List[_PendingTask]] = []
            for tasks in per_class.values():
                if len(tasks) < threshold:
                    singles.extend(tasks)
                else:
                    big_classes.append(tasks)
            if big_classes:
                reqs = np.stack([
                    tasks[0].spec.resource_request(self.cluster.ids)
                    .dense(matrix.width) for tasks in big_classes])
                ks = np.array([len(tasks) for tasks in big_classes],
                              dtype=np.int64)
                cells = matrix.total.shape[0] * len(big_classes)
                if (cfg.scheduler_use_vectorized_policy
                        and cfg.scheduler_device_solve_min_cells >= 0
                        and cells >= cfg.scheduler_device_solve_min_cells):
                    # solve against the device-resident mirror and
                    # return WITHOUT blocking — the pull happens next
                    # iteration, outside every lock (raycheck RC01
                    # posture: no device sync under cluster.lock)
                    mirror = self.cluster.device_mirror_locked()
                    total_d, avail_d, alive_d, _up = mirror.refresh(
                        matrix, cfg.scheduler_matrix_sync_period,
                        cfg.scheduler_pipeline_debug_check)
                    dev = shared_batched_policy(self.cluster.device)
                    counts_dev = dev.schedule_tick_fused(
                        reqs, ks, total_d, avail_d, alive_d, local_slot,
                        opts)
                    # the topology epoch this solve saw (lock is held):
                    # _finish_device_batch fences on a mismatch
                    solve_ctx = (big_classes, reqs, counts_dev,
                                 self.cluster.epoch)
                    ph.mark("refresh")
                else:
                    counts = self.batched_policy.schedule_classes(
                        reqs, ks, matrix.total, matrix.available,
                        matrix.alive, local_slot, opts)
                    ph.mark("solve")
                    singles.extend(self._commit_counts(
                        big_classes, counts, matrix, placed_remote))
            for task in singles:
                slot = self._schedule_one_locked(task, matrix, local_slot)
                if slot is None:
                    self._mark_infeasible(task)
                    continue
                self._commit_placement(task, slot, matrix, placed_remote)
            ph.mark("overlap" if solve_ctx is not None else "commit")
        return solve_ctx, placed_remote

    def _finish_device_batch(self, inflight: tuple, ph: _TickPhases,
                             cfg: Config, solving: bool) -> bool:
        """Back half of the pipeline: pull the device counts (the ONE
        device sync point, outside every lock), repair them against the
        current exact int64 availability, and commit/spill the batch
        through the vectorized fan-out.

        Epoch fence: if the cluster topology changed (a node died)
        between the solve's launch and this commit, the device counts
        targeted slots that no longer exist — with
        ``tick_epoch_fencing`` on they are discarded wholesale and the
        batch re-solves on host against the repaired matrix (correct
        but unoverlapped: the price of the fence, paid only on
        topology change). Returns True when this batch was fenced."""
        big_classes, reqs, counts_dev, solve_epoch = inflight
        # blocks on the solve stream's event until the counts land
        counts = counts_dev.pull()
        ph.mark("solve")
        fenced = False
        placed_remote: List[tuple] = []
        with self.cluster.lock:
            self.cluster.refresh_locked()
            matrix = self.cluster.matrix
            local_slot = matrix.slot_of(self.node_id)
            if (cfg.tick_epoch_fencing
                    and solve_epoch != self.cluster.epoch):
                fenced = True
                from ray_tpu_torch.observability.metrics import tick_epoch_fences
                tick_epoch_fences.inc()
                ks = np.array([len(tasks) for tasks in big_classes],
                              dtype=np.int64)
                counts = self.batched_policy.schedule_classes(
                    reqs, ks, matrix.total, matrix.available,
                    matrix.alive, local_slot,
                    SchedulingOptions.default())
                ph.mark("solve")
            counts = BatchedHybridPolicy.repair_oversubscription(
                reqs, counts, matrix.available)
            leftovers = self._commit_counts(big_classes, counts, matrix,
                                            placed_remote)
            for task in leftovers:
                slot = self._schedule_one_locked(task, matrix, local_slot)
                if slot is None:
                    self._mark_infeasible(task)
                    continue
                self._commit_placement(task, slot, matrix, placed_remote)
            ph.mark("overlap" if solving else "commit")
        if placed_remote:
            self._spillback_batched(placed_remote)
            ph.mark("spillback")
        return fenced

    def _commit_counts(self, big_classes: List[List[_PendingTask]],
                       counts: np.ndarray, matrix: ResourceMatrix,
                       placed_remote: List[tuple]
                       ) -> List[_PendingTask]:
        """Vectorized commit fan-out: group each class's placements by
        target slot with numpy instead of the per-task
        ``zip/iter/flatnonzero`` walk, extend each local dispatch deque
        in ONE locked pass, and collect remote placements for the
        per-raylet batched spillback. Iteration order is exactly the
        old loop's — tasks stay FIFO within their class and slots
        ascend. Returns capacity-exhausted leftovers (the old path's
        ``singles.extend(it)``). Caller holds the cluster lock."""
        leftovers: List[_PendingTask] = []
        local_slot = matrix.slot_of(self.node_id)
        counts = np.asarray(counts, dtype=np.int64)
        local_groups: List[tuple] = []  # (demand key, task group)
        n_local = 0
        for ci, tasks in enumerate(big_classes):
            row = counts[ci]
            nz = np.flatnonzero(row)
            placed = int(row[nz].sum()) if nz.size else 0
            if placed < len(tasks):
                leftovers.extend(tasks[placed:])
                tasks = tasks[:placed]
            if not placed:
                continue
            self.num_scheduled += placed
            bounds = np.cumsum(row[nz])
            # one demand key per class: members share the scheduling
            # class, hence the resource request
            key = tasks[0].spec.resource_request(self.cluster.ids).key()
            for j, slot in enumerate(nz.tolist()):
                group = tasks[int(bounds[j] - row[slot]):int(bounds[j])]
                if slot == local_slot:
                    local_groups.append((key, group))
                    n_local += len(group)
                else:
                    target = self.cluster.raylets.get(matrix.node_at(slot))
                    if target is None:
                        # the node died between solve and commit (epoch
                        # fencing off, or a same-tick race): re-route
                        # the group through the per-task path instead
                        # of crashing the tick thread on a KeyError
                        leftovers.extend(group)
                        continue
                    placed_remote.extend((t, target) for t in group)
        if local_groups:
            with self._lock:
                for key, group in local_groups:
                    q = self._dispatch_queues.get(key)
                    if q is None:
                        # raycheck: disable=RC10 — fed only by committed placements, which submit()'s admission check already bounded
                        q = self._dispatch_queues[key] = deque()
                    q.extend(group)
                self._dispatch_len += n_local
        return leftovers

    def _spillback_batched(self, placed_remote: List[tuple]) -> None:
        """Spillback fan-out, one frame per target raylet: the old loop
        re-submitted one task at a time, re-entering the target's lock
        and tick per task. Group by target and hand each raylet its
        whole batch through :meth:`submit_batch`."""
        by_target: Dict["Raylet", List[_PendingTask]] = {}
        with self._lock:
            for task, raylet in placed_remote:
                self._by_task_id.pop(task.spec.task_id, None)
                by_target.setdefault(raylet, []).append(task)
        self.num_spilled_back += len(placed_remote)
        for raylet, tasks in by_target.items():
            raylet.submit_batch([
                _PendingTask(t.spec, t.on_dispatch, t.spillback_count + 1)
                for t in tasks])

    def _mark_infeasible(self, task: _PendingTask) -> None:
        with self._lock:
            self._infeasible.append(task)
        logger.warning(
            "task %s is infeasible on the cluster (demand=%s)",
            task.spec.name, task.spec.resources)

    def _commit_placement(self, task: _PendingTask, slot: int,
                          matrix: ResourceMatrix,
                          placed_remote: List[tuple]) -> None:
        self.num_scheduled += 1
        target = matrix.node_at(slot)
        if target == self.node_id:
            with self._lock:
                # keyed on the DEMAND (not scheduling_class) so the
                # stop-at-blocked-head dispatch below can never starve a
                # smaller task that shares a class id by accident
                key = task.spec.resource_request(self.cluster.ids).key()
                q = self._dispatch_queues.get(key)
                if q is None:
                    # raycheck: disable=RC10 — fed only by committed placements, which submit()'s admission check already bounded
                    q = self._dispatch_queues[key] = deque()
                q.append(task)
                self._dispatch_len += 1
        else:
            placed_remote.append((task, self.cluster.raylets[target]))

    def _schedule_one_locked(self, task: _PendingTask, matrix: ResourceMatrix,
                             local_slot: int) -> Optional[int]:
        """Pick a node slot for one task. Called under cluster lock."""
        spec = task.spec
        req = spec.resource_request(self.cluster.ids)
        dense = req.dense(matrix.width)
        opts = SchedulingOptions.default()
        strategy = spec.scheduling_strategy
        if isinstance(strategy, NodeAffinitySchedulingStrategy):
            nid = strategy.node_id
            if isinstance(nid, str):
                nid = NodeID.from_hex(nid)
            aff_slot = matrix.slot_of(nid)
            if aff_slot is None and not strategy.soft:
                return None
            opts.node_affinity_slot = aff_slot
            opts.node_affinity_soft = strategy.soft
        elif strategy == "SPREAD":
            opts.spread_strategy = True
        # Forwarded strategy tasks are grant-or-reject: the placing raylet
        # already solved for this node, and re-solving here with this
        # node's own strategy cursors would ping-pong SPREAD tasks
        # between nodes. Plain forwarded tasks get ONE full re-solve
        # (they might fit elsewhere if this node lost capacity in
        # flight), then grant-or-reject on the second hop (reference:
        # direct_task_transport.cc grant_or_reject escalation).
        if task.spillback_count >= (1 if strategy is not None else 2):
            if self.local_resources.is_feasible(req):
                return local_slot
            return None
        slot = self.policy.schedule_one(
            dense, matrix.total, matrix.available, matrix.alive,
            local_slot, opts)
        if slot < 0:
            return None
        if opts.spread_strategy:
            # round-robin for successive SPREAD tasks over nodes with the
            # resources AVAILABLE now; nodes that are merely feasible
            # (total >= demand but saturated) are the fallback only —
            # SPREAD must not land on a busy node while idle ones exist
            # (reference: HybridPolicy spread path prefers available).
            feasible = np.flatnonzero(
                matrix.alive & np.all(matrix.total >= dense, axis=1))
            if len(feasible):
                open_now = feasible[np.all(
                    matrix.available[feasible] >= dense, axis=1)]
                pool = open_now if len(open_now) else feasible
                slot = int(pool[self._spread_rr % len(pool)])
                self._spread_rr += 1
        return slot

    # --------------------------------------------------------- dispatch tick
    def _dispatch_tick(self) -> None:
        """DispatchScheduledTasksToWorkers (cluster_task_manager.cc:295):
        resolve deps, allocate resources, run.

        Two implementations behind the ``dispatch_fastlane_enabled``
        master switch:

        - OFF: the exact per-task loop below — one resource-request
          decode, one allocate, one popleft, one wait_ready callback
          per task — bit-for-bit the pre-fast-lane path.
        - ON: :meth:`_dispatch_tick_fastlane`, which exploits the
          queue key invariant (every member of one dispatch queue has
          an EQUAL resource request) to decode once, allocate in bulk,
          and fan out to workers in batches."""
        if Config.instance().dispatch_fastlane_enabled:
            self._dispatch_tick_fastlane()
            return
        to_start: List[_PendingTask] = []
        with self._lock:
            # Per class: dispatch heads while resources allow, stop the
            # class at its first blocked lease (same-demand members behind
            # it can't fit either).
            for cls in list(self._dispatch_queues):
                q = self._dispatch_queues[cls]
                while q:
                    task = q[0]
                    if task.cancelled:
                        q.popleft()
                        self._dispatch_len -= 1
                        self._finish_cancelled(task)
                        continue
                    req = task.spec.resource_request(self.cluster.ids)
                    if not self.local_resources.allocate(req):
                        break
                    q.popleft()
                    self._dispatch_len -= 1
                    self._running_tasks.add(task)
                    to_start.append(task)
                if not q:
                    del self._dispatch_queues[cls]
        if to_start:
            self.cluster.sync(self)
        for task in to_start:
            self.deps.wait_ready(
                task.spec, lambda t=task: self._run_task(t))

    def _dispatch_tick_fastlane(self) -> None:
        """Bulk per-class dispatch — the fast lane's answer to the 82 %
        dispatch wall (BENCH_r06 ``tick_phase_ms.dispatch``). Dispatch
        queues are keyed on the resource-DEMAND key, so every task in
        one queue carries an equal request: decode it once per class,
        compute how many heads fit with one integer division per
        resource, pop them in bulk, and subtract the whole grant in a
        single pass — O(classes + dispatched) lock work instead of a
        per-task decode + availability scan + allocate + popleft. The
        started tasks enter the running set by identity in one bulk
        ``set.update`` (``finish_task`` frees via the spec's memoized
        request, so nothing is written per task). Stop-at-blocked-head is
        preserved: a class loops until its bulk count comes back zero,
        exactly where the per-task walk would have parked. Worker
        fan-out batches through ``wait_ready_batch`` →
        :meth:`_run_task_batch` so dep-free groups enter the pool under
        one pool-lock acquisition."""
        to_start: List[_PendingTask] = []
        with self._lock:
            avail = self.local_resources.available
            for cls in list(self._dispatch_queues):
                q = self._dispatch_queues[cls]
                while q:
                    head = q[0]
                    if head.cancelled:
                        q.popleft()
                        self._dispatch_len -= 1
                        self._finish_cancelled(head)
                        continue
                    req = head.spec.resource_request(self.cluster.ids)
                    demands = req.demands
                    k = len(q)
                    for rid, amt in demands.items():
                        have = avail.get(rid, 0)
                        if have < amt:
                            k = 0
                            break
                        fit = have // amt
                        if fit < k:
                            k = int(fit)
                    if k <= 0:
                        break
                    if k == len(q):
                        popped = list(q)
                        q.clear()
                    else:
                        popped = [q.popleft() for _ in range(k)]
                    self._dispatch_len -= k
                    # cancelled tasks caught in the bulk pop consume no
                    # grant: count the started ones, charge only those.
                    # The no-cancellation case (nearly always) registers
                    # the whole grant with one C-level set.update — the
                    # task objects themselves are the running markers,
                    # and finish_task recovers the request to free from
                    # the spec's memo, so the registration writes
                    # NOTHING per task.
                    if any(map(_GET_CANCELLED, popped)):
                        started = 0
                        for task in popped:
                            if task.cancelled:
                                self._finish_cancelled(task)
                            else:
                                self._running_tasks.add(task)
                                to_start.append(task)
                                started += 1
                    else:
                        self._running_tasks.update(popped)
                        to_start.extend(popped)
                        started = k
                    if started:
                        for rid, amt in demands.items():
                            avail[rid] = avail.get(rid, 0) - amt * started
                if not q:
                    del self._dispatch_queues[cls]
        if not to_start:
            return
        self.cluster.sync(self)
        wrb = getattr(self.deps, "wait_ready_batch", None)
        if wrb is None:
            for task in to_start:
                self.deps.wait_ready(
                    task.spec, lambda t=task: self._run_task(t))
        else:
            wrb(to_start, self._run_task_batch, self._run_task)

    def _exec_one(self, task: _PendingTask) -> None:
        wid = self.worker_pool.current_worker_id()
        try:
            task.on_dispatch(self, wid)
        finally:
            self.finish_task(task.spec.task_id)

    def _run_task(self, task: _PendingTask) -> None:
        if task.spec.submit_time:
            from ray_tpu_torch.observability.metrics import scheduling_latency

            scheduling_latency.observe(
                time.monotonic() - task.spec.submit_time)
        if not self.worker_pool.submit(self._exec_one, task):
            # node died between placement and execution — hand the task
            # back to the owner (reference: worker death → owner resubmit)
            self.finish_task(task.spec.task_id)
            self._report_lost(task)

    def _run_task_batch(self, tasks: List[_PendingTask]) -> None:
        """Fan a dep-free group out to the worker pool in ONE batched
        enqueue (``WorkerPool.submit_batch``): one pool-lock round trip
        claims/spawns workers for the whole group, and per-task cost
        drops to building an ``(fn, args)`` tuple + a queue put."""
        from ray_tpu_torch.observability.metrics import scheduling_latency

        now = time.monotonic()
        for task in tasks:
            if task.spec.submit_time:
                scheduling_latency.observe(now - task.spec.submit_time)
        items = [(self._exec_one, (task,)) for task in tasks]
        if not self.worker_pool.submit_batch(items):
            for task in tasks:
                self.finish_task(task.spec.task_id)
                self._report_lost(task)

    def finish_task(self, task_id: TaskID) -> None:
        with self._lock:
            task = self._by_task_id.pop(task_id, None)
            if task is not None and task in self._running_tasks:
                self._running_tasks.discard(task)
                # memo hit: every submit path decodes the request once
                # before the task can reach dispatch
                req = task.spec.resource_request(self.cluster.ids)
            else:
                req = None
            if req is not None:
                self.local_resources.free(req)
            # freed-capacity fast path: hand the slot(s) straight to the
            # local dispatch queue (lease handoff) instead of re-running
            # the placement solve per completion. Loop: freeing a large
            # allocation may unblock SEVERAL queued tasks at once.
            handoff: List[_PendingTask] = []
            if req is not None and self._dispatch_len:
                for cls in list(self._dispatch_queues):
                    q = self._dispatch_queues[cls]
                    while q:
                        head = q[0]
                        if head.cancelled:
                            break  # rare: let the full tick reap it
                        head_req = head.spec.resource_request(
                            self.cluster.ids)
                        if not self.local_resources.allocate(head_req):
                            break
                        q.popleft()
                        self._dispatch_len -= 1
                        self._running_tasks.add(head)
                        handoff.append(head)
                    if not q:
                        del self._dispatch_queues[cls]
        if req is not None:
            from ray_tpu_torch.observability.metrics import tasks_finished

            tasks_finished.inc()
            self.cluster.sync(self)
            self.cluster.notify_freed()
            if handoff:
                for next_task in handoff:
                    self.deps.wait_ready(
                        next_task.spec,
                        lambda t=next_task: self._run_task(t))
                with self._lock:
                    more = bool(self._pending)
                if more:
                    self.schedule_tick()
            else:
                self.schedule_tick()

    def _finish_cancelled(self, task: _PendingTask) -> None:
        from ray_tpu_torch.core import runtime as rt_mod

        with self._lock:
            self._by_task_id.pop(task.spec.task_id, None)
        rt = rt_mod.global_runtime
        if rt is not None:
            rt.store_task_cancelled(task.spec)

    # ------------------------------------------------ placement group 2PC
    # Idempotent by (pg_id, bundle_index), like the process tier: a
    # retried prepare does not double-reserve, a duplicated commit does
    # not double-apply shadow capacity, a repeated return does not
    # double-free (reference: placement_group_resource_manager.h's
    # bundle state table).
    def _bundle_key(self, pg_id, bundle_index: int) -> tuple:
        from ray_tpu_torch.scheduler.placement_group import _pg_hex

        return (_pg_hex(pg_id), bundle_index)

    def prepare_bundle(self, pg_id, bundle_index: int,
                       bundle: Dict[str, float]) -> bool:
        """Phase 1: reserve the bundle's raw resources
        (reference: NewPlacementGroupResourceManager::PrepareBundle)."""
        key = self._bundle_key(pg_id, bundle_index)
        req = ResourceRequest.from_map(bundle, self.cluster.ids)
        with self._lock:
            if key in self._pg_bundles:
                return True  # retried prepare: reservation exists
            ok = self.local_resources.allocate(req)
            if ok:
                self._pg_bundles[key] = "prepared"
        if ok:
            self.cluster.sync(self)
        return ok

    def commit_bundle(self, pg_id, bundle_index: int,
                      bundle: Dict[str, float]) -> None:
        """Phase 2: expose the shadow resources tasks schedule against."""
        from ray_tpu_torch.scheduler.placement_group import shadow_resources_for_bundle

        key = self._bundle_key(pg_id, bundle_index)
        with self._lock:
            if self._pg_bundles.get(key) == "committed":
                return  # duplicated commit: applied exactly once
            self._pg_bundles[key] = "committed"
        self.add_capacity(shadow_resources_for_bundle(
            bundle, pg_id, bundle_index))

    def return_bundle(self, pg_id, bundle_index: int,
                      bundle: Dict[str, float], committed: bool = False
                      ) -> None:
        from ray_tpu_torch.scheduler.placement_group import shadow_resources_for_bundle

        key = self._bundle_key(pg_id, bundle_index)
        with self._lock:
            state = self._pg_bundles.pop(key, None)
        if state is None:
            return  # repeated return: already freed
        if committed and state == "committed":
            for name in shadow_resources_for_bundle(bundle, pg_id,
                                                    bundle_index):
                self.remove_capacity(name)
        req = ResourceRequest.from_map(bundle, self.cluster.ids)
        with self._lock:
            self.local_resources.free(req)
        self.cluster.sync(self)
        self.schedule_tick()

    # ------------------------------------------------- resource manipulation
    def adjust_resources(self, deltas: Dict[str, float],
                         allocate: bool) -> bool:
        """Allocate (True) or free (False) resources outside a task's own
        demand — used for actor lifetime downgrades and PG bundles."""
        req = ResourceRequest.from_map(deltas, self.cluster.ids)
        with self._lock:
            if allocate:
                ok = self.local_resources.allocate(req)
            else:
                self.local_resources.free(req)
                ok = True
        self.cluster.sync(self)
        if not allocate:
            self.schedule_tick()
        return ok

    def add_capacity(self, resources: Dict[str, float]) -> None:
        with self._lock:
            for name, amount in resources.items():
                rid = self.cluster.ids.get_id(name)
                from ray_tpu_torch.scheduler.resources import to_fixed

                self.local_resources.add_capacity(rid, to_fixed(amount))
        self.cluster.sync(self)
        self.retry_infeasible()

    def remove_capacity(self, resource_name: str) -> None:
        with self._lock:
            rid = self.cluster.ids.get_id(resource_name)
            self.local_resources.remove_capacity(rid)
        self.cluster.sync(self)

    def retry_infeasible(self) -> None:
        with self._lock:
            infeasible, self._infeasible = self._infeasible, []
            self._pending.extend(infeasible)
        if infeasible:
            self.schedule_tick()

    def _report_lost(self, task: _PendingTask) -> None:
        from ray_tpu_torch.core import runtime as rt_mod

        rt = rt_mod.global_runtime
        if rt is not None:
            rt.resubmit_lost_task(task.spec)

    def extract_outstanding(self) -> List[_PendingTask]:
        """Drain every task that has not started running — called when
        this node dies so the owner can resubmit (reference: raylet death
        fails leases; CoreWorker retries)."""
        with self._lock:
            out = list(self._pending) + list(self._infeasible)
            for q in self._dispatch_queues.values():
                out.extend(q)
            running = self._running_tasks
            self._pending.clear()
            self._dispatch_queues.clear()
            self._dispatch_len = 0
            self._infeasible.clear()
            seen = {t.spec.task_id for t in out}
            for task_id, task in list(self._by_task_id.items()):
                if task not in running and task_id not in seen:
                    out.append(task)
            self._by_task_id.clear()
        return out

    # ------------------------------------------------------------- lifecycle
    def drain(self, timeout: float = 5.0) -> bool:
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            with self._lock:
                if not (self._pending or self._dispatch_len
                        or self._running_tasks):
                    return True
            time.sleep(0.001)
        return False

    def shutdown(self) -> None:
        self.dead = True
        self.worker_pool.shutdown()

    def debug_state(self) -> dict:
        with self._lock:
            return {
                "node_id": self.node_id.hex(),
                "pending": len(self._pending),
                "dispatch_queue": self._dispatch_len,
                "infeasible": len(self._infeasible),
                "running": len(self._running_tasks),
                "num_scheduled": self.num_scheduled,
                "num_spilled_back": self.num_spilled_back,
                "available": self.local_resources.to_map(
                    self.cluster.ids, available=True),
                "total": self.local_resources.to_map(self.cluster.ids),
            }
