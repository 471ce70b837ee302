"""The per-process runtime — composition root of the core.

Equivalent of the reference's CoreWorker + in-process cluster bring-up
(core_worker/core_worker.cc, python/ray/node.py): owns the object store,
reference counter, the local (or simulated multi-node) cluster of raylets,
the actor directory, and the task manager that implements retries.

In-process mode runs the *entire* cluster in one process: N raylets
(thread worker pools) sharing one zero-copy object store — the analogue of
the reference's cluster_utils.Cluster (python/ray/cluster_utils.py:101)
but cheap enough to be the default for tests and single-host work. The
multiprocess runtime (ray_tpu_torch.cluster) swaps process-backed raylets in
behind the same interfaces.
"""

from __future__ import annotations

import logging
import os
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple

from ray_tpu_torch._private.config import Config
from ray_tpu_torch._private.device import resolve_device
from ray_tpu_torch._private.ids import (
    ActorID,
    JobID,
    NodeID,
    ObjectID,
    TaskID,
    WorkerID,
)
from ray_tpu_torch.core.actor_runtime import (
    ActorDirectory,
    ActorExecutor,
    ActorRecord,
    ActorState,
)
from ray_tpu_torch.core.object_ref import ObjectRef
from ray_tpu_torch.core.object_store import MemoryStore
from ray_tpu_torch.core.raylet import (
    ClusterState,
    DependencyManager,
    Raylet,
    _TickRateLimiter,
)
from ray_tpu_torch.core.ref_count import ReferenceCounter
from ray_tpu_torch.core.task_spec import (
    ActorCreationSpec,
    TaskKind,
    TaskSpec,
    scheduling_class_of,
)
from ray_tpu_torch.exceptions import (
    ActorDiedError,
    RayActorError,
    RayTaskError,
    TaskCancelledError,
)
from ray_tpu_torch.util import tracing as _tracing

logger = logging.getLogger(__name__)

global_runtime: Optional["Runtime"] = None
_init_lock = threading.Lock()
_job_counter = 0
_job_counter_lock = threading.Lock()

# fast-lane submit spans: at most one per runtime per this interval
# (mirrors _TickPhases.MIN_INTERVAL_S — anatomy sampling, not a log)
_SUBMIT_SPAN_MIN_INTERVAL_S = 0.01


def _next_job_id() -> JobID:
    """Process-unique job ids. time.time() seconds is NOT unique enough:
    two runtimes created within one second would share a job id, hence a
    driver task id, hence colliding put/return ObjectIDs."""
    global _job_counter
    with _job_counter_lock:
        _job_counter += 1
        return JobID.from_int(
            ((os.getpid() & 0xFFFF) << 16 | (_job_counter & 0xFFFF)))


def _lineage_cost(spec: "TaskSpec") -> int:
    """Estimated bytes a cached lineage spec pins. Dominated by inline
    bytes-like arguments (large values travel by ObjectID and cost
    nothing here); the flat overhead covers the spec object itself."""
    cost = 256
    for a in spec.args:
        if isinstance(a, (bytes, bytearray, memoryview)):
            cost += len(a)
    for v in spec.kwargs.values():
        if isinstance(v, (bytes, bytearray, memoryview)):
            cost += len(v)
    return cost


@dataclass
class WorkerContext:
    """Thread-local execution context (reference: core_worker context)."""
    task_id: TaskID = None
    actor_id: Optional[ActorID] = None
    node_id: Optional[NodeID] = None
    worker_id: Optional[WorkerID] = None
    put_counter: int = 0
    task_depth: int = 0
    assigned_resources: Dict[str, float] = field(default_factory=dict)


class Runtime:
    def __init__(
        self,
        num_cpus: Optional[float] = None,
        num_gpus: Optional[float] = None,
        resources: Optional[Dict[str, float]] = None,
        object_store_memory: Optional[int] = None,
        namespace: Optional[str] = None,
        job_id: Optional[JobID] = None,
        worker_mode: str = "thread",
        num_process_workers: Optional[int] = None,
        device=None,
    ):
        cfg = Config.instance()
        # the device the scheduling plane's placement solve runs on:
        # explicit, never a silent CPU fallback (None means CUDA)
        self.device = resolve_device(device)
        if worker_mode not in ("thread", "process"):
            raise ValueError(f"unknown worker_mode {worker_mode!r}")
        self.job_id = job_id or _next_job_id()
        self.namespace = namespace or f"anon_{os.urandom(4).hex()}"
        self.object_store = MemoryStore()
        from ray_tpu_torch.scheduler.pull_manager import PullManager

        self.pull_manager = PullManager(self.object_store.capacity)
        self.object_store.pull_manager = self.pull_manager
        self.reference_counter = ReferenceCounter()
        self.reference_counter.set_eviction_callback(self._evict_object)
        self.cluster_state = ClusterState(self.device)
        self.actor_directory = ActorDirectory()
        self.kv: Dict[Tuple[str, bytes], bytes] = {}  # internal KV (gcs_kv_manager.cc)
        self._kv_lock = threading.Lock()
        self._tls = threading.local()
        self._driver_task_id = TaskID.for_driver(self.job_id)
        self._task_counter = 0
        self._lock = threading.Lock()
        # Fast-lane submit spans are SAMPLED, not per-call: a traced
        # submit storm otherwise pays span construction (name f-string,
        # context stamp, exporter fan-out) on every remote() — the
        # 13%-overhead regression of the submit micro. One sampled span
        # per interval keeps representative anatomy; unsampled submits
        # skip the span machinery entirely.
        self._submit_span_limiter = _TickRateLimiter()
        self.deps = DependencyManager(self.object_store)
        # Lineage cache: finished NORMAL task specs kept for object
        # reconstruction (reference: lineage pinning in
        # reference_count.h + TaskManager::ResubmitTask,
        # object_recovery_manager.cc). LRU-bounded.
        from collections import OrderedDict

        self._lineage: "OrderedDict[TaskID, TaskSpec]" = OrderedDict()
        self._lineage_cost: Dict[TaskID, int] = {}
        self._lineage_bytes = 0
        self._lineage_lock = threading.Lock()
        self._reconstructing: set = set()
        node_resources = dict(resources or {})
        node_resources.setdefault("CPU", num_cpus if num_cpus is not None
                                  else float(os.cpu_count() or 1))
        if num_gpus:
            node_resources["GPU"] = num_gpus
        node_resources.setdefault(
            "memory", float(cfg.object_store_memory))
        node_resources.setdefault(
            "object_store_memory", float(object_store_memory
                                         or cfg.object_store_memory))
        self.process_pool = None
        self._process_shm = None
        if worker_mode == "process":
            self._start_process_pool(num_process_workers)
        self.head_raylet = self.add_node(node_resources, is_head=True)
        from ray_tpu_torch.scheduler.placement_group import PlacementGroupManager

        self.pg_manager = PlacementGroupManager(self)
        self.cluster_state.freed_callbacks.append(self.pg_manager.retry_pending)
        self.is_shutdown = False

    def _start_process_pool(self, num_workers: Optional[int]) -> None:
        """Process execution tier (reference: worker_pool.cc forks real
        worker processes; objects move via plasma shm). Tasks execute in
        OS processes; large payloads ride the native shm store. Workers
        see no card unless RAY_TPU_WORKER_CUDA_VISIBLE_DEVICES names one
        (cluster/child_env.py)."""
        from ray_tpu_torch.cluster.process_pool import ProcessWorkerPool

        shm_path = ""
        try:
            from ray_tpu_torch._native.shm_store import (
                ShmStore,
                native_available,
            )

            if native_available():
                self._process_shm = ShmStore()
                shm_path = self._process_shm.path
        except Exception:
            logger.info("native shm store unavailable; process workers "
                        "will use inline pipe transport")
        size = num_workers or min(8, os.cpu_count() or 4)
        self.process_pool = ProcessWorkerPool(size, shm_path)

    # ----------------------------------------------------------- node mgmt
    def add_node(self, resources: Dict[str, float], is_head: bool = False,
                 labels: Optional[Dict[str, str]] = None) -> Raylet:
        node_id = NodeID.from_random()
        raylet = Raylet(node_id, resources, self.cluster_state, self.deps,
                        labels=labels)
        self.cluster_state.register(raylet)
        for r in self.cluster_state.raylets.values():
            r.retry_infeasible()
        # new capacity may unblock pending placement groups
        self.cluster_state.notify_freed()
        return raylet

    def drain_node(self, node_id: NodeID,
                   deadline_s: Optional[float] = None) -> None:
        """Graceful in-process node removal (drain plane): the node
        leaves every placement solve immediately (ClusterState.
        set_draining flips its matrix alive-mask row), queued and
        running work gets the drain deadline to finish or spill, and
        whatever is left falls to remove_node's recovery path — a
        wedged drain degrades to the hard-removal semantics instead of
        stranding work. With the plane off this IS remove_node."""
        cfg = Config.instance()
        raylet = self.cluster_state.raylets.get(node_id)
        if raylet is None:
            return
        if not cfg.drain_plane_enabled:
            self.remove_node(node_id)
            return
        self.cluster_state.set_draining(node_id)
        raylet.drain(cfg.drain_deadline_s if deadline_s is None
                     else deadline_s)
        self.remove_node(node_id)

    def remove_node(self, node_id: NodeID) -> None:
        raylet = self.cluster_state.raylets.get(node_id)
        if raylet is None:
            return
        self.cluster_state.unregister(node_id)
        lost = raylet.extract_outstanding()
        raylet.shutdown()
        # Resubmit tasks the dead node never ran (reference: raylet death
        # fails outstanding leases; the owning CoreWorker retries).
        for task in lost:
            self.resubmit_lost_task(task.spec)
        # Fail actors that lived on this node; restart if budget remains.
        for rec in self.actor_directory.list():
            if rec.node_id == node_id and rec.state is ActorState.ALIVE:
                self._handle_actor_node_death(rec)
        pg_manager = getattr(self, "pg_manager", None)
        if pg_manager is not None:
            pg_manager.handle_node_death(node_id)

    # ------------------------------------------------------------- context
    def context(self) -> WorkerContext:
        ctx = getattr(self._tls, "ctx", None)
        if ctx is None:
            # Threads the executor did not set up (user-spawned threads,
            # e.g. train-session threads) must NOT share the driver's
            # task id: each thread's put_counter starts at 0, so two
            # such threads would mint identical ObjectID.for_put ids
            # and silently overwrite each other's puts (the r05
            # allreduce corruption). The driver's main thread keeps the
            # stable driver task id; every other unknown thread gets a
            # fresh unique one.
            import threading as _threading

            if _threading.current_thread() is _threading.main_thread():
                tid = self._driver_task_id
            else:
                tid = TaskID.for_task(None)
            ctx = WorkerContext(task_id=tid,
                                node_id=self.head_raylet.node_id)
            self._tls.ctx = ctx
        return ctx

    def _next_task_id(self, actor_id: Optional[ActorID] = None) -> TaskID:
        return TaskID.for_task(actor_id)

    # ------------------------------------------------------------- put/get
    def put(self, value: Any) -> ObjectRef:
        ctx = self.context()
        ctx.put_counter += 1
        oid = ObjectID.for_put(ctx.task_id, ctx.put_counter)
        self.reference_counter.add_owned_object(oid)
        self.object_store.put(oid, value)
        return ObjectRef(oid)

    def get(self, refs: Sequence[ObjectRef], timeout: Optional[float] = None
            ) -> List[Any]:
        from ray_tpu_torch.exceptions import ObjectCorruptedError

        if Config.instance().enable_object_reconstruction:
            for r in refs:
                if not self.object_store.contains(r.id()):
                    self.maybe_reconstruct(r.id())
        deadline = (None if timeout is None
                    else time.monotonic() + timeout)
        while True:
            remaining = (None if deadline is None
                         else max(0.0, deadline - time.monotonic()))
            try:
                stored = self.object_store.get(
                    [r.id() for r in refs], remaining)
                break
            except ObjectCorruptedError as e:
                # a spilled copy failed its digest and discarded
                # itself (integrity plane): recompute it via lineage
                # and retry the get — the caller sees the correct
                # value or this typed error, never garbage
                if not Config.instance().enable_object_reconstruction:
                    raise
                recovered = False
                for r in refs:
                    if (r.id().hex() == e.object_id_hex
                            and not self.object_store.contains(r.id())):
                        recovered = (self.maybe_reconstruct(r.id())
                                     or recovered)
                if not recovered:
                    raise
        out = []
        for obj in stored:
            if obj.is_error:
                err = obj.value
                if isinstance(err, RayTaskError):
                    raise err.as_instanceof_cause()
                raise err
            out.append(obj.value)
        return out

    def wait(self, refs: Sequence[ObjectRef], num_returns: int,
             timeout: Optional[float]) -> Tuple[List[ObjectRef], List[ObjectRef]]:
        by_id = {r.id(): r for r in refs}
        ready, unready = self.object_store.wait(
            [r.id() for r in refs], num_returns, timeout)
        return [by_id[o] for o in ready], [by_id[o] for o in unready]

    def _evict_object(self, object_id: ObjectID) -> None:
        self.object_store.delete(object_id)

    # -------------------------------------------------------- task submit
    def submit_task(self, func, func_name: str, args: tuple, kwargs: dict,
                    options, template=None) -> List[ObjectRef]:
        if template is not None \
                and Config.instance().dispatch_fastlane_enabled:
            return self._submit_task_fast(func, func_name, args, kwargs,
                                          template)
        ctx = self.context()
        task_id = self._next_task_id()
        resources = options.resolved_resources()
        num_returns = options.num_returns
        return_ids = tuple(
            ObjectID.for_return(task_id, i + 1) for i in range(num_returns))
        strategy = self._resolve_strategy(options, ctx)
        spec = TaskSpec(
            kind=TaskKind.NORMAL,
            task_id=task_id,
            job_id=self.job_id,
            parent_task_id=ctx.task_id,
            name=options.name or func_name,
            func=func,
            func_descriptor=func_name,
            args=args,
            kwargs=kwargs,
            num_returns=num_returns,
            return_ids=return_ids,
            resources=resources,
            scheduling_strategy=strategy,
            max_retries=options.max_retries,
            retries_left=max(0, options.max_retries),
            retry_exceptions=options.retry_exceptions,
            depth=ctx.task_depth + 1,
            runtime_env=_normalize_runtime_env(options.runtime_env),
            submit_time=time.monotonic(),
        )
        # PG options rewrite spec.resources; the class must intern the
        # FINAL demand or same-class tasks would carry different demands
        # (the batch solve and per-class dispatch queues rely on
        # class => one demand).
        self._apply_placement_options(spec, options, ctx)
        spec.scheduling_class = scheduling_class_of(
            spec.resource_request(self.cluster_state.ids), func_name)
        for oid in return_ids:
            self.reference_counter.add_owned_object(oid, creating_task=task_id)
        self._track_arg_refs(spec, add=True)
        refs = [ObjectRef(oid) for oid in return_ids]
        from ray_tpu_torch.util import tracing

        def _stamp(span):
            spec.trace_context = span.context().to_dict()

        with tracing.maybe_span(
                lambda: f"task::{spec.name}.remote",
                attributes_fn=lambda: {"task_id": task_id.hex()},
                on_span=_stamp):
            self._submit_to_raylet(spec)
        return refs

    def _submit_task_fast(self, func, func_name: str, args: tuple,
                          kwargs: dict, template) -> List[ObjectRef]:
        """Fast-lane submit for templated plain tasks (dispatch fast
        lane). The :class:`~ray_tpu_torch.core.task_spec.TaskTemplate` froze
        the resolved resources, retry policy, strategy, and — per
        id-map — the SHARED ResourceRequest and interned scheduling
        class at decoration time, so each call only mints IDs and
        stamps the spec; the per-call ``resolved_resources()`` dict
        build, ``from_map`` id-lock walk, and ``scheduling_class_of``
        global-lock intern all disappear. Placement groups and runtime
        envs never reach here (template eligibility excludes them);
        refcounting, backpressure, and trace propagation follow the
        general path exactly."""
        ctx = self.context()
        task_id = self._next_task_id()
        num_returns = template.num_returns
        if num_returns == 1:  # the overwhelmingly common case: no genexpr
            return_ids = (ObjectID.for_return(task_id, 1),)
        else:
            return_ids = tuple(
                ObjectID.for_return(task_id, i + 1)
                for i in range(num_returns))
        req, scheduling_class = template.demand(self.cluster_state.ids)
        spec = TaskSpec(
            kind=TaskKind.NORMAL,
            task_id=task_id,
            job_id=self.job_id,
            parent_task_id=ctx.task_id,
            name=template.name,
            func=func,
            func_descriptor=func_name,
            args=args,
            kwargs=kwargs,
            num_returns=num_returns,
            return_ids=return_ids,
            # the template's resource map and request are shared across
            # specs: nothing on the plain-task path mutates either (PG
            # rewrites — the one mutator — are template-ineligible)
            resources=template.resources,
            scheduling_class=scheduling_class,
            scheduling_strategy=template.scheduling_strategy,
            max_retries=template.max_retries,
            retries_left=template.retries_left,
            retry_exceptions=template.retry_exceptions,
            depth=ctx.task_depth + 1,
            submit_time=time.monotonic(),
            _req_cache=req,
        )
        add_owned = self.reference_counter.add_owned_object
        for oid in return_ids:
            add_owned(oid, creating_task=task_id)
        if args or kwargs:
            self._track_arg_refs(spec, add=True)
        refs = [ObjectRef(oid) for oid in return_ids]
        if not _tracing.enabled() or not self._submit_span_limiter \
                .try_acquire(time.monotonic(),
                             _SUBMIT_SPAN_MIN_INTERVAL_S):
            # span thunks + the contextmanager frame are measurable at
            # this call rate; spans are sampled to one per interval —
            # a traced submit storm takes this branch for every call
            # between samples (clock read + lock-free compare)
            self._submit_to_raylet(spec)
            return refs

        def _stamp(span):
            spec.trace_context = span.context().to_dict()

        with _tracing.maybe_span(
                lambda: f"task::{spec.name}.remote",
                attributes_fn=lambda: {"task_id": task_id.hex()},
                on_span=_stamp):
            self._submit_to_raylet(spec)
        return refs

    def _resolve_strategy(self, options, ctx) -> Any:
        strategy = options.scheduling_strategy
        if strategy in (None, "DEFAULT"):
            return None
        return strategy

    def _apply_placement_options(self, spec: TaskSpec, options, ctx) -> None:
        pg = getattr(options, "placement_group", None)
        strategy = options.scheduling_strategy
        from ray_tpu_torch.core.task_spec import PlacementGroupSchedulingStrategy

        if isinstance(strategy, PlacementGroupSchedulingStrategy):
            pg = strategy.placement_group
            spec.placement_group_bundle_index = (
                strategy.placement_group_bundle_index)
            spec.capture_child_tasks = bool(
                strategy.placement_group_capture_child_tasks)
        elif pg is not None:
            spec.placement_group_bundle_index = (
                options.placement_group_bundle_index)
        if pg is not None:
            spec.placement_group_id = pg.id
            # Rewrite the demand onto the PG's shadow resources
            # (reference: placement_group_resource_manager.cc formats
            # CPU_group_<index>_<pgid> / CPU_group_<pgid>).
            from ray_tpu_torch.scheduler.placement_group import rewrite_resources_for_pg

            spec.resources = rewrite_resources_for_pg(
                spec.resources, pg, spec.placement_group_bundle_index)
            spec._req_cache = None  # demand changed: drop memoized request

    def _track_arg_refs(self, spec: TaskSpec, add: bool) -> None:
        for a in list(spec.args) + list(spec.kwargs.values()):
            if isinstance(a, ObjectRef):
                if add:
                    self.reference_counter.add_submitted_task_ref(a.id())
                else:
                    self.reference_counter.remove_submitted_task_ref(a.id())

    def _submit_to_raylet(self, spec: TaskSpec) -> None:
        ctx = self.context()
        raylet = self.cluster_state.raylets.get(ctx.node_id,
                                                self.head_raylet)
        self._submit_with_backpressure(raylet, spec)

    def _submit_with_backpressure(self, raylet: Raylet,
                                  spec: TaskSpec) -> None:
        """Backpressure: a raylet whose submit queue is at its bound
        raises RetryLaterError — this loop slows the producer down at
        the hinted pace (instead of queuing unboundedly) and retries
        until the backlog drains or the backpressure window lapses."""
        from ray_tpu_torch._private.config import Config
        from ray_tpu_torch.exceptions import RetryLaterError

        deadline = (time.monotonic()
                    + Config.instance().submit_backpressure_timeout_s)
        while True:
            try:
                raylet.submit(spec, self._make_dispatch(spec))
                return
            except RetryLaterError as e:
                if time.monotonic() + e.retry_after_s >= deadline:
                    raise
                time.sleep(e.retry_after_s)

    # ------------------------------------------------------- task execution
    def _make_dispatch(self, spec: TaskSpec):
        def _dispatch(raylet: Raylet, worker_id: WorkerID):
            self._execute_spec(spec, raylet, worker_id)
        return _dispatch

    def _execute_spec(self, spec: TaskSpec, raylet: Raylet,
                      worker_id: WorkerID) -> None:
        """Runs on a worker thread of the chosen raylet
        (reference: CoreWorker::ExecuteTask, core_worker.cc:2069)."""
        ctx = WorkerContext(
            task_id=spec.task_id,
            actor_id=spec.actor_id,
            node_id=raylet.node_id,
            worker_id=worker_id,
            task_depth=spec.depth,
            assigned_resources=dict(spec.resources),
        )
        self._tls.ctx = ctx
        from ray_tpu_torch.util import tracing

        trace_parent = tracing.SpanContext.from_dict(spec.trace_context)
        try:
            with tracing.start_span(
                    f"task::{spec.name}.execute", parent=trace_parent,
                    attributes={"task_id": spec.task_id.hex(),
                                "node_id": raylet.node_id.hex(),
                                "worker_id": worker_id.hex()}):
                self._execute_spec_inner(spec, raylet)
            self.record_lineage(spec)
        except TaskCancelledError as e:
            self._store_error(spec, e)
        except BaseException as e:  # noqa: BLE001
            self._handle_task_error(spec, e, raylet)
        finally:
            self._track_arg_refs(spec, add=False)
            self._tls.ctx = None

    def _execute_spec_inner(self, spec: TaskSpec, raylet: Raylet) -> None:
        if spec.runtime_env is not None:
            # URI refcount for the env's lifetime (reference: runtime-env
            # agent URI reference counting)
            spec.runtime_env.acquire()
            try:
                self._execute_spec_body(spec, raylet)
            finally:
                spec.runtime_env.release()
            return
        self._execute_spec_body(spec, raylet)

    def _execute_spec_body(self, spec: TaskSpec, raylet: Raylet) -> None:
        args = self._resolve_args(spec.args)
        kwargs = {k: self._resolve_arg(v) for k, v in spec.kwargs.items()}
        if (self.process_pool is not None
                and spec.kind is TaskKind.NORMAL):
            # Refs nested inside args ship to the worker process as refs:
            # the worker is a genuine borrower for the task's lifetime
            # (reference: reference_count.cc borrower protocol; borrows
            # clear when the task finishes, like WaitForRefRemoved).
            from ray_tpu_torch.core.object_ref import borrow_context

            borrower_id = f"pworker:{spec.task_id.hex()}"
            borrowed: set = set()
            try:
                with borrow_context(borrower_id, borrowed):
                    result = self.process_pool.run(
                        spec.func, tuple(args), kwargs,
                        runtime_env=spec.runtime_env)
            finally:
                for oid in borrowed:
                    self.reference_counter.remove_borrower(
                        oid, borrower_id)
        elif (self.process_pool is not None
                and spec.kind is TaskKind.ACTOR_CREATION):
            # env is applied inside the dedicated worker process for
            # the actor's whole life; applying it parent-side too
            # would mutate the driver's environ for no benefit
            result = spec.func(*args, **kwargs)
        elif spec.runtime_env is not None:
            with spec.runtime_env.applied():
                result = spec.func(*args, **kwargs)
        else:
            result = spec.func(*args, **kwargs)
        self._store_results(spec, result)

    def _resolve_args(self, args: tuple) -> list:
        return [self._resolve_arg(a) for a in args]

    def _resolve_arg(self, arg: Any) -> Any:
        if isinstance(arg, ObjectRef):
            stored = self.object_store.peek(arg.id())
            if stored is None:
                # dependency manager guaranteed availability; a miss means
                # the object was lost after scheduling
                stored_list = self.object_store.get([arg.id()], timeout=1.0)
                stored = stored_list[0]
            if stored.is_error:
                err = stored.value
                if isinstance(err, RayTaskError):
                    raise err.as_instanceof_cause()
                raise err
            return stored.value
        return arg

    def _store_results(self, spec: TaskSpec, result: Any) -> None:
        if spec.num_returns == 0:
            return
        if spec.num_returns == 1:
            self.object_store.put(spec.return_ids[0], result)
            return
        values = list(result) if result is not None else []
        if len(values) != spec.num_returns:
            err = RayTaskError(
                spec.name,
                f"task declared num_returns={spec.num_returns} but returned "
                f"{len(values)} values", None)
            for oid in spec.return_ids:
                self.object_store.put(oid, err, is_error=True)
            return
        for oid, v in zip(spec.return_ids, values):
            self.object_store.put(oid, v)

    def _handle_task_error(self, spec: TaskSpec, exc: BaseException,
                           raylet: Raylet) -> None:
        retryable = self._is_retryable(spec, exc)
        if retryable and spec.retries_left > 0:
            spec.retries_left -= 1
            logger.info("retrying task %s (%d retries left)",
                        spec.name, spec.retries_left)
            delay = Config.instance().task_retry_delay_ms / 1000.0
            if delay:
                time.sleep(delay)
            self._submit_with_backpressure(raylet, spec)
            return
        self._store_error(
            spec,
            exc if isinstance(exc, RayTaskError) else RayTaskError.from_exception(
                spec.name, exc, pid=os.getpid(),
                node_hex=raylet.node_id.hex()))

    def _is_retryable(self, spec: TaskSpec, exc: BaseException) -> bool:
        retry_exceptions = spec.retry_exceptions
        if retry_exceptions is True:
            return True
        if isinstance(retry_exceptions, (list, tuple)):
            return isinstance(exc, tuple(retry_exceptions))
        # Default: retry only system errors (worker crash), which cannot
        # occur for thread workers; process workers raise WorkerCrashedError.
        from ray_tpu_torch.exceptions import WorkerCrashedError

        return isinstance(exc, WorkerCrashedError)

    def _store_error(self, spec: TaskSpec, err: BaseException) -> None:
        if not isinstance(err, RayTaskError) and not isinstance(
                err, (RayActorError, TaskCancelledError)):
            err = RayTaskError.from_exception(spec.name, err)
        for oid in spec.return_ids:
            self.object_store.put(oid, err, is_error=True)

    def store_task_cancelled(self, spec: TaskSpec) -> None:
        self._store_error(spec, TaskCancelledError(spec.task_id))
        self._track_arg_refs(spec, add=False)

    # ---------------------------------------------------------------- actors
    def create_actor(self, cls, cls_name: str, init_args: tuple,
                     init_kwargs: dict, options) -> "ActorRecord":
        import inspect as _inspect

        actor_id = ActorID.of(self.job_id)
        is_async = any(
            _inspect.iscoroutinefunction(m)
            for _, m in _inspect.getmembers(cls, _inspect.isfunction))
        creation = ActorCreationSpec(
            actor_id=actor_id, cls=cls, cls_descriptor=cls_name,
            init_args=init_args, init_kwargs=init_kwargs, options=options,
            is_async=is_async, max_restarts=options.max_restarts)
        record = ActorRecord(
            actor_id=actor_id,
            state=ActorState.PENDING_CREATION,
            creation_spec=creation,
            name=options.name,
            namespace=options.namespace or self.namespace,
            detached=(options.lifetime == "detached"),
            restarts_remaining=(
                -1 if options.max_restarts == -1 else options.max_restarts),
        )
        self.actor_directory.register(record)
        self._submit_actor_creation(record)
        return record

    def _submit_actor_creation(self, record: ActorRecord) -> None:
        creation: ActorCreationSpec = record.creation_spec
        options = creation.options
        ctx = self.context()
        task_id = self._next_task_id(creation.actor_id)
        spec = TaskSpec(
            kind=TaskKind.ACTOR_CREATION,
            task_id=task_id,
            job_id=self.job_id,
            parent_task_id=ctx.task_id,
            name=f"{creation.cls_descriptor}.__init__",
            func=None,
            args=creation.init_args,
            kwargs=creation.init_kwargs,
            num_returns=1,
            return_ids=(ObjectID.for_return(task_id, 1),),
            resources=options.placement_resources(),
            scheduling_strategy=options.scheduling_strategy,
            actor_id=creation.actor_id,
            max_retries=0,
            # in-process workers share one interpreter, so the env applies
            # around __init__ (the reference holds it for the process life)
            runtime_env=_normalize_runtime_env(options.runtime_env),
            submit_time=time.monotonic(),
        )
        self._apply_placement_options(spec, options, ctx)
        spec.scheduling_class = scheduling_class_of(
            spec.resource_request(self.cluster_state.ids),
            creation.cls_descriptor)
        self.reference_counter.add_owned_object(spec.return_ids[0],
                                                creating_task=task_id)
        spec.func = lambda *a, **kw: self._instantiate_actor(record, a, kw)
        self._track_arg_refs(spec, add=True)
        self._submit_to_raylet(spec)

    def _instantiate_actor(self, record: ActorRecord, args, kwargs):
        creation: ActorCreationSpec = record.creation_spec
        options = creation.options
        ctx = self.context()
        if record.state is ActorState.DEAD:
            # killed while still pending creation; don't resurrect
            # (reference: gcs_actor_manager.cc DestroyActor on pending)
            raise ActorDiedError("actor was killed before creation finished")
        try:
            if self.process_pool is not None:
                # dedicated worker process per actor (reference: every
                # actor gets its own worker; direct_actor_transport)
                instance = self.process_pool.create_actor_process(
                    creation.cls, args, kwargs,
                    runtime_env=_normalize_runtime_env(options.runtime_env))
            else:
                instance = creation.cls(*args, **kwargs)
        except BaseException:
            self.actor_directory.mark_dead(
                record.actor_id, cause="creation task failed")
            self._fail_buffered_calls(record)
            raise
        max_concurrency = options.max_concurrency or (
            1000 if creation.is_async else 1)
        record.executor = ActorExecutor(
            record.actor_id, instance, max_concurrency, creation.is_async,
            options.concurrency_groups,
            execute_out_of_order=options.execute_out_of_order)
        record.node_id = ctx.node_id
        # Downgrade from placement to lifetime resources (reference:
        # actors hold 0 CPU while alive unless explicitly requested).
        raylet = self.cluster_state.raylets.get(ctx.node_id)
        lifetime = options.lifetime_resources()
        if raylet is not None and lifetime:
            raylet.adjust_resources(lifetime, allocate=True)
        with record.lock:
            if record.state is ActorState.DEAD:  # killed mid-__init__
                executor = record.executor
                record.executor = None
            else:
                record.state = ActorState.ALIVE
                executor = None
        if executor is not None:
            executor.kill()
            if raylet is not None and lifetime:
                raylet.adjust_resources(lifetime, allocate=False)
            raise ActorDiedError("actor was killed during creation")
        self.actor_directory.flush_buffered(record.actor_id)
        return record.actor_id

    def submit_actor_task(self, record: ActorRecord, method_name: str,
                          args: tuple, kwargs: dict, num_returns: int,
                          concurrency_group: str = "") -> List[ObjectRef]:
        if record.state is ActorState.DEAD:
            oid = ObjectID.for_return(self._next_task_id(record.actor_id), 1)
            self.reference_counter.add_owned_object(oid)
            self.object_store.put(
                oid, ActorDiedError(
                    f"Actor {record.actor_id.hex()[:8]} is dead: "
                    f"{record.death_cause}"), is_error=True)
            return [ObjectRef(oid)]
        opts = record.creation_spec.options
        if opts.max_pending_calls > 0 and record.executor is not None:
            from ray_tpu_torch.exceptions import PendingCallsLimitExceeded

            if record.executor.pending_count() >= opts.max_pending_calls:
                raise PendingCallsLimitExceeded(
                    f"max_pending_calls={opts.max_pending_calls} exceeded")
        task_id = self._next_task_id(record.actor_id)
        return_ids = tuple(
            ObjectID.for_return(task_id, i + 1) for i in range(num_returns))
        for oid in return_ids:
            self.reference_counter.add_owned_object(oid, creating_task=task_id)
        names = record.creation_spec.__dict__.setdefault(
            "_method_name_cache", {})
        full_name = names.get(method_name)
        if full_name is None:
            full_name = f"{record.creation_spec.cls_descriptor}.{method_name}"
            names[method_name] = full_name
        spec = TaskSpec(
            kind=TaskKind.ACTOR_TASK,
            task_id=task_id,
            job_id=self.job_id,
            parent_task_id=self.context().task_id,
            name=full_name,
            args=args,
            kwargs=kwargs,
            num_returns=num_returns,
            return_ids=return_ids,
            actor_id=record.actor_id,
            max_retries=record.creation_spec.options.max_task_retries,
            retries_left=max(0, record.creation_spec.options.max_task_retries),
            submit_time=time.monotonic(),
        )
        self._track_arg_refs(spec, add=True)
        refs = [ObjectRef(oid) for oid in return_ids]
        from ray_tpu_torch.util import tracing

        def _submit():
            self._enqueue_actor_task(record, spec, method_name,
                                     concurrency_group)

        def _route():
            if record.state is ActorState.ALIVE and \
                    record.executor is not None:
                _submit()
            else:
                with record.lock:
                    record.buffered_calls.append(_submit)
                # race: ALIVE may have flipped while appending
                if record.state is ActorState.ALIVE:
                    self.actor_directory.flush_buffered(record.actor_id)
                elif record.state is ActorState.DEAD:
                    self._fail_buffered_calls(record)

        def _stamp(span):
            spec.trace_context = span.context().to_dict()

        with tracing.maybe_span(
                lambda: f"actor_task::{spec.name}.remote",
                attributes_fn=lambda: {
                    "task_id": task_id.hex(),
                    "actor_id": record.actor_id.hex()},
                on_span=_stamp):
            _route()
        return refs

    def _enqueue_actor_task(self, record: ActorRecord, spec: TaskSpec,
                            method_name: str, concurrency_group: str) -> None:
        executor = record.executor
        if executor is None or record.state is ActorState.DEAD:
            self._store_error(spec, ActorDiedError())
            self._track_arg_refs(spec, add=False)
            return

        def _execute():
            ctx = WorkerContext(
                task_id=spec.task_id, actor_id=record.actor_id,
                node_id=record.node_id, task_depth=spec.depth)
            self._tls.ctx = ctx
            try:
                # Args resolve on the actor's executor slot so a failed
                # dependency still consumes this sequence number (a skipped
                # seq would deadlock the strict-order queue).
                from ray_tpu_torch.util import tracing

                with tracing.maybe_span(
                        lambda: f"actor_task::{spec.name}.execute",
                        parent=tracing.SpanContext.from_dict(
                            spec.trace_context),
                        attributes_fn=lambda: {
                            "task_id": spec.task_id.hex(),
                            "actor_id": record.actor_id.hex()}):
                    args = self._resolve_args(spec.args)
                    kwargs = {k: self._resolve_arg(v)
                              for k, v in spec.kwargs.items()}
                    method = getattr(executor.instance, method_name)
                    result = method(*args, **kwargs)
                if executor.is_async and hasattr(result, "__await__"):
                    async def _await_and_store():
                        try:
                            value = await result
                            self._store_results(spec, value)
                        except BaseException as e:  # noqa: BLE001
                            self._actor_task_error(record, spec, e)
                        finally:
                            self._track_arg_refs(spec, add=False)

                    return _await_and_store()
                self._store_results(spec, result)
                self._track_arg_refs(spec, add=False)
            except BaseException as e:  # noqa: BLE001
                self._actor_task_error(record, spec, e)
                self._track_arg_refs(spec, add=False)
            finally:
                self._tls.ctx = None

        def _fail():
            # Actor died with this call still queued. Retry across the
            # restart if the task has budget (reference: max_task_retries,
            # direct_actor_task_submitter.cc resubmit on restart).
            if spec.retries_left > 0 and record.restarts_remaining != 0 \
                    and record.state is not ActorState.DEAD:
                spec.retries_left -= 1
                with record.lock:
                    record.buffered_calls.append(
                        lambda: self._enqueue_actor_task(
                            record, spec, method_name, concurrency_group))
                if record.state is ActorState.ALIVE:
                    self.actor_directory.flush_buffered(record.actor_id)
                return
            self._store_error(spec, ActorDiedError())
            self._track_arg_refs(spec, add=False)

        # Sequence numbers are assigned at enqueue time, per executor
        # incarnation, so execution follows submission order even across
        # dependency waits; buffered calls renumber after a restart (the
        # reference resets sequence state on reconnect). A call whose
        # dependency fails still consumes its number inside _execute.
        spec.sequence_number = record.next_seq()

        def _when_deps_ready():
            executor.submit(spec.sequence_number, method_name, _execute,
                            fail=_fail, concurrency_group=concurrency_group)

        self.deps.wait_ready(spec, _when_deps_ready)

    def _actor_task_error(self, record: ActorRecord, spec: TaskSpec,
                          exc: BaseException) -> None:
        from ray_tpu_torch.exceptions import AsyncioActorExit

        if isinstance(exc, (AsyncioActorExit, SystemExit)):
            # exit_actor() path
            self._store_results(spec, None)
            self.kill_actor(record, no_restart=True, graceful=True)
            return
        from ray_tpu_torch.exceptions import WorkerCrashedError

        if isinstance(exc, WorkerCrashedError):
            # The actor's worker process died under this call (reference:
            # worker disconnect → GCS ReconstructActor, in-flight calls
            # fail or retry across the restart per max_task_retries).
            self._handle_actor_worker_death(record, cause=str(exc))
            if spec.retries_left > 0 and record.state is not ActorState.DEAD:
                spec.retries_left -= 1
                method_name = spec.name.rsplit(".", 1)[-1]
                # compensate for the caller's unconditional ref release
                self._track_arg_refs(spec, add=True)
                with record.lock:
                    record.buffered_calls.append(
                        lambda: self._enqueue_actor_task(
                            record, spec, method_name, ""))
                if record.state is ActorState.ALIVE:
                    self.actor_directory.flush_buffered(record.actor_id)
                elif record.state is ActorState.DEAD:
                    self._fail_buffered_calls(record)
                return
            self._store_error(spec, ActorDiedError(
                f"actor worker process died: {exc}"))
            return
        if self._is_retryable(spec, exc) and spec.retries_left > 0:
            spec.retries_left -= 1
            method_name = spec.name.rsplit(".", 1)[-1]
            # compensate for the caller's unconditional ref release
            self._track_arg_refs(spec, add=True)
            self._enqueue_actor_task(record, spec, method_name, "")
            return
        self._store_error(spec, RayTaskError.from_exception(
            spec.name, exc, pid=os.getpid(),
            node_hex=record.node_id.hex() if record.node_id else ""))

    def _fail_buffered_calls(self, record: ActorRecord) -> None:
        with record.lock:
            calls, record.buffered_calls = record.buffered_calls, []
        # buffered closures would enqueue; instead mark dead so each call
        # stores an ActorDiedError
        for call in calls:
            call()

    def kill_actor(self, record: ActorRecord, no_restart: bool = True,
                   graceful: bool = False) -> None:
        with record.lock:
            if record.state is ActorState.DEAD:
                return
            was_alive = record.state is ActorState.ALIVE
            executor = record.executor
        raylet = (self.cluster_state.raylets.get(record.node_id)
                  if record.node_id else None)
        lifetime = record.creation_spec.options.lifetime_resources()
        if not no_restart and record.restarts_remaining != 0:
            if executor is not None:
                executor.kill()
                if raylet is not None and lifetime and was_alive:
                    raylet.adjust_resources(lifetime, allocate=False)
            self._restart_actor(record, "killed with restart budget")
            return
        self.actor_directory.mark_dead(
            record.actor_id,
            cause="ray_tpu_torch.kill" if not graceful else "actor exited")
        # the dead record stays listed (state API) but lets go of the
        # instance, as a killed worker process frees it: an actor that
        # holds tensors on the card gives that memory back at kill()
        with record.lock:
            record.executor = None
        if executor is not None:
            executor.kill()
            if raylet is not None and lifetime and was_alive:
                raylet.adjust_resources(lifetime, allocate=False)
        self._fail_buffered_calls(record)

    def _handle_actor_worker_death(self, record: ActorRecord,
                                   cause: str) -> None:
        """The actor's dedicated worker process crashed (process mode)."""
        with record.lock:
            if record.state is not ActorState.ALIVE:
                # another thread already handled this crash (concurrent
                # in-flight calls all observe WorkerCrashedError)
                return
            record.state = ActorState.RESTARTING
            executor = record.executor
            record.executor = None
        raylet = (self.cluster_state.raylets.get(record.node_id)
                  if record.node_id else None)
        lifetime = record.creation_spec.options.lifetime_resources()
        if executor is not None:
            executor.kill()
            if raylet is not None and lifetime:
                raylet.adjust_resources(lifetime, allocate=False)
        if record.restarts_remaining != 0:
            self._restart_actor(record, cause)
        else:
            self.actor_directory.mark_dead(record.actor_id, cause=cause)
            self._fail_buffered_calls(record)

    def _handle_actor_node_death(self, record: ActorRecord) -> None:
        executor = record.executor
        if executor is not None:
            executor.kill()
        if record.restarts_remaining != 0:
            self._restart_actor(record, "node died")
        else:
            self.actor_directory.mark_dead(record.actor_id, cause="node died")
            self._fail_buffered_calls(record)

    def _restart_actor(self, record: ActorRecord, cause: str) -> None:
        """ReconstructActor (reference: gcs_actor_manager.cc:945)."""
        if record.restarts_remaining > 0:
            record.restarts_remaining -= 1
        record.num_restarts += 1
        with record.lock:
            record.state = ActorState.RESTARTING
            old_executor = record.executor
            record.executor = None
            record.seq_counter = 0
        if old_executor is not None and not old_executor.dead:
            old_executor.kill()
        self._submit_actor_creation(record)

    # ------------------------------------------------- lineage reconstruction
    def record_lineage(self, spec: TaskSpec) -> None:
        """Cache a finished task's spec so its outputs can be recomputed
        if lost (reference: lineage pinning, reference_count.h). LRU,
        bounded both by entry count (``max_lineage_entries``) and by an
        estimated byte budget (``max_lineage_bytes`` — the reference's
        RAY_max_lineage_bytes cap): a few huge inline-arg specs must
        not pin gigabytes just because they are few."""
        if spec.kind is not TaskKind.NORMAL or spec.func is None:
            return
        cfg = Config.instance()
        max_entries = cfg.max_lineage_entries
        max_bytes = cfg.max_lineage_bytes
        cost = _lineage_cost(spec)
        with self._lineage_lock:
            if spec.task_id in self._lineage:
                self._lineage_bytes -= self._lineage_cost.pop(
                    spec.task_id, 0)
            self._lineage[spec.task_id] = spec
            self._lineage_cost[spec.task_id] = cost
            self._lineage_bytes += cost
            self._lineage.move_to_end(spec.task_id)
            while self._lineage and (
                    len(self._lineage) > max_entries
                    or self._lineage_bytes > max_bytes):
                evicted_id, _ = self._lineage.popitem(last=False)
                self._lineage_bytes -= self._lineage_cost.pop(
                    evicted_id, 0)

    def maybe_reconstruct(self, object_id: ObjectID, _depth: int = 0
                          ) -> bool:
        """Re-execute the creating task of a lost object, recursively
        recovering lost arguments first (reference:
        ObjectRecoveryManager::RecoverObject -> lineage re-execution).
        Returns True if a reconstruction was submitted or is in flight."""
        if _depth > 100:
            return False
        task_id = object_id.task_id()
        with self._lineage_lock:
            spec = self._lineage.get(task_id)
            if spec is None:
                return False
            if task_id in self._reconstructing:
                return True  # a concurrent get already resubmitted it
            self._reconstructing.add(task_id)
        # recover lost arguments first; the dependency manager then waits
        # for them like any other pending args
        for arg in list(spec.args) + list(spec.kwargs.values()):
            if isinstance(arg, ObjectRef) and \
                    not self.object_store.contains(arg.id()):
                self.maybe_reconstruct(arg.id(), _depth + 1)
        logger.info("reconstructing object %s via task %s",
                    object_id.hex()[:8], spec.name)

        def _clear():
            with self._lineage_lock:
                self._reconstructing.discard(task_id)

        for oid in spec.return_ids:
            self.object_store.on_available(oid, _clear)
        self._track_arg_refs(spec, add=True)
        self._submit_to_raylet(spec)
        return True

    def resubmit_lost_task(self, spec: TaskSpec) -> None:
        """A placed-but-unfinished task's node died. Actor creations
        re-place unconditionally (restart budget is actor-level); normal
        tasks consume a retry as a system failure (reference:
        TaskManager::RetryTaskIfPossible, task_manager.cc:347)."""
        from ray_tpu_torch.exceptions import WorkerCrashedError

        if self.is_shutdown:
            return
        if spec.kind is TaskKind.ACTOR_CREATION:
            self._submit_to_raylet(spec)
            return
        if spec.max_retries == -1 or spec.retries_left > 0:
            if spec.max_retries != -1:
                spec.retries_left -= 1
            logger.info("resubmitting task %s lost to node death "
                        "(%d retries left)", spec.name, spec.retries_left)
            self._submit_to_raylet(spec)
            return
        self._store_error(spec, WorkerCrashedError(
            f"task {spec.name} lost to node death and out of retries"))
        self._track_arg_refs(spec, add=False)

    # ---------------------------------------------------------------- misc
    def cancel_task(self, ref: ObjectRef) -> bool:
        task_id = ref.id().task_id()
        for raylet in self.cluster_state.raylets.values():
            if raylet.cancel(task_id):
                return True
        return False

    def kv_put(self, ns: str, key: bytes, value: bytes) -> None:
        with self._kv_lock:
            self.kv[(ns, key)] = value

    def kv_get(self, ns: str, key: bytes) -> Optional[bytes]:
        with self._kv_lock:
            return self.kv.get((ns, key))

    def kv_del(self, ns: str, key: bytes) -> None:
        with self._kv_lock:
            self.kv.pop((ns, key), None)

    def kv_keys(self, ns: str, prefix: bytes) -> List[bytes]:
        with self._kv_lock:
            return [k for (n, k) in self.kv if n == ns and k.startswith(prefix)]

    def nodes(self) -> List[dict]:
        out = []
        with self.cluster_state.lock:
            self.cluster_state.refresh_locked()
            for nid, raylet in self.cluster_state.raylets.items():
                slot = self.cluster_state.matrix.slot_of(nid)
                out.append({
                    "NodeID": nid.hex(),
                    "Alive": bool(self.cluster_state.matrix.alive[slot]),
                    "Resources": raylet.local_resources.to_map(
                        self.cluster_state.ids),
                })
        return out

    def cluster_resources(self) -> Dict[str, float]:
        totals: Dict[str, float] = {}
        for raylet in self.cluster_state.alive_raylets():
            for k, v in raylet.local_resources.to_map(
                    self.cluster_state.ids).items():
                totals[k] = totals.get(k, 0) + v
        return totals

    def available_resources(self) -> Dict[str, float]:
        totals: Dict[str, float] = {}
        for raylet in self.cluster_state.alive_raylets():
            for k, v in raylet.local_resources.to_map(
                    self.cluster_state.ids, available=True).items():
                totals[k] = totals.get(k, 0) + v
        return totals

    def shutdown(self) -> None:
        self.is_shutdown = True
        for rec in self.actor_directory.list():
            if rec.executor is not None:
                rec.executor.kill()
        for raylet in list(self.cluster_state.raylets.values()):
            raylet.shutdown()
        if self.process_pool is not None:
            self.process_pool.shutdown()
            self.process_pool = None
        if self._process_shm is not None:
            try:
                self._process_shm.close(unlink=True)
            except Exception as e:
                # stale-segment sweep reclaims it at the next boot
                logger.debug("driver shm segment close failed: %r", e)
            self._process_shm = None


def _normalize_runtime_env(runtime_env):
    from ray_tpu_torch._private.runtime_env import normalize

    return normalize(runtime_env)


def init_runtime(**kwargs) -> Runtime:
    global global_runtime
    with _init_lock:
        if global_runtime is not None and not global_runtime.is_shutdown:
            raise RuntimeError("ray_tpu_torch is already initialized")
        global_runtime = Runtime(**kwargs)
        return global_runtime


def shutdown_runtime() -> None:
    global global_runtime
    with _init_lock:
        if global_runtime is not None:
            global_runtime.shutdown()
            global_runtime = None
