"""Task and actor specifications + submission options.

Mirrors the reference's TaskSpecification (src/ray/common/task/task_spec.h)
including the SchedulingClass dedup (identical resource shapes share a
class id, used for fair dispatch and worker-lease reuse) and the
remote-decorator option surface (python/ray/remote_function.py,
python/ray/actor.py).
"""

from __future__ import annotations

import threading
from dataclasses import dataclass, field
from enum import Enum
from typing import Any, Callable, Dict, Optional, Tuple

from ray_tpu_torch._private.ids import ActorID, JobID, ObjectID, PlacementGroupID, TaskID
from ray_tpu_torch.scheduler.resources import ResourceRequest, StringIdMap

DEFAULT_MAX_RETRIES = 3


class TaskKind(Enum):
    NORMAL = 0
    ACTOR_CREATION = 1
    ACTOR_TASK = 2


class SchedulingStrategy:
    """Base for explicit strategies (util/scheduling_strategies.py)."""


@dataclass
class NodeAffinitySchedulingStrategy(SchedulingStrategy):
    node_id: Any  # NodeID or hex string
    soft: bool = False


@dataclass
class PlacementGroupSchedulingStrategy(SchedulingStrategy):
    placement_group: Any
    placement_group_bundle_index: int = -1
    placement_group_capture_child_tasks: bool = False


_scheduling_class_lock = threading.Lock()
_scheduling_class_ids: Dict[Tuple, int] = {}


def scheduling_class_of(req: ResourceRequest, fn_key: str = "") -> int:
    """Intern (resource shape, fn) -> dense class id
    (reference: task_spec.cc GetSchedulingClass)."""
    key = (req.key(), fn_key)
    with _scheduling_class_lock:
        cid = _scheduling_class_ids.get(key)
        if cid is None:
            cid = len(_scheduling_class_ids)
            _scheduling_class_ids[key] = cid
        return cid


class TaskTemplate:
    """Frozen per-``@remote`` submit state — the dispatch fast lane's
    preserialized task-spec template.

    Everything a plain task's submits share — the resolved resource
    map, retry policy, scheduling strategy, and (per id-map) the shared
    :class:`ResourceRequest` + interned SchedulingClass — is computed
    ONCE at decoration time, so the per-call hot loop only re-encodes
    args and mints IDs (reference: the direct task submitter's cached
    TaskSpecBuilder prototype; this extends the ``TaskSpec._req_cache``
    memo to the whole frozen form). Templates exist only for options
    where :meth:`eligible` holds: placement groups rewrite the demand
    per submit and runtime envs carry per-submit state, so those take
    the general path. ``RemoteFunction.options()`` builds a NEW
    RemoteFunction, hence a new template — stale-option reuse cannot
    happen."""

    __slots__ = ("func_name", "name", "resources", "num_returns",
                 "max_retries", "retries_left", "retry_exceptions",
                 "scheduling_strategy", "_ids", "_req",
                 "_scheduling_class")

    def __init__(self, func_name: str, options: "TaskOptions"):
        self.func_name = func_name
        self.name = options.name or func_name
        self.resources = options.resolved_resources()
        self.num_returns = options.num_returns
        self.max_retries = options.max_retries
        self.retries_left = max(0, options.max_retries)
        self.retry_exceptions = options.retry_exceptions
        strategy = options.scheduling_strategy
        self.scheduling_strategy = (None if strategy in (None, "DEFAULT")
                                    else strategy)
        self._ids: Any = None
        self._req: Any = None
        self._scheduling_class = 0

    @staticmethod
    def eligible(options: "TaskOptions") -> bool:
        return (options.placement_group is None
                and not isinstance(options.scheduling_strategy,
                                   PlacementGroupSchedulingStrategy)
                and options.runtime_env is None)

    def demand(self, ids: StringIdMap) -> Tuple[ResourceRequest, int]:
        """The template's (shared request, scheduling class) under
        ``ids``, memoized per id-map — a fresh runtime brings a fresh
        StringIdMap and recomputes once. Unsynchronized on purpose:
        racing recomputes write identical values, and ``_ids`` is
        assigned LAST so a reader that observes the new map also
        observes the request interned against it."""
        if self._ids is not ids:
            req = ResourceRequest.from_map(self.resources, ids)
            self._req = req
            self._scheduling_class = scheduling_class_of(
                req, self.func_name)
            self._ids = ids
        return self._req, self._scheduling_class


@dataclass
class TaskOptions:
    num_returns: int = 1
    num_cpus: Optional[float] = None
    num_gpus: Optional[float] = None
    num_tpus: Optional[float] = None
    memory: Optional[float] = None
    object_store_memory: Optional[float] = None
    resources: Dict[str, float] = field(default_factory=dict)
    accelerator_type: Optional[str] = None
    max_retries: int = DEFAULT_MAX_RETRIES
    retry_exceptions: Any = False  # bool or list of exception types
    max_calls: int = 0
    name: str = ""
    scheduling_strategy: Any = None  # None|"DEFAULT"|"SPREAD"|strategy obj
    placement_group: Any = None
    placement_group_bundle_index: int = -1
    placement_group_capture_child_tasks: Optional[bool] = None
    runtime_env: Optional[dict] = None
    _metadata: Dict[str, Any] = field(default_factory=dict)

    def resolved_resources(self) -> Dict[str, float]:
        res = dict(self.resources)
        res["CPU"] = self.num_cpus if self.num_cpus is not None else 1.0
        if self.num_gpus:
            res["GPU"] = self.num_gpus
        if self.num_tpus:
            res["TPU"] = self.num_tpus
        if self.memory:
            res["memory"] = self.memory
        if self.object_store_memory:
            res["object_store_memory"] = self.object_store_memory
        return {k: v for k, v in res.items() if v}


@dataclass
class ActorOptions:
    num_cpus: Optional[float] = None
    num_gpus: Optional[float] = None
    num_tpus: Optional[float] = None
    memory: Optional[float] = None
    resources: Dict[str, float] = field(default_factory=dict)
    max_restarts: int = 0
    max_task_retries: int = 0
    max_concurrency: Optional[int] = None
    max_pending_calls: int = -1
    name: Optional[str] = None
    namespace: Optional[str] = None
    lifetime: Optional[str] = None  # None | "detached"
    get_if_exists: bool = False
    scheduling_strategy: Any = None
    placement_group: Any = None
    placement_group_bundle_index: int = -1
    placement_group_capture_child_tasks: Optional[bool] = None
    runtime_env: Optional[dict] = None
    concurrency_groups: Dict[str, int] = field(default_factory=dict)
    # reference: out_of_order_actor_scheduling_queue.cc — calls execute
    # as they arrive instead of waiting for missing sequence numbers
    execute_out_of_order: bool = False

    def placement_resources(self) -> Dict[str, float]:
        """Resources required to *create* the actor. Like the reference,
        an actor with no explicit resources needs 1 CPU to be placed but
        holds 0 while alive (actor.py _process_option_dict)."""
        res = dict(self.resources)
        res["CPU"] = self.num_cpus if self.num_cpus is not None else 1.0
        if self.num_gpus:
            res["GPU"] = self.num_gpus
        if self.num_tpus:
            res["TPU"] = self.num_tpus
        if self.memory:
            res["memory"] = self.memory
        return {k: v for k, v in res.items() if v}

    def lifetime_resources(self) -> Dict[str, float]:
        res = dict(self.resources)
        if self.num_cpus:
            res["CPU"] = self.num_cpus
        if self.num_gpus:
            res["GPU"] = self.num_gpus
        if self.num_tpus:
            res["TPU"] = self.num_tpus
        if self.memory:
            res["memory"] = self.memory
        return {k: v for k, v in res.items() if v}


@dataclass
class TaskSpec:
    kind: TaskKind
    task_id: TaskID
    job_id: JobID
    parent_task_id: TaskID
    name: str
    func: Optional[Callable] = None       # resolved callable (local mode)
    func_descriptor: str = ""             # module.qualname for remote exec
    args: Tuple = ()
    kwargs: Dict[str, Any] = field(default_factory=dict)
    num_returns: int = 1
    return_ids: Tuple[ObjectID, ...] = ()
    resources: Dict[str, float] = field(default_factory=dict)
    scheduling_class: int = 0
    scheduling_strategy: Any = None
    max_retries: int = 0
    retries_left: int = 0
    retry_exceptions: Any = False
    depth: int = 0
    owner_hex: str = ""
    # actor fields
    actor_id: Optional[ActorID] = None
    actor_creation: Optional["ActorCreationSpec"] = None
    sequence_number: int = -1
    # placement group
    placement_group_id: Optional[PlacementGroupID] = None
    placement_group_bundle_index: int = -1
    capture_child_tasks: bool = False
    # runtime environment (env_vars/working_dir/... applied around exec)
    runtime_env: Any = None
    # profiling
    submit_time: float = 0.0
    # tracing: submission-span context, so the execution span parents to
    # it across the worker boundary (reference: tracing_helper.py injects
    # the OpenTelemetry context into the task spec)
    trace_context: Optional[Dict[str, str]] = None

    # memoized dense demand: resource_request is called on the submit,
    # schedule, dispatch and free paths — build it once per spec
    _req_cache: Any = field(default=None, repr=False, compare=False)

    def resource_request(self, ids: StringIdMap) -> ResourceRequest:
        req = self._req_cache
        if req is None:
            req = ResourceRequest.from_map(self.resources, ids)
            self._req_cache = req
        return req

    def is_actor_task(self) -> bool:
        return self.kind is TaskKind.ACTOR_TASK

    def is_actor_creation(self) -> bool:
        return self.kind is TaskKind.ACTOR_CREATION


@dataclass
class ActorCreationSpec:
    actor_id: ActorID
    cls: Any
    cls_descriptor: str
    init_args: Tuple
    init_kwargs: Dict[str, Any]
    options: ActorOptions
    is_async: bool = False
    max_restarts: int = 0
    restarts_used: int = 0
