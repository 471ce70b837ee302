"""ray_tpu_torch.workflow — durable workflows.

Reference: python/ray/workflow/api.py (@workflow.step:94, run/resume:196,
virtual_actor:130), step_executor.py, recovery.py. Semantics:

  - ``@workflow.step`` wraps a function; ``.step(args)`` builds a DAG node
    lazily; ``.run(workflow_id)`` executes it with every step's output
    checkpointed to storage.
  - A step whose argument is another step runs after that dependency;
    dependency outputs are substituted in.
  - A step may *return* another step (continuation); the workflow's
    result is the continuation's result.
  - ``workflow.resume(workflow_id)`` replays the DAG: finished steps are
    loaded from their checkpoints, unfinished ones re-execute.
  - Virtual actors: durable state checkpointed after every method call.
"""

from __future__ import annotations

import functools
import uuid
from typing import Any, Dict, List, Optional

import ray_tpu_torch
from ray_tpu_torch.workflow.storage import (
    FilesystemStorage,
    Storage,
    get_global_storage,
    set_global_storage,
)

_STATUS_RUNNING = "RUNNING"
_STATUS_SUCCESSFUL = "SUCCESSFUL"
_STATUS_FAILED = "FAILED"
_STATUS_CANCELED = "CANCELED"


def init(storage: Optional[str] = None) -> None:
    """Set the workflow storage root — a filesystem path or an
    ``s3://bucket/prefix`` URL (reference: workflow.init + storage/).
    With no runtime up it starts one, on CUDA: call
    ``ray_tpu_torch.init(device="cpu")`` first to run on the CPU."""
    if storage is not None:
        from ray_tpu_torch.workflow.s3_storage import storage_from_url

        set_global_storage(storage_from_url(storage))
    if not ray_tpu_torch.is_initialized():
        ray_tpu_torch.init()


class WorkflowStepNode:
    """A node in the (lazy) workflow DAG."""

    def __init__(self, func, args: tuple, kwargs: dict,
                 step_id: Optional[str] = None, max_retries: int = 0,
                 catch_exceptions: bool = False):
        self.func = func
        self.args = args
        self.kwargs = kwargs
        self.step_id = step_id or f"{func.__name__}_{uuid.uuid4().hex[:8]}"
        self.max_retries = max_retries
        self.catch_exceptions = catch_exceptions

    # ------------------------------------------------------------ execution
    def _execute(self, workflow_id: str, storage: Storage) -> Any:
        meta = storage.get(f"{workflow_id}/meta.json") or {}
        if meta.get("status") == _STATUS_CANCELED:
            # checkpoint-boundary stop: no further steps launch
            raise RuntimeError(f"workflow {workflow_id!r} was canceled")
        key_out = f"{workflow_id}/steps/{self.step_id}/output.pkl"
        if storage.exists(key_out):
            return storage.get(key_out)

        # resolve upstream dependencies first (post-order DAG walk)
        def resolve(v):
            if isinstance(v, WorkflowStepNode):
                return v._execute(workflow_id, storage)
            return v

        args = tuple(resolve(a) for a in self.args)
        kwargs = {k: resolve(v) for k, v in self.kwargs.items()}
        # dependencies may have run for a while: re-check cancellation
        # right before launching THIS step (the DAG-descent check above
        # happens within milliseconds of run start)
        meta = storage.get(f"{workflow_id}/meta.json") or {}
        if meta.get("status") == _STATUS_CANCELED:
            raise RuntimeError(f"workflow {workflow_id!r} was canceled")
        storage.put(f"{workflow_id}/steps/{self.step_id}/input.pkl",
                    (self.func, args, kwargs))

        @ray_tpu_torch.remote(max_retries=self.max_retries, retry_exceptions=True)
        def _run_step(func, a, kw):
            return func(*a, **kw)

        try:
            result = ray_tpu_torch.get([_run_step.remote(self.func, args,
                                                   kwargs)])[0]
        except Exception as e:  # noqa: BLE001
            if self.catch_exceptions:
                result = (None, e)
                storage.put(key_out, result)
                return result
            raise
        if isinstance(result, WorkflowStepNode):
            # continuation: the step returned another step
            result = result._execute(workflow_id, storage)
        if self.catch_exceptions:
            result = (result, None)
        storage.put(key_out, result)
        return result

    def run(self, workflow_id: Optional[str] = None) -> Any:
        return ray_tpu_torch.get([self.run_async(workflow_id)])[0]

    def run_async(self, workflow_id: Optional[str] = None
                  ) -> "ray_tpu_torch.ObjectRef":
        workflow_id = workflow_id or uuid.uuid4().hex
        storage = get_global_storage()
        storage.put(f"{workflow_id}/meta.json",
                    {"status": _STATUS_RUNNING})
        storage.put(f"{workflow_id}/entry.pkl", self)
        node = self

        @ray_tpu_torch.remote
        def _drive():
            def finish(status: str) -> None:
                # CANCELED is terminal and must win every race: the
                # check-and-write is one atomic update (a cancel landing
                # between a separate get and put would be overwritten
                # and the workflow would resume as if never canceled)
                def fn(meta):
                    meta = dict(meta or {})
                    if meta.get("status") != _STATUS_CANCELED:
                        meta["status"] = status
                    return meta

                storage.update(f"{workflow_id}/meta.json", fn)

            try:
                result = node._execute(workflow_id, storage)
            except Exception:
                finish(_STATUS_FAILED)
                raise
            storage.put(f"{workflow_id}/result.pkl", result)
            finish(_STATUS_SUCCESSFUL)
            return result

        return _drive.remote()


class WorkflowStep:
    """The ``@workflow.step`` wrapper; ``.step(...)`` builds DAG nodes."""

    def __init__(self, func, max_retries: int = 0,
                 catch_exceptions: bool = False):
        self.func = func
        self.max_retries = max_retries
        self.catch_exceptions = catch_exceptions
        functools.update_wrapper(self, func)

    def step(self, *args, **kwargs) -> WorkflowStepNode:
        return WorkflowStepNode(self.func, args, kwargs,
                                max_retries=self.max_retries,
                                catch_exceptions=self.catch_exceptions)

    def options(self, *, max_retries: Optional[int] = None,
                catch_exceptions: Optional[bool] = None) -> "WorkflowStep":
        return WorkflowStep(
            self.func,
            self.max_retries if max_retries is None else max_retries,
            self.catch_exceptions if catch_exceptions is None
            else catch_exceptions)

    def __call__(self, *args, **kwargs):
        raise TypeError("workflow steps cannot be called directly; "
                        "use .step(...)")


def step(_func=None, *, max_retries: int = 0, catch_exceptions: bool = False):
    def wrap(func):
        return WorkflowStep(func, max_retries, catch_exceptions)

    if _func is not None:
        return wrap(_func)
    return wrap


# ---------------------------------------------------------------- recovery
def resume(workflow_id: str) -> Any:
    """Re-run a workflow; finished steps short-circuit to their
    checkpoints (reference: workflow/recovery.py resume)."""
    storage = get_global_storage()
    entry: Optional[WorkflowStepNode] = storage.get(
        f"{workflow_id}/entry.pkl")
    if entry is None:
        raise ValueError(f"no workflow with id {workflow_id!r}")
    meta = storage.get(f"{workflow_id}/meta.json") or {}
    if meta.get("status") == _STATUS_SUCCESSFUL:
        return storage.get(f"{workflow_id}/result.pkl")
    if meta.get("status") == _STATUS_CANCELED:
        raise ValueError(f"workflow {workflow_id!r} was canceled")
    return entry.run(workflow_id)


def get_status(workflow_id: str) -> Optional[str]:
    meta = get_global_storage().get(f"{workflow_id}/meta.json")
    return None if meta is None else meta.get("status")


def get_output(workflow_id: str) -> Any:
    storage = get_global_storage()
    meta = storage.get(f"{workflow_id}/meta.json") or {}
    if meta.get("status") != _STATUS_SUCCESSFUL:
        raise ValueError(f"workflow {workflow_id!r} has not finished "
                         f"(status={meta.get('status')})")
    return storage.get(f"{workflow_id}/result.pkl")


def list_all() -> List[str]:
    return get_global_storage().list_prefix("")


def delete(workflow_id: str) -> None:
    get_global_storage().delete_prefix(workflow_id)


# ------------------------------------------------------------ virtual actor
class VirtualActorClass:
    def __init__(self, cls):
        self._cls = cls

    def get_or_create(self, actor_id: str) -> "VirtualActorHandle":
        return VirtualActorHandle(self._cls, actor_id)


class VirtualActorHandle:
    """Durable actor: state is loaded from storage before each call and
    checkpointed after (reference: workflow virtual actors — state lives
    in storage, compute is stateless)."""

    def __init__(self, cls, actor_id: str):
        self._cls = cls
        self._actor_id = actor_id
        storage = get_global_storage()
        key = f"virtual_actors/{actor_id}/state.pkl"
        if not storage.exists(key):
            instance = cls.__new__(cls)
            instance.__init__()
            storage.put(key, instance.__getstate__()
                        if hasattr(instance, "__getstate__")
                        else instance.__dict__)
            # recorded so get_actor(actor_id) works without the class
            storage.put(f"virtual_actors/{actor_id}/class.pkl", cls)

    def __getattr__(self, method_name: str):
        if method_name.startswith("_"):
            raise AttributeError(method_name)
        cls, actor_id = self._cls, self._actor_id

        class _Caller:
            def run(self, *args, **kwargs):
                storage = get_global_storage()
                key = f"virtual_actors/{actor_id}/state.pkl"

                @ray_tpu_torch.remote
                def _call(state, a, kw):
                    instance = cls.__new__(cls)
                    instance.__dict__.update(state)
                    result = getattr(instance, method_name)(*a, **kw)
                    return result, dict(instance.__dict__)

                result, new_state = ray_tpu_torch.get(
                    [_call.remote(storage.get(key), args, kwargs)])[0]
                storage.put(key, new_state)
                return result

        return _Caller()


def virtual_actor(cls) -> VirtualActorClass:
    return VirtualActorClass(cls)


def get_actor(actor_id: str, cls=None) -> VirtualActorHandle:
    """Handle to an existing virtual actor by id (reference:
    workflow.get_actor). The class is recorded at creation so plain
    lookups don't need it."""
    storage = get_global_storage()
    if not storage.exists(f"virtual_actors/{actor_id}/state.pkl"):
        # lookups never create: a typo'd id must not mint a fresh actor
        raise KeyError(f"no virtual actor {actor_id!r}")
    if cls is None:
        cls = storage.get(f"virtual_actors/{actor_id}/class.pkl")
        if cls is None:
            raise KeyError(f"no virtual actor {actor_id!r}")
    return VirtualActorHandle(cls, actor_id)


def run(node: WorkflowStepNode, workflow_id: Optional[str] = None) -> Any:
    """Module-level alias of node.run (reference: workflow.run)."""
    return node.run(workflow_id)



def cancel(workflow_id: str) -> None:
    """Mark a workflow CANCELED: get_output refuses and resume will not
    restart it (reference: workflow.cancel — steps already running are
    not preempted, matching the reference's checkpoint-boundary
    semantics)."""
    storage = get_global_storage()
    if storage.get(f"{workflow_id}/meta.json") is None:
        raise ValueError(f"no workflow with id {workflow_id!r}")

    def fn(meta):
        meta = dict(meta or {})
        meta["status"] = _STATUS_CANCELED
        return meta

    storage.update(f"{workflow_id}/meta.json", fn)


class EventListener:
    """Poll-based event source (reference: workflow/event_listener.py —
    the async listener's poll_for_event, sync here). Subclass and
    implement poll_for_event(*args) to return the event payload or None
    while the event has not happened."""

    def poll_for_event(self, *args) -> Any:
        raise NotImplementedError


def wait_for_event(listener_cls, *args, poll_interval_s: float = 0.1,
                   timeout_s: Optional[float] = None) -> WorkflowStepNode:
    """A step that completes when the listener observes its event —
    composable with other steps (reference: workflow.wait_for_event)."""
    import time as _time

    @step
    def _wait(listener_args):
        listener = listener_cls()
        deadline = (None if timeout_s is None
                    else _time.monotonic() + timeout_s)
        while True:
            payload = listener.poll_for_event(*listener_args)
            if payload is not None:
                return payload
            if deadline is not None and _time.monotonic() > deadline:
                raise TimeoutError(
                    f"event from {listener_cls.__name__} not observed "
                    f"within {timeout_s}s")
            _time.sleep(poll_interval_s)

    return _wait.step(args)


def sleep(duration_s: float) -> WorkflowStepNode:
    """A durable pause step (reference: workflow.sleep)."""
    import time as _time

    @step
    def _sleep(d):
        _time.sleep(d)
        return None

    return _sleep.step(duration_s)
