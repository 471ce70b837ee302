"""Public API: init/remote/get/put/wait and the decorator plumbing.

Mirrors the reference's python surface (python/ray/worker.py:636,1778,
1872,1925,2272; remote_function.py; actor.py): ``@remote`` wraps functions
into RemoteFunction and classes into ActorClass; ``.options(...)``
produces a one-shot override; actor handles expose ``.method.remote()``.
"""

from __future__ import annotations

import functools
import inspect
import logging
from dataclasses import replace as dc_replace
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

from ray_tpu_torch._private.config import Config
from ray_tpu_torch._private.device import auto_init_device, resolve_device
from ray_tpu_torch.core import runtime as rt_mod
from ray_tpu_torch.core.object_ref import ObjectRef
from ray_tpu_torch.core.task_spec import ActorOptions, TaskOptions, TaskTemplate
from ray_tpu_torch.exceptions import RayTpuError

logger = logging.getLogger(__name__)

__all__ = [
    "init", "shutdown", "is_initialized", "remote", "get", "put", "wait",
    "kill", "cancel", "get_actor", "method", "nodes", "cluster_resources",
    "available_resources", "get_runtime_context", "ObjectRef",
]


# --------------------------------------------------------------------- init
def init(
    address: Optional[str] = None,
    *,
    num_cpus: Optional[float] = None,
    num_gpus: Optional[float] = None,
    resources: Optional[Dict[str, float]] = None,
    object_store_memory: Optional[int] = None,
    namespace: Optional[str] = None,
    ignore_reinit_error: bool = False,
    _system_config: Optional[dict] = None,
    device=None,
    **kwargs,
):
    """Start (or connect to) the runtime. With no address, brings up an
    in-process cluster (reference: ray.init starting a local node);
    ``device`` is where the scheduling plane's placement solve runs:
    ``None`` means CUDA, and a missing CUDA raises — pass
    ``device="cpu"`` to run on the CPU. ``address="ray://host:port"``
    enters CLIENT MODE against a running client server (reference: ray
    client, ray.init("ray://...")): the module-level verbs
    (remote/get/put/wait/kill) proxy over the wire until shutdown(), and
    no local runtime starts (the server's runtime holds the device)."""
    global _client_ctx
    if address is not None and str(address).startswith("ray://"):
        if _client_ctx is not None and _client_ctx.connected:
            if ignore_reinit_error:
                return _client_ctx
            raise RuntimeError(
                "ray_tpu_torch.init() called twice; pass "
                "ignore_reinit_error=True")
        if (rt_mod.global_runtime is not None
                and not rt_mod.global_runtime.is_shutdown):
            raise RuntimeError(
                "cannot enter ray:// client mode while a local runtime "
                "is active; call ray_tpu_torch.shutdown() first")
        from ray_tpu_torch.util.client.client import connect

        _client_ctx = connect(address)
        return _client_ctx
    if _client_ctx is not None and _client_ctx.connected:
        # Mirror of the client-mode guard above: a local init while a
        # ray:// connection is open would make _client() silently prefer
        # the local runtime, shadowing the still-open client connection.
        if ignore_reinit_error:
            return _client_ctx
        raise RuntimeError(
            "cannot start a local runtime while a ray:// client "
            "connection is active; call ray_tpu_torch.shutdown() first")
    device = resolve_device(device)
    if rt_mod.global_runtime is not None and not rt_mod.global_runtime.is_shutdown:
        if ignore_reinit_error:
            logger.info("ray_tpu_torch is already initialized; ignoring re-init")
            return rt_mod.global_runtime
        raise RuntimeError(
            "ray_tpu_torch.init() called twice; pass ignore_reinit_error=True")
    if _system_config:
        Config.instance().apply_system_config(_system_config)
    tracing_hook = kwargs.pop("_tracing_startup_hook", None)
    if tracing_hook is not None:
        # reference: worker.py:666 — a callable (or "module:attr" import
        # string) that configures the tracer before any spans start
        if isinstance(tracing_hook, str):
            import importlib

            mod_name, _, attr = tracing_hook.partition(":")
            tracing_hook = getattr(importlib.import_module(mod_name), attr)
        tracing_hook()
    return rt_mod.init_runtime(
        num_cpus=num_cpus,
        num_gpus=num_gpus,
        resources=resources,
        object_store_memory=object_store_memory,
        namespace=namespace,
        worker_mode=kwargs.pop("worker_mode", "thread"),
        num_process_workers=kwargs.pop("num_process_workers", None),
        device=device,
    )


_client_ctx = None  # set by init(address="ray://...")


def _client():
    if _client_ctx is None or not _client_ctx.connected:
        return None
    # A live LOCAL runtime wins: this process IS (part of) the cluster —
    # e.g. the client server itself, or a worker executing tasks — and
    # its own api calls must never bounce back over the wire.
    rt = rt_mod.global_runtime
    if rt is not None and not rt.is_shutdown:
        return None
    return _client_ctx


def shutdown() -> None:
    global _client_ctx
    if _client_ctx is not None:
        _client_ctx.disconnect()
        _client_ctx = None
        return
    rt_mod.shutdown_runtime()
    Config.reset()


def is_initialized() -> bool:
    if _client() is not None:
        return True
    return (rt_mod.global_runtime is not None
            and not rt_mod.global_runtime.is_shutdown)


def _runtime():
    rt = rt_mod.global_runtime
    if rt is None or rt.is_shutdown:
        if _client() is not None:
            # loud failure beats silently auto-initing a second,
            # unrelated local runtime (on the card) underneath a
            # connected client
            raise RuntimeError(
                "this API is not proxied in ray:// client mode; use the "
                "core verbs (remote/get/put/wait/kill) or run against a "
                "local runtime")
        # auto-init like the reference does on first remote call
        return init(device=auto_init_device())
    return rt


# ------------------------------------------------------- remote functions
class RemoteFunction:
    def __init__(self, func, options: TaskOptions):
        self._func = func
        self._options = options
        self._name = getattr(func, "__qualname__", str(func))
        self._module = getattr(func, "__module__", "")
        self._descriptor = f"{self._module}.{self._name}"
        # dispatch fast lane: freeze the per-submit constants at
        # decoration time (options()/client mode rebuild/skip it)
        self._template = (
            TaskTemplate(self._descriptor, options)
            if TaskTemplate.eligible(options) else None)
        functools.update_wrapper(self, func)

    def remote(self, *args, **kwargs) -> Union[ObjectRef, List[ObjectRef]]:
        ctx = _client()
        if ctx is not None:
            # client mode binds at CALL time: decoration commonly
            # happens at import, before init("ray://...") connects
            return ctx.remote(
                self._func,
                **_nondefault_options(self._options, TaskOptions())
            ).remote(*args, **kwargs)
        return self._remote(args, kwargs, self._options)

    def options(self, **overrides) -> "RemoteFunction":
        opts = dc_replace(self._options, **{
            k: v for k, v in overrides.items()
            if hasattr(self._options, k)})
        unknown = [k for k in overrides if not hasattr(self._options, k)]
        if unknown:
            raise ValueError(f"unknown option(s): {unknown}")
        return RemoteFunction(self._func, opts)

    def _remote(self, args, kwargs, opts: TaskOptions):
        rt = _runtime()
        refs = rt.submit_task(
            self._func, self._descriptor, args, kwargs, opts,
            template=self._template)
        if opts.num_returns == 1:
            return refs[0]
        if opts.num_returns == 0:
            return None
        return refs

    def __call__(self, *args, **kwargs):
        raise TypeError(
            f"Remote function cannot be called directly; use "
            f"{self._name}.remote()")


# ----------------------------------------------------------------- actors
class ActorMethod:
    def __init__(self, handle: "ActorHandle", method_name: str,
                 num_returns: int = 1, concurrency_group: str = ""):
        self._handle = handle
        self._method_name = method_name
        self._num_returns = num_returns
        self._concurrency_group = concurrency_group

    def remote(self, *args, **kwargs):
        return self._handle._submit(
            self._method_name, args, kwargs, self._num_returns,
            self._concurrency_group)

    def options(self, num_returns: Optional[int] = None,
                concurrency_group: str = "", **_ignored) -> "ActorMethod":
        return ActorMethod(
            self._handle, self._method_name,
            num_returns if num_returns is not None else self._num_returns,
            concurrency_group or self._concurrency_group)

    def __call__(self, *args, **kwargs):
        raise TypeError(
            f"Actor method cannot be called directly; use "
            f".{self._method_name}.remote()")


class ActorHandle:
    def __init__(self, record):
        object.__setattr__(self, "_record", record)

    @property
    def _actor_id(self):
        return self._record.actor_id

    def __getattr__(self, name: str):
        if name.startswith("__") and name.endswith("__"):
            raise AttributeError(name)
        cls = self._record.creation_spec.cls
        attr = getattr(cls, name, None)
        if attr is None or not callable(attr):
            raise AttributeError(
                f"actor {cls.__name__} has no method {name!r}")
        meta = getattr(attr, "__ray_tpu_method_options__", {})
        method = ActorMethod(
            self, name,
            num_returns=meta.get("num_returns", 1),
            concurrency_group=meta.get("concurrency_group", ""))
        # cache: repeated a.method lookups skip this __getattr__ entirely
        object.__setattr__(self, name, method)
        return method

    def _submit(self, method_name, args, kwargs, num_returns,
                concurrency_group=""):
        rt = _runtime()
        refs = rt.submit_actor_task(
            self._record, method_name, args, kwargs, num_returns,
            concurrency_group)
        if num_returns == 1:
            return refs[0]
        if num_returns == 0:
            return None
        return refs

    def __repr__(self):
        return (f"ActorHandle({self._record.creation_spec.cls_descriptor}, "
                f"{self._actor_id.hex()[:12]})")

    def __reduce__(self):
        # handles are shareable: identity is the actor id, resolved against
        # the directory on deserialization
        return (_rehydrate_handle, (self._actor_id,))


def _rehydrate_handle(actor_id):
    rt = _runtime()
    record = rt.actor_directory.get(actor_id)
    if record is None:
        raise RayTpuError(f"unknown actor {actor_id.hex()}")
    return ActorHandle(record)


class ActorClass:
    def __init__(self, cls, options: ActorOptions):
        self._cls = cls
        self._options = options
        self._name = getattr(cls, "__qualname__", str(cls))
        self._module = getattr(cls, "__module__", "")

    def remote(self, *args, **kwargs) -> ActorHandle:
        ctx = _client()
        if ctx is not None:  # call-time client binding, like tasks
            return ctx.remote(
                self._cls,
                **_nondefault_options(self._options, ActorOptions())
            ).remote(*args, **kwargs)
        rt = _runtime()
        opts = self._options
        if opts.name and opts.get_if_exists:
            # Atomic get-or-create: lookup, and when the create races
            # with a concurrent creator of the same name (the directory
            # rejects the second register before any side effect), fall
            # back to the winner's actor. Reference: ray actor.py
            # _remote get_if_exists catches the creation conflict the
            # same way; two train workers bootstrapping one collective
            # coordinator hit this every few runs on a single core.
            from ray_tpu_torch.core.actor_runtime import ActorState

            last_err = None
            for _ in range(16):  # bounded: a non-race error must surface
                existing = rt.actor_directory.get_by_name(
                    opts.name, opts.namespace or rt.namespace)
                if existing is not None and \
                        existing.state is not ActorState.DEAD:
                    return ActorHandle(existing)
                try:
                    record = rt.create_actor(
                        self._cls, f"{self._module}.{self._name}", args,
                        kwargs, opts)
                    return ActorHandle(record)
                except ValueError as e:
                    if "already taken" not in str(e):
                        raise
                    last_err = e  # lost the race; fetch the winner
            raise last_err
        record = rt.create_actor(
            self._cls, f"{self._module}.{self._name}", args, kwargs, opts)
        return ActorHandle(record)

    def options(self, **overrides) -> "ActorClass":
        opts = dc_replace(self._options, **{
            k: v for k, v in overrides.items() if hasattr(self._options, k)})
        unknown = [k for k in overrides if not hasattr(self._options, k)]
        if unknown:
            raise ValueError(f"unknown option(s): {unknown}")
        return ActorClass(self._cls, opts)

    def __call__(self, *args, **kwargs):
        raise TypeError(
            f"Actor class cannot be instantiated directly; use "
            f"{self._name}.remote()")


def _nondefault_options(opts, defaults) -> Dict[str, Any]:
    """TaskOptions/ActorOptions -> the kwargs the user actually set
    (for re-decorating on the far side of a client connection)."""
    out = {}
    for field in opts.__dataclass_fields__:
        value = getattr(opts, field)
        if value != getattr(defaults, field):
            out[field] = value
    return out


# ------------------------------------------------------------- decorators
def remote(*args, **kwargs):
    """``@remote`` / ``@remote(num_cpus=..., ...)`` for functions and
    classes (reference: worker.py:2272 ray.remote). Binding to client
    mode happens at CALL time inside RemoteFunction/ActorClass, so
    import-time decoration works regardless of when init("ray://...")
    connects."""

    def _make(target):
        if inspect.isclass(target):
            field_names = ActorOptions.__dataclass_fields__.keys()
            opts = ActorOptions(**{
                k: v for k, v in kwargs.items() if k in field_names})
            _check_unknown(kwargs, field_names, target)
            return ActorClass(target, opts)
        field_names = TaskOptions.__dataclass_fields__.keys()
        opts = TaskOptions(**{
            k: v for k, v in kwargs.items() if k in field_names})
        _check_unknown(kwargs, field_names, target)
        return RemoteFunction(target, opts)

    if len(args) == 1 and not kwargs and callable(args[0]):
        # any callable qualifies: plain/builtin functions, classes,
        # functools.partial (reference wraps builtins the same way)
        return _make(args[0])
    if args:
        raise TypeError("@remote takes keyword arguments only")
    return _make


def _check_unknown(kwargs, field_names, target):
    unknown = [k for k in kwargs if k not in field_names]
    if unknown:
        raise ValueError(
            f"unknown @remote option(s) {unknown} for {target}")


def method(**kwargs):
    """``@method(num_returns=2)`` on actor methods
    (reference: actor.py ray.method)."""

    def _wrap(fn):
        fn.__ray_tpu_method_options__ = kwargs
        return fn

    return _wrap


# ------------------------------------------------------------ data plane
def put(value: Any) -> ObjectRef:
    ctx = _client()
    if ctx is not None:
        return ctx.put(value)
    if isinstance(value, ObjectRef):
        raise TypeError("Calling put() on an ObjectRef is not allowed")
    return _runtime().put(value)


def get(refs, timeout: Optional[float] = None, _skip_wait: bool = False):
    ctx = _client()
    if ctx is not None:
        return ctx.get(refs, timeout=timeout)
    rt = _runtime()
    if isinstance(refs, ObjectRef):
        return rt.get([refs], timeout)[0]
    if isinstance(refs, (list, tuple)):
        bad = [r for r in refs if not isinstance(r, ObjectRef)]
        if bad:
            raise TypeError(
                f"get() expects ObjectRefs, got {type(bad[0]).__name__}")
        return rt.get(list(refs), timeout)
    raise TypeError(f"get() expects an ObjectRef or list, got {type(refs)}")


def wait(refs: Sequence[ObjectRef], *, num_returns: int = 1,
         timeout: Optional[float] = None, fetch_local: bool = True
         ) -> Tuple[List[ObjectRef], List[ObjectRef]]:
    ctx = _client()
    if ctx is not None:
        return ctx.wait(list(refs), num_returns=num_returns,
                        timeout=timeout)
    if isinstance(refs, ObjectRef):
        raise TypeError("wait() expects a list of ObjectRefs")
    refs = list(refs)
    if len(set(refs)) != len(refs):
        raise ValueError("wait() expects a list of unique ObjectRefs")
    if num_returns <= 0 or num_returns > len(refs):
        raise ValueError(
            f"num_returns ({num_returns}) must be in [1, {len(refs)}]")
    return _runtime().wait(refs, num_returns, timeout)


def kill(actor: ActorHandle, *, no_restart: bool = True) -> None:
    ctx = _client()
    if ctx is not None:
        ctx.kill(actor, no_restart=no_restart)
        return
    if not isinstance(actor, ActorHandle):
        raise TypeError("kill() expects an actor handle; for tasks use cancel()")
    _runtime().kill_actor(actor._record, no_restart=no_restart)


def cancel(ref: ObjectRef, *, force: bool = False, recursive: bool = True
           ) -> None:
    _runtime().cancel_task(ref)


def get_actor(name: str, namespace: Optional[str] = None) -> ActorHandle:
    rt = _runtime()
    from ray_tpu_torch.core.actor_runtime import ActorState

    record = rt.actor_directory.get_by_name(name, namespace or rt.namespace)
    if record is None or record.state is ActorState.DEAD:
        raise ValueError(f"Failed to look up actor with name {name!r}")
    return ActorHandle(record)


# ---------------------------------------------------------- introspection
def nodes() -> List[dict]:
    return _runtime().nodes()


def cluster_resources() -> Dict[str, float]:
    return _runtime().cluster_resources()


def available_resources() -> Dict[str, float]:
    return _runtime().available_resources()


class RuntimeContext:
    def __init__(self, rt):
        self._rt = rt

    @property
    def job_id(self):
        return self._rt.job_id

    @property
    def namespace(self):
        return self._rt.namespace

    def get_task_id(self):
        return self._rt.context().task_id

    def get_actor_id(self):
        aid = self._rt.context().actor_id
        return aid.hex() if aid else None

    def get_node_id(self):
        nid = self._rt.context().node_id
        return nid.hex() if nid else None

    def get_worker_id(self):
        wid = self._rt.context().worker_id
        return wid.hex() if wid else None

    def get_assigned_resources(self):
        return dict(self._rt.context().assigned_resources)

    @property
    def was_current_actor_reconstructed(self):
        aid = self._rt.context().actor_id
        if aid is None:
            return False
        rec = self._rt.actor_directory.get(aid)
        return bool(rec and rec.num_restarts > 0)


def get_runtime_context() -> RuntimeContext:
    return RuntimeContext(_runtime())
