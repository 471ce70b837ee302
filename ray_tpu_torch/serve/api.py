"""ray_tpu_torch.serve public API.

Reference: python/ray/serve/api.py (@serve.deployment:1037, Deployment
class :730, serve.start, get_deployment, list_deployments). Deployments
are versioned replica sets managed by a singleton controller actor;
traffic flows driver/ingress → router → replica actor calls.
"""

from __future__ import annotations

import inspect
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Union

import ray_tpu_torch
from ray_tpu_torch.serve.config import AutoscalingConfig, DeploymentConfig

_CONTROLLER_NAME = "SERVE_CONTROLLER"


def start(detached: bool = False, http_options: Optional[dict] = None):
    """Start (or connect to) the serve control plane: a named singleton
    controller actor (reference: serve/api.py serve.start)."""
    from ray_tpu_torch.serve.controller import ServeController

    if not ray_tpu_torch.is_initialized():
        ray_tpu_torch.init()
    try:
        return ray_tpu_torch.get_actor(_CONTROLLER_NAME)
    except ValueError:  # raycheck: disable=RC05 — ValueError means "no controller yet"; creating one below IS the handling
        pass
    controller = ray_tpu_torch.remote(ServeController).options(
        name=_CONTROLLER_NAME,
        lifetime="detached" if detached else None,
    ).remote(http_options or {})
    ray_tpu_torch.get(controller.ready.remote())
    return controller


def _get_controller():
    try:
        return ray_tpu_torch.get_actor(_CONTROLLER_NAME)
    except ValueError:
        return start()


def shutdown() -> None:
    try:
        controller = ray_tpu_torch.get_actor(_CONTROLLER_NAME)
    except ValueError:
        return
    ray_tpu_torch.get(controller.shutdown.remote())
    ray_tpu_torch.kill(controller)


class Deployment:
    """A named, versioned, replicated callable (reference:
    serve/api.py:730)."""

    def __init__(self, func_or_class: Union[Callable, type], name: str,
                 config: DeploymentConfig,
                 init_args: tuple = (), init_kwargs: Optional[dict] = None,
                 version: Optional[str] = None,
                 route_prefix: Optional[str] = None):
        self._func_or_class = func_or_class
        self._name = name
        self._config = config
        self._init_args = init_args
        self._init_kwargs = init_kwargs or {}
        self._version = version
        self._route_prefix = route_prefix

    @property
    def name(self) -> str:
        return self._name

    @property
    def version(self) -> Optional[str]:
        return self._version

    @property
    def num_replicas(self) -> int:
        return self._config.num_replicas

    @property
    def route_prefix(self) -> Optional[str]:
        return self._route_prefix if self._route_prefix is not None \
            else f"/{self._name}"

    @property
    def func_or_class(self):
        return self._func_or_class

    def options(self, **kwargs) -> "Deployment":
        cfg_fields = {f for f in DeploymentConfig.__dataclass_fields__}
        cfg_updates = {k: v for k, v in kwargs.items() if k in cfg_fields}
        import dataclasses

        new_cfg = dataclasses.replace(self._config, **cfg_updates)
        return Deployment(
            kwargs.get("func_or_class", self._func_or_class),
            kwargs.get("name", self._name),
            new_cfg,
            kwargs.get("init_args", self._init_args),
            kwargs.get("init_kwargs", self._init_kwargs),
            kwargs.get("version", self._version),
            kwargs.get("route_prefix", self._route_prefix),
        )

    def deploy(self, *init_args, _blocking: bool = True, **init_kwargs):
        controller = _get_controller()
        if init_args or init_kwargs:
            self._init_args = init_args
            self._init_kwargs = init_kwargs
        ref = controller.deploy.remote(
            self._name, self._func_or_class, self._config,
            self._init_args, self._init_kwargs, self._version,
            self.route_prefix)
        if _blocking:
            ray_tpu_torch.get(ref)
        return self

    def delete(self) -> None:
        controller = _get_controller()
        ray_tpu_torch.get(controller.delete_deployment.remote(self._name))

    def get_handle(self, sync: bool = True) -> "RayServeHandle":
        from ray_tpu_torch.serve.handle import RayServeHandle

        return RayServeHandle(_get_controller(), self._name)

    def __call__(self, *args, **kwargs):
        raise RuntimeError(
            "Deployments cannot be called directly; use "
            f"{self._name}.get_handle() or HTTP.")

    def __repr__(self) -> str:
        return (f"Deployment(name={self._name}, "
                f"version={self._version}, "
                f"num_replicas={self._config.num_replicas})")


def deployment(_func_or_class=None, *, name: Optional[str] = None,
               version: Optional[str] = None,
               num_replicas: Optional[int] = None,
               init_args: tuple = (),
               init_kwargs: Optional[dict] = None,
               route_prefix: Optional[str] = None,
               ray_actor_options: Optional[dict] = None,
               user_config: Optional[Any] = None,
               max_concurrent_queries: Optional[int] = None,
               autoscaling_config: Optional[Union[dict,
                                                  AutoscalingConfig]] = None,
               graceful_shutdown_timeout_s: float = 20.0,
               health_check_period_s: Optional[float] = None,
               health_check_timeout_s: Optional[float] = None,
               health_check_failure_threshold: Optional[int] = None):
    """@serve.deployment decorator (reference: serve/api.py:1037).

    The ``health_check_*`` knobs tune the controller's probe loop per
    deployment (None = the process-wide Config.serve_health_check_*
    defaults); a class deployment may also define its own cheap
    ``check_health()`` whose falsy/raising answer fails the probe."""
    if isinstance(autoscaling_config, dict):
        autoscaling_config = AutoscalingConfig(**autoscaling_config)
    config = DeploymentConfig(
        num_replicas=num_replicas or 1,
        ray_actor_options=ray_actor_options or {},
        user_config=user_config,
        max_concurrent_queries=max_concurrent_queries or 100,
        autoscaling_config=autoscaling_config,
        graceful_shutdown_timeout_s=graceful_shutdown_timeout_s,
        health_check_period_s=health_check_period_s,
        health_check_timeout_s=health_check_timeout_s,
        health_check_failure_threshold=health_check_failure_threshold,
    )

    def wrap(func_or_class):
        return Deployment(
            func_or_class,
            name or func_or_class.__name__,
            config,
            init_args,
            init_kwargs,
            version,
            route_prefix,
        )

    if _func_or_class is not None:
        return wrap(_func_or_class)
    return wrap


def run(target, *, name: Optional[str] = None,
        route_prefix: Optional[str] = None):
    """The reference's 2.x entrypoint (serve/api.py serve.run).

    Deployment (or bare function/class, which gets wrapped) ->
    RayServeHandle. PipelineNode -> DeployedPipeline (call via
    .call(); pipelines route through their own step graph, so
    route_prefix does not apply and is rejected)."""
    from ray_tpu_torch.serve.pipeline import PipelineNode

    if isinstance(target, PipelineNode):
        if route_prefix is not None:
            raise ValueError(
                "route_prefix does not apply to pipeline targets")
        return target.deploy(name or "pipeline")
    if not isinstance(target, Deployment):
        target = deployment(target)
    if name or route_prefix is not None:
        overrides = {}
        if name:
            overrides["name"] = name
        if route_prefix is not None:
            overrides["route_prefix"] = route_prefix
        target = target.options(**overrides)
    target.deploy()
    return target.get_handle()


def get_deployment(name: str) -> Deployment:
    controller = _get_controller()
    info = ray_tpu_torch.get(controller.get_deployment_info.remote(name))
    if info is None:
        raise KeyError(f"no deployment named {name!r}")
    func_or_class, config, init_args, init_kwargs, version, route = info
    return Deployment(func_or_class, name, config, init_args, init_kwargs,
                      version, route)


def list_deployments() -> Dict[str, Deployment]:
    controller = _get_controller()
    names = ray_tpu_torch.get(controller.list_deployments.remote())
    return {n: get_deployment(n) for n in names}
