"""Serve controller — the singleton control-plane actor.

Reference: python/ray/serve/controller.py + deployment_state.py: owns the
goal state of every deployment, reconciles replica actor sets (scale
up/down, rolling updates on version change), and runs the autoscaling
loop on replica queue metrics (serve/autoscaling_policy.py).

Resilience plane (this repo's serve hardening, reference:
deployment_state.py health-check/drain machinery):

- A health-probe loop calls each replica's cheap ``check_health()``
  every ``health_check_period_s``; a timeout or falsy reply counts as a
  failure, and ``health_check_failure_threshold`` CONSECUTIVE failures
  mark the replica unhealthy — it is removed from routing (membership
  version bump), drained, killed, and replaced by the reconcile loop.
  This is DISTINCT from actor death: a wedged-but-alive replica (stuck
  lock, poisoned state) fails probes while still holding its actor slot.
- Every replica stop — scale-down, rolling update, unhealthy
  replacement, deletion — goes through the graceful drain: routing
  stops first (membership bump), the replica sheds new work after the
  grace window, and the controller polls in-flight down to zero for up
  to ``graceful_shutdown_timeout_s`` before the kill. A calm rolling
  update therefore drops zero in-flight requests.
"""

from __future__ import annotations

import logging
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

import ray_tpu_torch
from ray_tpu_torch.serve.config import AutoscalingConfig, DeploymentConfig
from ray_tpu_torch.serve.replica import ReplicaActor

logger = logging.getLogger(__name__)

AUTOSCALE_INTERVAL_S = 0.25
HEALTH_TICK_S = 0.05


CHECKPOINT_KEY = b"controller-checkpoint"


@dataclass
class DeploymentState:
    name: str
    func_or_class: Any
    config: DeploymentConfig
    init_args: tuple
    init_kwargs: dict
    version: Optional[str]
    route_prefix: Optional[str]
    replicas: List[Any] = field(default_factory=list)   # actor handles
    replica_names: List[str] = field(default_factory=list)
    replica_versions: List[Optional[str]] = field(default_factory=list)
    target_replicas: int = 1
    membership_version: int = 0
    # consecutive health-probe failures per replica name; a name crossing
    # the deployment's threshold is drained and replaced
    health_failures: Dict[str, int] = field(default_factory=dict)
    last_probe: float = 0.0


class ServeController:
    """Singleton control-plane actor. FAULT-TOLERANT: every goal-state
    mutation checkpoints to the runtime KV (which lives outside this
    actor), and __init__ recovers from the checkpoint — re-attaching
    still-live replica actors by their stable names and restarting the
    rest — so controller death loses no deployments (reference:
    serve/controller.py checkpoints via serve/storage/kv_store.py and
    deployment_state.py recovers replica actors by name)."""

    def __init__(self, http_options: Optional[dict] = None):
        from ray_tpu_torch.core import runtime as rt_mod
        from ray_tpu_torch.serve.kv_store import KVStore

        self._deployments: Dict[str, DeploymentState] = {}
        self._lock = threading.RLock()
        self._http_options = http_options or {}
        self._stopped = False
        # the runtime this controller serves in: its loops end with it,
        # so a killed controller's threads cannot start a new runtime
        # through a remote call once that one shuts down
        self._runtime = rt_mod.global_runtime
        self._kv = KVStore()
        self._recover_from_checkpoint()
        self._autoscale_thread = threading.Thread(
            target=self._autoscale_loop, daemon=True)
        self._autoscale_thread.start()
        self._health_thread = threading.Thread(
            target=self._health_loop, daemon=True)
        self._health_thread.start()

    def ready(self) -> bool:
        return True

    def _serving(self) -> bool:
        rt = self._runtime
        return not self._stopped and rt is not None and not rt.is_shutdown

    # -------------------------------------------------- checkpoint/recover
    def _checkpoint(self) -> None:
        """Persist goal state + replica names (NOT handles — those die
        with their owner; names re-resolve). Called under self._lock
        after every mutation."""
        import cloudpickle

        data = {}
        for name, s in self._deployments.items():
            try:
                func_bytes = cloudpickle.dumps(s.func_or_class)
            except Exception:
                # an unpicklable deployable (e.g. a wrapper capturing a
                # lock) cannot survive a controller failover; keep it
                # serving now and keep every OTHER deployment durable
                logger.warning(
                    "deployment %r is not picklable and will not "
                    "survive controller failover", name)
                continue
            data[name] = {
                "func_or_class": func_bytes,
                "config": s.config,
                "init_args": s.init_args,
                "init_kwargs": s.init_kwargs,
                "version": s.version,
                "route_prefix": s.route_prefix,
                "target_replicas": s.target_replicas,
                "replica_names": list(s.replica_names),
                "replica_versions": list(s.replica_versions),
                "membership_version": s.membership_version,
            }
        self._kv.put(CHECKPOINT_KEY, cloudpickle.dumps(data))

    def _recover_from_checkpoint(self) -> None:
        import cloudpickle

        try:
            raw = self._kv.get(CHECKPOINT_KEY)
        except RuntimeError:
            return  # no runtime (unit-test construction): cold start
        if raw is None:
            return
        data = cloudpickle.loads(raw)
        with self._lock:
            for name, d in data.items():
                state = DeploymentState(
                    name, cloudpickle.loads(d["func_or_class"]),
                    d["config"], d["init_args"], d["init_kwargs"],
                    d["version"], d["route_prefix"])
                state.target_replicas = d["target_replicas"]
                # bump so routers holding the old version re-fetch
                state.membership_version = d["membership_version"] + 1
                for rname, rver in zip(d["replica_names"],
                                       d["replica_versions"]):
                    try:  # re-attach replicas that survived us
                        h = ray_tpu_torch.get_actor(rname)
                        ray_tpu_torch.get(h.ready.remote())
                    except Exception:
                        continue
                    state.replicas.append(h)
                    state.replica_names.append(rname)
                    state.replica_versions.append(rver)
                self._deployments[name] = state
                self._reconcile(state)  # start whatever is missing
            self._checkpoint()

    # ------------------------------------------------------------- deploy
    def deploy(self, name: str, func_or_class, config: DeploymentConfig,
               init_args: tuple, init_kwargs: dict,
               version: Optional[str], route_prefix: Optional[str]) -> bool:
        with self._lock:
            state = self._deployments.get(name)
            rolling = (state is not None and
                       (state.version != version or version is None))
            if state is None:
                state = DeploymentState(
                    name, func_or_class, config, init_args, init_kwargs,
                    version, route_prefix)
                self._deployments[name] = state
            else:
                state.func_or_class = func_or_class
                state.config = config
                state.init_args = init_args
                state.init_kwargs = init_kwargs
                state.version = version
                state.route_prefix = route_prefix
            if config.autoscaling_config is not None:
                state.target_replicas = max(
                    config.autoscaling_config.min_replicas,
                    min(state.target_replicas or 1,
                        config.autoscaling_config.max_replicas))
            else:
                state.target_replicas = config.num_replicas
            stops = self._reconcile(state, rolling_update=rolling)
            self._checkpoint()
            timeout_s = config.graceful_shutdown_timeout_s
        # drains happen OUTSIDE the lock: routing already moved to the
        # new membership, and a drain wait must not block other
        # control-plane calls (deploys, router refreshes)
        self._finalize_stops(stops, timeout_s)
        return True

    def _start_replica(self, state: DeploymentState):
        import uuid

        opts = dict(state.config.ray_actor_options)
        # Replicas admit up to max_concurrent_queries in-flight requests
        # (reference: replicas are async actors; backpressure above that
        # cap is the router's job).
        opts.setdefault("max_concurrency",
                        state.config.max_concurrent_queries)
        # stable name => a restarted controller can re-attach the live
        # replica instead of restarting it (reference: deployment_state
        # recovers replicas by actor name)
        name = f"SERVE_REPLICA::{state.name}::{uuid.uuid4().hex[:8]}"
        opts["name"] = name
        replica = ray_tpu_torch.remote(ReplicaActor).options(**opts).remote(
            state.func_or_class, state.init_args, state.init_kwargs,
            state.config.user_config,
            deployment_name=state.name, replica_tag=name)
        ray_tpu_torch.get(replica.ready.remote())
        return replica, name

    def _reconcile(self, state: DeploymentState,
                   rolling_update: bool = False) -> List[Tuple[Any, str]]:
        """Drive the replica set to the target (reference:
        deployment_state.py _scale_deployment_replicas + rolling update).

        Called under self._lock. Replicas leaving the set are removed
        from routing HERE (membership bump) and returned as
        ``(handle, name)`` stops for the caller to gracefully drain
        outside the lock."""
        stops: List[Tuple[Any, str]] = []
        if rolling_update:
            # Start the full new set before the old stops serving, then
            # swap membership atomically: routing moves to the new
            # replicas in one version bump and the old set drains.
            old = list(zip(state.replicas, state.replica_names))
            new_replicas, new_names = [], []
            for _ in range(state.target_replicas):
                replica, name = self._start_replica(state)
                new_replicas.append(replica)
                new_names.append(name)
            state.replicas = new_replicas
            state.replica_names = new_names
            state.replica_versions = [state.version] * len(new_replicas)
            state.health_failures = {}
            state.membership_version += 1
            stops.extend(old)
            return stops
        while len(state.replicas) < state.target_replicas:
            replica, name = self._start_replica(state)
            state.replicas.append(replica)
            state.replica_names.append(name)
            state.replica_versions.append(state.version)
            state.membership_version += 1
        while len(state.replicas) > state.target_replicas:
            victim = state.replicas.pop()
            victim_name = state.replica_names.pop()
            state.replica_versions.pop()
            state.health_failures.pop(victim_name, None)
            state.membership_version += 1
            stops.append((victim, victim_name))
        return stops

    # --------------------------------------------------------------- drains
    def _finalize_stops(self, stops: List[Tuple[Any, str]],
                        timeout_s: float) -> None:
        """Gracefully stop replicas already removed from routing: ask
        each to drain (shed new work after the grace window), poll
        in-flight down to zero for up to ``timeout_s``, then kill.
        With the resilience plane off, this is the legacy immediate
        kill."""
        if not stops:
            return
        from ray_tpu_torch._private.config import Config

        cfg = Config.instance()
        if not cfg.serve_resilience_enabled:
            for replica, _ in stops:
                ray_tpu_torch.kill(replica)
            return
        from ray_tpu_torch.observability.metrics import serve_drains_completed

        grace = cfg.serve_drain_grace_s
        for replica, name in stops:
            drained = False
            try:
                ray_tpu_torch.get(replica.drain.remote(grace), timeout=5.0)
                deadline = time.monotonic() + max(0.0, timeout_s)
                while time.monotonic() < deadline:
                    ongoing = ray_tpu_torch.get(replica.num_ongoing.remote(),
                                          timeout=5.0)
                    if ongoing == 0:
                        drained = True
                        break
                    time.sleep(0.02)
            except Exception as e:
                # a dead/wedged replica cannot drain; the kill below is
                # the backstop either way
                logger.debug("drain of replica %s failed: %r", name, e)
            if drained:
                serve_drains_completed.inc()
            else:
                logger.warning(
                    "replica %s still had in-flight requests after "
                    "%.1fs graceful window; killing", name, timeout_s)
            ray_tpu_torch.kill(replica)

    def delete_deployment(self, name: str) -> bool:
        with self._lock:
            state = self._deployments.pop(name, None)
            if state is not None:
                self._checkpoint()
        if state is None:
            return False
        self._finalize_stops(
            list(zip(state.replicas, state.replica_names)),
            state.config.graceful_shutdown_timeout_s)
        return True

    # -------------------------------------------------------------- reads
    def list_deployments(self) -> List[str]:
        with self._lock:
            return list(self._deployments.keys())

    def get_deployment_info(self, name: str):
        with self._lock:
            s = self._deployments.get(name)
            if s is None:
                return None
            return (s.func_or_class, s.config, s.init_args, s.init_kwargs,
                    s.version, s.route_prefix)

    def get_replicas(self, name: str) -> Tuple[int, List[Any]]:
        """Router membership fetch: (membership_version, handles).
        Reference: serve/long_poll.py — routers re-fetch when the version
        they hold goes stale."""
        with self._lock:
            s = self._deployments.get(name)
            if s is None:
                return -1, []
            return s.membership_version, list(s.replicas)

    def get_membership(self, name: str) -> Tuple[int, List[Any], int]:
        """Router fetch with routing config in one round trip:
        (membership_version, handles, max_concurrent_queries)."""
        with self._lock:
            s = self._deployments.get(name)
            if s is None:
                return -1, [], 100
            return (s.membership_version, list(s.replicas),
                    s.config.max_concurrent_queries)

    def get_membership_version(self, name: str) -> int:
        with self._lock:
            s = self._deployments.get(name)
            return -1 if s is None else s.membership_version

    def get_routes(self) -> Dict[str, str]:
        with self._lock:
            return {s.route_prefix: name
                    for name, s in self._deployments.items()
                    if s.route_prefix}

    # ------------------------------------------------------ health probing
    def _health_loop(self) -> None:
        """Probe every replica's check_health() on its deployment's
        period; threshold consecutive failures => drain + replace
        (reference: deployment_state.py check_health loop)."""
        from ray_tpu_torch._private.config import Config

        while self._serving():
            time.sleep(HEALTH_TICK_S)
            if not self._serving() or \
                    not Config.instance().serve_resilience_enabled:
                continue
            try:
                self._probe_due_deployments()
            except Exception as e:  # keep the loop alive
                logger.debug("health-probe tick failed: %r", e)

    def _probe_due_deployments(self) -> None:
        now = time.monotonic()
        with self._lock:
            due = []
            for s in self._deployments.values():
                period, timeout, threshold = \
                    s.config.resolved_health_check()
                if now - s.last_probe >= period:
                    s.last_probe = now
                    due.append((s, timeout, threshold,
                                list(zip(s.replicas, s.replica_names))))
        for state, timeout, threshold, members in due:
            self._probe_deployment(state, timeout, threshold, members)

    def _probe_deployment(self, state: DeploymentState, timeout: float,
                          threshold: int, members) -> None:
        unhealthy: List[str] = []
        for replica, name in members:
            if not self._serving():
                return
            healthy = False
            try:
                healthy = bool(ray_tpu_torch.get(replica.check_health.remote(),
                                           timeout=timeout))
            except Exception as e:
                # dead actor, wedged executor, or probe timeout — all
                # count against the threshold
                logger.debug("health probe of %s raised: %r", name, e)
            with self._lock:
                if name not in state.replica_names:
                    continue  # already removed (scale-down raced us)
                if healthy:
                    state.health_failures.pop(name, None)
                    continue
                fails = state.health_failures.get(name, 0) + 1
                state.health_failures[name] = fails
                if fails >= threshold:
                    unhealthy.append(name)
        for name in unhealthy:
            self._replace_unhealthy_replica(state, name)

    def _replace_unhealthy_replica(self, state: DeploymentState,
                                   name: str) -> None:
        from ray_tpu_torch.observability.metrics import serve_replicas_unhealthy

        with self._lock:
            if name not in state.replica_names:
                return
            idx = state.replica_names.index(name)
            replica = state.replicas.pop(idx)
            state.replica_names.pop(idx)
            state.replica_versions.pop(idx)
            state.health_failures.pop(name, None)
            state.membership_version += 1
        serve_replicas_unhealthy.inc()
        logger.warning(
            "replica %s of %s failed %d consecutive health probes; "
            "draining and replacing", name, state.name,
            state.config.resolved_health_check()[2])
        # a SHORT drain window: the replica is unhealthy, so in-flight
        # work there is already suspect — give it one grace period, not
        # the full graceful_shutdown_timeout_s
        self._finalize_stops(
            [(replica, name)],
            min(1.0, state.config.graceful_shutdown_timeout_s))
        with self._lock:
            if state.name not in self._deployments:
                return  # deleted while we drained
            stops = self._reconcile(state)  # start the replacement
            self._checkpoint()
            timeout_s = state.config.graceful_shutdown_timeout_s
        self._finalize_stops(stops, timeout_s)

    # --------------------------------------------------------- autoscaling
    def _autoscale_loop(self) -> None:
        while self._serving():
            time.sleep(AUTOSCALE_INTERVAL_S)
            if not self._serving():
                return
            try:
                self._autoscale_once()
            except Exception as e:  # noqa: BLE001 — keep the loop alive
                logger.debug("autoscale tick failed: %r", e)

    def _autoscale_once(self) -> None:
        with self._lock:
            states = [s for s in self._deployments.values()
                      if s.config.autoscaling_config is not None]
        for state in states:
            cfg: AutoscalingConfig = state.config.autoscaling_config
            metrics = ray_tpu_torch.get(
                [r.metrics.remote() for r in list(state.replicas)])
            total_ongoing = sum(m["ongoing"] for m in metrics)
            n = max(len(state.replicas), 1)
            desired = total_ongoing / cfg.target_num_ongoing_requests_per_replica
            desired = n + cfg.smoothing_factor * (desired - n)
            import math

            target = int(min(cfg.max_replicas,
                             max(cfg.min_replicas, math.ceil(desired))))
            stops: List[Tuple[Any, str]] = []
            with self._lock:
                if target != state.target_replicas:
                    state.target_replicas = target
                    stops = self._reconcile(state)
                    self._checkpoint()
            self._finalize_stops(
                stops, state.config.graceful_shutdown_timeout_s)

    def shutdown(self) -> None:
        self._stopped = True
        with self._lock:
            names = list(self._deployments.keys())
        for n in names:
            self.delete_deployment(n)
        try:  # a CLEAN shutdown clears the checkpoint; a crash leaves
            # it for the next controller to recover from
            self._kv.delete(CHECKPOINT_KEY)
        except RuntimeError as e:
            logger.debug("could not clear controller checkpoint at "
                         "shutdown (runtime already gone): %r", e)
