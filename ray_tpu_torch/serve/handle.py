"""RayServeHandle + router.

Reference: python/ray/serve/handle.py + router.py: the handle embeds a
router that holds the current replica membership (refreshed when the
controller's membership version moves) and picks replicas for each
request.

Resilience plane (this repo's serve hardening): the router runs
power-of-two-choices over LOCAL per-replica in-flight counts (no
metrics round trip per request — counts increment at assignment and
decrement when the result object materializes), consults the
per-destination circuit-breaker registry in :mod:`cluster.overload`
(open breaker => replica excluded), weights down replicas whose
``RetryLaterError`` shed hints are still fresh (temporary exclusion,
not blind retry), and — when every replica is shedding, breaker-open,
or saturated — surfaces a typed :class:`BackpressureError` to the
caller instead of queueing blind work. Completion outcomes feed the
breakers: a dead replica's errors open its breaker and P2C stops
offering it traffic before the controller's health probe even fires.

With ``Config.serve_resilience_enabled`` off, the pre-plane router
(round-robin over a per-request metrics fetch) is restored.
"""

from __future__ import annotations

import itertools
import logging
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

import ray_tpu_torch

logger = logging.getLogger(__name__)


class ControllerRef:
    """Wraps the controller handle; on a failed call, re-resolves the
    named singleton and retries once — so routers and handles survive a
    controller death + recovery (reference: handles reconnect through
    the long-poll client after controller failover)."""

    def __init__(self, handle):
        if isinstance(handle, ControllerRef):  # idempotent wrap
            handle = handle._handle
        self._handle = handle

    def call(self, method: str, *args) -> Any:
        try:
            return ray_tpu_torch.get(
                getattr(self._handle, method).remote(*args))
        except Exception:
            from ray_tpu_torch.serve.api import _CONTROLLER_NAME

            self._handle = ray_tpu_torch.get_actor(_CONTROLLER_NAME)
            return ray_tpu_torch.get(
                getattr(self._handle, method).remote(*args))


def _replica_key(deployment: str, handle) -> str:
    """Stable per-replica destination key for the overload registries
    (breakers / shed penalties) — shared process-wide, so every handle
    to the same deployment sees one breaker per replica."""
    return f"serve::{deployment}::{handle._actor_id.hex()[:16]}"


class Router:
    def __init__(self, controller, deployment_name: str):
        self._controller = (controller if isinstance(controller,
                                                     ControllerRef)
                            else ControllerRef(controller))
        self._name = deployment_name
        self._replicas: List[Tuple[str, Any]] = []  # (key, handle)
        self._version = -2
        self._max_concurrent = 100
        self._rr = itertools.count()
        self._lock = threading.Lock()
        self._inflight: Dict[str, int] = {}
        self._assigned: Dict[str, int] = {}  # lifetime picks (tie-break)
        from ray_tpu_torch.cluster import fault_plane

        # seeded per-deployment stream: under a fault plan the P2C
        # candidate draws replay with the storm schedule (RC03 posture)
        self._rng = fault_plane.derive_rng(
            f"serve-router|{deployment_name}")

    # ---------------------------------------------------------- membership
    def _refresh(self, force: bool = False) -> None:
        version = self._controller.call("get_membership_version",
                                        self._name)
        if version != self._version or force:
            v, replicas, max_c = self._controller.call(
                "get_membership", self._name)
            keyed = [(_replica_key(self._name, r), r) for r in replicas]
            with self._lock:
                self._version = v
                self._replicas = keyed
                self._max_concurrent = max_c
                live = {k for k, _ in keyed}
                for k in list(self._inflight):
                    if k not in live:
                        del self._inflight[k]
                for k in list(self._assigned):
                    if k not in live:
                        del self._assigned[k]

    # ------------------------------------------------- completion tracking
    def _register_done(self, key: str, ref) -> None:
        """Decrement the replica's in-flight count and feed its breaker
        when the result object materializes (value OR stored error)."""
        from ray_tpu_torch.core import runtime as rt_mod

        rt = rt_mod.global_runtime
        if rt is None or rt.is_shutdown:
            return
        oid = ref.id()
        store = rt.object_store

        def _done() -> None:
            with self._lock:
                n = self._inflight.get(key, 0)
                if n > 0:
                    self._inflight[key] = n - 1
            try:
                self._feed_outcome(key, store.peek(oid))
            except Exception as e:
                logger.debug("router completion hook for %s failed: %r",
                             key, e)

        try:
            store.on_available(oid, _done)
        except Exception as e:
            logger.debug("router could not watch %s: %r", oid, e)
            with self._lock:
                n = self._inflight.get(key, 0)
                if n > 0:
                    self._inflight[key] = n - 1

    def _feed_outcome(self, key: str, stored) -> None:
        from ray_tpu_torch.cluster import overload
        from ray_tpu_torch.exceptions import (
            RayActorError,
            RayTaskError,
            RetryLaterError,
            WorkerCrashedError,
        )

        if stored is None or not stored.is_error:
            overload.breaker_for(key).record_success()
            return
        err = stored.value
        cause = getattr(err, "cause", None) if isinstance(
            err, RayTaskError) else err
        if isinstance(cause, RetryLaterError):
            # shed hint: weight the replica DOWN for the server-chosen
            # window instead of blindly re-offering it traffic
            overload.note_shed(key, cause.retry_after_s)
            return
        if isinstance(err, (RayActorError, WorkerCrashedError)):
            # replica-level failure: count toward the breaker so P2C
            # stops offering a dead/poisoned replica before the
            # controller's probe replaces it
            overload.breaker_for(key).record_failure()
            return
        # a user exception is a HEALTHY replica doing its job
        overload.breaker_for(key).record_success()

    # ------------------------------------------------------------- routing
    def assign(self, max_concurrent: Optional[int] = None) -> Any:
        from ray_tpu_torch._private.config import Config

        cfg = Config.instance()
        if not cfg.serve_resilience_enabled:
            return self._assign_legacy(max_concurrent)
        replica, key = self._assign_resilient(
            cfg.serve_router_backpressure_timeout_s, max_concurrent)
        return replica, key

    def _assign_resilient(self, timeout_s: float,
                          max_concurrent: Optional[int]
                          ) -> Tuple[Any, str]:
        from ray_tpu_torch.cluster import overload
        from ray_tpu_torch.exceptions import BackpressureError
        from ray_tpu_torch.observability.metrics import (
            serve_requests_backpressured,
            serve_router_excluded,
        )

        deadline = time.monotonic() + timeout_s
        spent_desperation = False
        while True:
            self._refresh()
            with self._lock:
                replicas = list(self._replicas)
                inflight = dict(self._inflight)
                cap = (max_concurrent if max_concurrent is not None
                       else self._max_concurrent)
            if not replicas:
                raise RuntimeError(
                    f"deployment {self._name!r} has no replicas "
                    "(not deployed or deleted)")
            candidates: List[Tuple[str, Any]] = []
            min_penalty = None
            for key, handle in replicas:
                if not overload.breaker_for(key).allow():
                    serve_router_excluded.inc(
                        tags={"reason": "breaker_open"})
                    continue
                penalty = overload.shed_penalty_remaining(key)
                if penalty > 0.0:
                    serve_router_excluded.inc(
                        tags={"reason": "shed_penalty"})
                    min_penalty = (penalty if min_penalty is None
                                   else min(min_penalty, penalty))
                    continue
                if inflight.get(key, 0) >= cap:
                    serve_router_excluded.inc(
                        tags={"reason": "saturated"})
                    continue
                candidates.append((key, handle))
            if candidates:
                return self._pick_p2c(candidates, inflight)
            # every replica is shedding, breaker-open, or saturated.
            # One budget-gated desperation pass: offering a penalized
            # replica traffic anyway is a retry in the SRE sense, so it
            # spends a token — with the budget dry we fail fast instead
            # of amplifying (the metastable-storm discipline).
            penalized = [(k, h) for k, h in replicas
                         if overload.shed_penalty_remaining(k) > 0.0
                         and overload.breaker_for(k).allow()]
            if penalized and not spent_desperation \
                    and overload.budget_for(
                        f"serve::{self._name}").try_spend():
                spent_desperation = True
                return self._pick_p2c(penalized, inflight)
            if time.monotonic() >= deadline:
                serve_requests_backpressured.inc()
                raise BackpressureError(
                    self._name, retry_after_s=max(min_penalty or 0.0,
                                                  0.05))
            time.sleep(0.005)

    def _pick_p2c(self, candidates: List[Tuple[str, Any]],
                  inflight: Dict[str, int]) -> Tuple[Any, str]:
        """Power-of-two-choices: sample two distinct candidates, take
        the one with fewer local in-flight requests; ties break on
        fewest lifetime assignments (then membership order), so an
        idle fleet spreads exactly evenly like the old round-robin."""
        if len(candidates) == 1:
            key, handle = candidates[0]
        else:
            if len(candidates) == 2:
                pair = list(candidates)
            else:
                pair = self._rng.sample(candidates, 2)
            with self._lock:
                key, handle = min(
                    pair, key=lambda kh: (inflight.get(kh[0], 0),
                                          self._assigned.get(kh[0], 0)))
        with self._lock:
            self._inflight[key] = self._inflight.get(key, 0) + 1
            self._assigned[key] = self._assigned.get(key, 0) + 1
        return handle, key

    def _assign_legacy(self, max_concurrent: Optional[int]
                       ) -> Tuple[Any, None]:
        """Pre-plane router: round-robin over a per-request metrics
        fetch (kept verbatim behind serve_resilience_enabled=False)."""
        deadline = time.monotonic() + 30.0
        while True:
            self._refresh()
            with self._lock:
                replicas = [h for _, h in self._replicas]
                if max_concurrent is None:
                    max_concurrent = self._max_concurrent
            if not replicas:
                raise RuntimeError(
                    f"deployment {self._name!r} has no replicas "
                    "(not deployed or deleted)")
            # Round-robin, but skip replicas over the concurrency cap
            # (reference: router.py assign_replica backpressure).
            for _ in range(len(replicas)):
                idx = next(self._rr) % len(replicas)
                replica = replicas[idx]
                try:
                    ongoing = ray_tpu_torch.get(replica.metrics.remote())["ongoing"]
                except Exception:
                    self._version = -2  # dead replica → force refresh
                    continue
                if ongoing < max_concurrent:
                    return replica, None
            if time.monotonic() > deadline:
                return replicas[next(self._rr) % len(replicas)], None
            time.sleep(0.005)


class RayServeHandle:
    def __init__(self, controller, deployment_name: str,
                 method_name: Optional[str] = None,
                 router: Optional[Router] = None):
        self._controller = (controller if isinstance(controller,
                                                     ControllerRef)
                            else ControllerRef(controller))
        self._name = deployment_name
        self._method = method_name
        # Method sub-handles share the parent's router so routing
        # state (in-flight counts, membership) spans all methods of
        # the deployment.
        self._router = router or Router(self._controller,
                                        deployment_name)

    def options(self, method_name: str) -> "RayServeHandle":
        return RayServeHandle(self._controller, self._name, method_name,
                              self._router)

    def __getattr__(self, item: str) -> "RayServeHandle":
        if item.startswith("_"):
            raise AttributeError(item)
        return RayServeHandle(self._controller, self._name, item,
                              self._router)

    def remote(self, *args, **kwargs) -> "ray_tpu_torch.ObjectRef":
        replica, key = self._router.assign()
        ref = replica.handle_request.remote(
            self._method or "__call__", args, kwargs)
        if key is not None:
            self._router._register_done(key, ref)
        return ref

    def __repr__(self) -> str:
        return f"RayServeHandle(deployment={self._name!r})"
