"""Replica actor — hosts one copy of the user's deployment.

Reference: python/ray/serve/replica.py (RayServeReplica): executes
requests against the user callable, tracks ongoing-request count (the
autoscaling metric), applies user_config via reconfigure().

Resilience plane additions (this repo's serve hardening):

- ``check_health()`` — the cheap controller probe; delegates to the
  user callable's own ``check_health`` when it defines one (reference:
  deployment_state.py replica health checks), else reports alive.
- ``drain(grace_s)`` — graceful shutdown entry: new requests are shed
  with :class:`RetryLaterError` once the grace window passes (the
  window absorbs assignments routed on the pre-drain membership), and
  the controller polls ``num_ongoing()`` down to zero before killing.
- A fault-plane response seam: when a :mod:`cluster.fault_plane` plan
  is active, the reply payload round-trips through bytes with a crc32
  computed ONCE at creation, the plane's seeded ``stall``/``corrupt``
  actions fire against ``dst="serve::<deployment>"``, and — with the
  resilience plane on — a flipped byte is caught by the digest and the
  reply is re-serialized from the still-intact value (correct answer,
  detection counted) instead of deserializing to silent garbage.
"""

from __future__ import annotations

import inspect
import logging
import threading
import time
from typing import Any, Optional

logger = logging.getLogger(__name__)


class ReplicaActor:
    def __init__(self, func_or_class, init_args: tuple, init_kwargs: dict,
                 user_config: Optional[Any] = None,
                 deployment_name: str = "", replica_tag: str = ""):
        self._is_function = inspect.isfunction(func_or_class) or (
            callable(func_or_class) and not inspect.isclass(func_or_class))
        if self._is_function:
            self._callable = func_or_class
        else:
            self._callable = func_or_class(*init_args, **init_kwargs)
        self._deployment = deployment_name
        self._replica_tag = replica_tag
        self._ongoing = 0
        self._total = 0
        self._num_shed = 0
        self._lock = threading.Lock()
        self._draining = False
        self._drain_started = 0.0
        self._drain_grace_s = 0.0
        if user_config is not None:
            self.reconfigure(user_config)

    def ready(self) -> bool:
        return True

    def check_health(self) -> bool:
        """Controller probe (cheap). A user callable that defines its
        own ``check_health`` decides (falsy/raise = unhealthy); without
        one, answering at all is the health signal."""
        if not self._is_function:
            probe = getattr(self._callable, "check_health", None)
            if callable(probe):
                return bool(probe())
        return True

    def reconfigure(self, user_config: Any) -> None:
        if not self._is_function and hasattr(self._callable, "reconfigure"):
            self._callable.reconfigure(user_config)

    # ------------------------------------------------------------- draining
    def drain(self, grace_s: float = 0.0) -> int:
        """Stop accepting new work (after ``grace_s``) and report the
        current in-flight count; the controller polls num_ongoing()
        down to zero before the kill (reference: deployment_state.py
        graceful_shutdown_wait_loop_s drain loop)."""
        with self._lock:
            if not self._draining:
                self._draining = True
                self._drain_started = time.monotonic()
                self._drain_grace_s = max(0.0, float(grace_s))
            return self._ongoing

    def num_ongoing(self) -> int:
        with self._lock:
            return self._ongoing

    # ------------------------------------------------------------- requests
    def handle_request(self, method_name: str, args: tuple, kwargs: dict
                       ) -> Any:
        with self._lock:
            if self._draining and (
                    time.monotonic() - self._drain_started
                    > self._drain_grace_s):
                self._num_shed += 1
                shed = True
            else:
                shed = False
                self._ongoing += 1
                self._total += 1
        if shed:
            from ray_tpu_torch.exceptions import RetryLaterError

            raise RetryLaterError(
                f"replica {self._replica_tag or '?'} of "
                f"{self._deployment or '?'} is draining", retry_after_s=0.1)
        try:
            self._maybe_stall(method_name)
            if self._is_function:
                result = self._callable(*args, **kwargs)
            elif method_name in (None, "", "__call__"):
                result = self._callable(*args, **kwargs)
            else:
                result = getattr(self._callable, method_name)(
                    *args, **kwargs)
            return self._respond(result, method_name)
        finally:
            with self._lock:
                self._ongoing -= 1

    # ------------------------------------------------- fault-plane seam
    def _fault_dst(self) -> str:
        return f"serve::{self._deployment or '?'}"

    def _maybe_stall(self, method_name: str) -> None:
        """Seeded ``stall`` rules against ``dst="serve::<deployment>"``
        slow this replica down inside its request slot — the storm
        ingredient the router's in-flight balancing routes around."""
        from ray_tpu_torch.cluster import fault_plane

        plane = fault_plane.get_plane()
        if plane is None:
            return
        fault = plane.decide("handler", self._fault_dst(),
                             method_name or "__call__")
        if fault is not None and fault["action"] == "stall":
            time.sleep(fault["seconds"])

    def _respond(self, result: Any, method_name: str) -> Any:
        """Response seam. With no fault plane active (the common case)
        the value passes through untouched. Under a plan, the reply
        takes the byte path: serialize once, digest once, let the
        plane's seeded ``corrupt`` flip a byte in 'transit', then —
        resilience plane on — verify the digest at hand-off and
        re-serialize from the intact value on mismatch (detection, not
        wrongness); plane off, deserialize whatever the bytes say (the
        silent-wrong-answer baseline the storm demo measures)."""
        from ray_tpu_torch.cluster import fault_plane

        plane = fault_plane.get_plane()
        if plane is None:
            return result
        fault = plane.decide("reply", self._fault_dst(),
                             method_name or "__call__")
        if fault is None or fault["action"] != "corrupt":
            return result
        import zlib

        import cloudpickle

        from ray_tpu_torch._private.config import Config

        try:
            payload = cloudpickle.dumps(result)
        except Exception as e:
            logger.debug("serve reply seam: result of %s.%s not "
                         "picklable (%r); skipping byte path",
                         self._deployment, method_name, e)
            return result
        crc = zlib.crc32(payload)
        buf = bytes(fault_plane.apply_corruption(payload, fault,
                                                 tail_bias=True))
        if Config.instance().serve_resilience_enabled:
            if zlib.crc32(buf) != crc:
                from ray_tpu_torch.cluster import integrity

                integrity.record_corruption("serve_reply",
                                            discarded=False)
                # recovery: the computed value is still intact in this
                # process — re-serialize and hand off the correct bytes
                return result
            return cloudpickle.loads(buf)
        try:
            return cloudpickle.loads(buf)  # plane off: silent garbage
        except Exception as e:
            # the flip landed in pickle structure instead of payload
            # bytes: loud failure, the lucky case
            raise RuntimeError(
                f"corrupted serve reply for {self._deployment}."
                f"{method_name}: {e!r}")

    def metrics(self) -> dict:
        with self._lock:
            return {"ongoing": self._ongoing, "total": self._total,
                    "shed": self._num_shed,
                    "draining": self._draining}
