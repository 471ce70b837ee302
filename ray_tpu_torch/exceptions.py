"""User-facing exception hierarchy.

Mirrors the reference's python/ray/exceptions.py: errors raised inside a
remote task are captured with their traceback, shipped back as the task's
return object, and re-raised at every ``get`` with a cause chain that names
the remote function and the process it died in.
"""

from __future__ import annotations

import traceback
from typing import Optional


class RayTpuError(Exception):
    """Base class for all framework errors."""


class CrossLanguageError(RayTpuError):
    pass


class TaskError(RayTpuError):
    pass


class RayTaskError(TaskError):
    """Wraps an exception raised by user code inside a remote task.

    Stored as the task's return object; re-raised on ``get``. Carries the
    remote traceback text so the user sees where the failure happened.
    (reference: python/ray/exceptions.py RayTaskError)
    """

    def __init__(
        self,
        function_name: str,
        traceback_str: str,
        cause: Optional[BaseException] = None,
        pid: int = 0,
        node_hex: str = "",
    ):
        self.function_name = function_name
        self.traceback_str = traceback_str
        self.cause = cause
        self.pid = pid
        self.node_hex = node_hex
        super().__init__(self._message())

    def _message(self) -> str:
        return (
            f"{type(self.cause).__name__ if self.cause else 'Error'} in "
            f"{self.function_name} (pid={self.pid}, node={self.node_hex[:8]}):\n"
            f"{self.traceback_str}"
        )

    @classmethod
    def from_exception(cls, function_name: str, exc: BaseException, pid: int = 0,
                       node_hex: str = "") -> "RayTaskError":
        tb = "".join(
            traceback.format_exception(type(exc), exc, exc.__traceback__)
        )
        return cls(function_name, tb, cause=exc, pid=pid, node_hex=node_hex)

    def as_instanceof_cause(self) -> BaseException:
        """Return an exception that is both a RayTaskError and an instance
        of the user's exception class, so ``except UserError`` works across
        the process boundary (reference exceptions.py make_dual_exception)."""
        cause = self.cause
        if cause is None or isinstance(cause, RayTaskError):
            return self
        cause_cls = type(cause)
        try:
            dual_cls = type(
                "RayTaskError(" + cause_cls.__name__ + ")",
                (RayTaskError, cause_cls),
                # accept (and ignore) pickle's re-construction args so the
                # dual class survives a cloudpickle round-trip (client)
                {"__init__": lambda s, *a, **k: None},
            )
            dual = dual_cls()
            dual.function_name = self.function_name
            dual.traceback_str = self.traceback_str
            dual.cause = cause
            dual.pid = self.pid
            dual.node_hex = self.node_hex
            dual.args = (self._message(),)
            return dual
        except TypeError:
            return self


class WorkerCrashedError(TaskError):
    """The worker executing the task died mid-execution."""


class TaskCancelledError(TaskError):
    def __init__(self, task_id=None):
        self.task_id = task_id
        super().__init__(
            "This task or its dependency was cancelled"
            + (f" (task {task_id})" if task_id else "")
        )


class RayActorError(RayTpuError):
    """The actor died before or while executing a submitted method."""

    def __init__(self, message: str = "The actor died unexpectedly before "
                 "finishing this task."):
        super().__init__(message)


class ActorDiedError(RayActorError):
    pass


class ActorInitError(RayActorError):
    """The actor's ``__init__`` (or class deserialization) raised — a
    DETERMINISTIC creation failure. Raylets raise it so the GCS marks
    the actor DEAD with the error instead of burning placement retries
    on other nodes (infra failures — crashes, timeouts, resource races
    — stay retryable and are never wrapped in this type)."""


class ActorUnavailableError(RayActorError):
    pass


class RetryLaterError(RayTpuError):
    """The peer is alive but overloaded — it shed this request before
    running the handler (admission-queue full, queue-deadline expiry,
    or a bounded task queue pushing back).

    Carries ``retry_after_s``, the server-suggested backoff hint; the
    resilient client honors it (and its circuit breaker uses it for the
    open window) so N callers back off at the pace the overloaded server
    asked for instead of hammering it in lockstep (reference: gRPC
    RESOURCE_EXHAUSTED + retry pushback / Ray raylet task backpressure).
    """

    def __init__(self, message: str = "server overloaded; retry later",
                 retry_after_s: float = 0.05):
        self.retry_after_s = float(retry_after_s)
        super().__init__(message)

    def __reduce__(self):
        # keep the hint across the pickled err-frame round trip (bare
        # Exception reduce would rebuild from args and drop it)
        return (type(self), (self.args[0] if self.args else "",
                             self.retry_after_s))


class BackpressureError(RetryLaterError):
    """Every replica of a serve deployment is currently shedding,
    breaker-open, or saturated — the router could not place the request
    anywhere without amplifying the overload (the serve-layer cousin of
    ``RetryLaterError``: typed, carries the soonest-retry hint, raised
    SYNCHRONOUSLY by ``handle.remote()`` so callers back off instead of
    queueing blind work against a collapsing replica set).

    Reference: Ray Serve's router backpressure / max_queued_requests
    rejection (serve/_private/router.py)."""

    def __init__(self, deployment: str = "",
                 message: str = "", retry_after_s: float = 0.1):
        self.deployment = deployment
        super().__init__(
            message or (f"deployment {deployment!r}: all replicas are "
                        f"shedding or unavailable; retry later"),
            retry_after_s=retry_after_s)

    def __reduce__(self):
        return (type(self), (self.deployment,
                             self.args[0] if self.args else "",
                             self.retry_after_s))


class ObjectCorruptedError(RayTpuError):
    """A stored or transferred object's payload failed its checksum —
    a flipped bit on the wire, a torn spill file, or a scribbled shm
    segment (the integrity plane, cluster/integrity.py). The detecting
    holder discards the corrupt replica; callers recover by re-pulling
    from another holder or reconstructing via lineage, so the driver
    sees the correct value or this typed error — never garbage."""

    def __init__(self, object_id_hex: str = "", seam: str = "",
                 message: str = ""):
        self.object_id_hex = object_id_hex
        self.seam = seam
        super().__init__(
            message
            or f"Object {object_id_hex[:16] or '?'} failed checksum "
               f"verification at {seam or 'an unknown seam'}; the "
               f"corrupt replica was discarded.")

    def __reduce__(self):
        # keep the id/seam across the pickled err-frame round trip
        return (type(self), (self.object_id_hex, self.seam,
                             self.args[0] if self.args else ""))


class ObjectStoreFullError(RayTpuError):
    pass


class OutOfDiskError(RayTpuError):
    pass


class ObjectLostError(RayTpuError):
    def __init__(self, object_id_hex: str, message: str = ""):
        self.object_id_hex = object_id_hex
        super().__init__(
            message
            or f"Object {object_id_hex[:16]} is lost (all copies unavailable "
            "and reconstruction disabled or exhausted)."
        )


class ObjectFetchTimedOutError(ObjectLostError):
    pass


class ReferenceCountingAssertionError(ObjectLostError):
    pass


class OwnerDiedError(ObjectLostError):
    def __init__(self, object_id_hex: str):
        super().__init__(
            object_id_hex,
            f"Object {object_id_hex[:16]} cannot be retrieved: its owner "
            "process died, so its metadata and lineage are gone.",
        )


class ObjectReconstructionFailedError(ObjectLostError):
    pass


class ObjectReconstructionFailedMaxAttemptsExceededError(ObjectLostError):
    pass


class ObjectReconstructionFailedLineageEvictedError(ObjectLostError):
    pass


class GetTimeoutError(RayTpuError, TimeoutError):
    pass


class PlacementGroupError(RayTpuError):
    pass


class PlacementGroupRemovedError(PlacementGroupError):
    pass


class RuntimeEnvSetupError(RayTpuError):
    pass


class PendingCallsLimitExceeded(RayTpuError):
    pass


class AsyncioActorExit(RayTpuError):
    """Raised internally by exit_actor() inside async actors."""
