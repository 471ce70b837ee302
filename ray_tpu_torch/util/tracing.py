"""Distributed tracing: spans around task/actor submission & execution.

Reference: python/ray/util/tracing/tracing_helper.py — OpenTelemetry
spans are wrapped around ``.remote()`` invocation
(_tracing_task_invocation:286) and worker-side execution
(_inject_tracing_into_function:320), with the span context propagated
*inside the task spec* so the execution span parents to the submission
span across the process boundary. Opt-in via
``ray.init(_tracing_startup_hook=...)`` (worker.py:666).

This build keeps the same shape without requiring the opentelemetry
package: a minimal tracer with W3C-style ids, context carried in
``TaskSpec.trace_context`` and on every RPC frame (the ``_trace``
reserved kwarg, cluster/rpc.py), and pluggable exporters (the default
buffers in memory; ``JsonFileExporter`` mirrors the reference's
setup_local_tmp_tracing hook which exports spans to a local file).

Sampling is head-based: the decision is made once at the trace root —
from the seeded fault-plane RNG so runs replay deterministically
(raycheck RC03) — and rides the wire with the context, so a trace is
recorded everywhere or nowhere. Server processes that never called
``setup_tracing`` still record handler spans for sampled remote traces
via :func:`record_remote_span`; those land in the bounded span buffer
and, when the observability plane is on, in the per-process flight
recorder, which the GCS's ``collect_timeline`` gathers from every node.
"""

from __future__ import annotations

import json
import os
import threading
import time
from collections import deque
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

_state = threading.local()
_lock = threading.Lock()
_enabled = False
_exporters: List[Callable[["Span"], None]] = []
_MAX_BUFFER = 100_000
# Bounded: long-lived processes keep the most recent spans only, and the
# counter keeps dumps honest about evicted history (raycheck RC10).
_buffer: deque = deque(maxlen=_MAX_BUFFER)
_dropped = 0
_sampler_rng = None


@dataclass
class SpanContext:
    trace_id: str
    span_id: str
    sampled: bool = True

    def to_dict(self) -> Dict[str, str]:
        """Wire form (the RPC ``_trace`` kwarg / TaskSpec.trace_context):
        string values only, so the frame stays schema-friendly."""
        return {"trace_id": self.trace_id, "span_id": self.span_id,
                "sampled": "1" if self.sampled else "0"}

    @classmethod
    def from_dict(cls, d: Optional[Dict[str, str]]
                  ) -> Optional["SpanContext"]:
        if not d:
            return None
        return cls(d["trace_id"], d["span_id"],
                   str(d.get("sampled", "1")) not in ("0", "False",
                                                      "false"))


@dataclass
class Span:
    name: str
    trace_id: str
    span_id: str
    parent_id: Optional[str]
    start_time: float
    end_time: Optional[float] = None
    attributes: Dict[str, Any] = field(default_factory=dict)
    events: List[Dict[str, Any]] = field(default_factory=list)
    status: str = "OK"
    sampled: bool = True

    def set_attribute(self, key: str, value: Any) -> None:
        self.attributes[key] = value

    def add_event(self, name: str, attributes: Optional[dict] = None
                  ) -> None:
        self.events.append({"name": name, "time": time.time(),
                            "attributes": attributes or {}})

    def context(self) -> SpanContext:
        return SpanContext(self.trace_id, self.span_id, self.sampled)

    def to_dict(self) -> Dict[str, Any]:
        return {
            "name": self.name, "trace_id": self.trace_id,
            "span_id": self.span_id, "parent_id": self.parent_id,
            "start_time": self.start_time, "end_time": self.end_time,
            "duration_ms": None if self.end_time is None
            else (self.end_time - self.start_time) * 1e3,
            "attributes": self.attributes, "events": self.events,
            "status": self.status,
        }


@contextmanager
def maybe_span(name_fn, parent=None, attributes_fn=None, on_span=None):
    """No-op context when tracing is off; otherwise opens a span.

    ``name_fn``/``attributes_fn`` are thunks so hot paths don't pay
    f-string/hex construction for disabled tracing; ``on_span`` (if
    given) receives the live span — call sites use it to stamp
    spec.trace_context."""
    if not _enabled:
        yield None
        return
    with start_span(name_fn(),
                    parent=parent,
                    attributes=attributes_fn() if attributes_fn else None
                    ) as span:
        if span is not None and on_span is not None:
            on_span(span)
        yield span


# ----------------------------------------------------------------- control
def enabled() -> bool:
    """Hot-path guard: callers skip span construction entirely when off."""
    return _enabled


def setup_tracing(exporter: Optional[Callable[[Span], None]] = None) -> None:
    """Enable tracing (reference: _tracing_startup_hook). Idempotent;
    extra exporters accumulate."""
    global _enabled
    _enabled = True
    if exporter is not None:
        with _lock:
            _exporters.append(exporter)


def shutdown_tracing() -> None:
    global _enabled, _dropped
    _enabled = False
    with _lock:
        _exporters.clear()
        _buffer.clear()
        _dropped = 0
    _state.current = None
    reset_sampling()


def is_tracing_enabled() -> bool:
    return _enabled


def get_buffered_spans() -> List[Span]:
    with _lock:
        return list(_buffer)


def get_dropped_spans() -> int:
    """Spans evicted from the bounded buffer since the last reset."""
    with _lock:
        return _dropped


# --------------------------------------------------------------- sampling
def _sample() -> bool:
    """Head-based sampling decision, made once per trace at the root.

    Seeded through fault_plane.derive_rng so a RAY_TPU_FAULT_PLAN seed
    replays the exact same sample set (raycheck RC03: no unseeded
    randomness on control paths)."""
    from ray_tpu_torch._private.config import Config
    rate = Config.instance().tracing_sample_rate
    if rate >= 1.0:
        return True
    if rate <= 0.0:
        return False
    global _sampler_rng
    with _lock:
        if _sampler_rng is None:
            from ray_tpu_torch.cluster import fault_plane
            _sampler_rng = fault_plane.derive_rng("tracing-sample")
        return _sampler_rng.random() < rate


def reset_sampling() -> None:
    """Drop the sampler RNG so the next decision re-derives it from the
    current fault-plane seed (tests replay decision sequences)."""
    global _sampler_rng
    with _lock:
        _sampler_rng = None


class JsonFileExporter:
    """Append finished spans to a JSON-lines file (reference:
    setup_local_tmp_tracing.py exports to a local tmp dir)."""

    def __init__(self, path: str):
        self.path = path
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self._lock = threading.Lock()

    def __call__(self, span: Span) -> None:
        with self._lock, open(self.path, "a") as f:
            f.write(json.dumps(span.to_dict(), default=str) + "\n")


# ------------------------------------------------------------------- spans
def current_context() -> Optional[SpanContext]:
    span = getattr(_state, "current", None)
    return span.context() if span is not None else None


@contextmanager
def start_span(name: str, parent: Optional[SpanContext] = None,
               attributes: Optional[dict] = None):
    """Yields a live Span (or None when tracing is off, so call sites can
    stay unconditional).

    A root span (no parent anywhere) draws the head-based sampling
    decision; children inherit it. Unsampled spans still flow through
    the thread-local so the negative decision propagates to the wire,
    but they are never buffered or exported."""
    if not _enabled:
        yield None
        return
    if parent is None:
        parent = current_context()
    if parent is not None:
        sampled = parent.sampled
    else:
        sampled = _sample()
    span = Span(
        name=name,
        trace_id=parent.trace_id if parent else os.urandom(16).hex(),
        span_id=os.urandom(8).hex(),
        parent_id=parent.span_id if parent else None,
        start_time=time.time(),
        attributes=dict(attributes or {}),
        sampled=sampled,
    )
    prev = getattr(_state, "current", None)
    _state.current = span
    try:
        yield span
    except BaseException as e:
        span.status = f"ERROR: {type(e).__name__}"
        raise
    finally:
        span.end_time = time.time()
        _state.current = prev
        if sampled:
            _export(span)


def record_remote_span(name: str, wire: Optional[Dict[str, str]],
                       start_time: float, end_time: float,
                       queue_wait_s: Optional[float] = None,
                       attributes: Optional[dict] = None,
                       status: str = "OK") -> Optional[Span]:
    """Record a server-side span parented to a wire ``_trace`` context.

    Server processes never call setup_tracing, so this bypasses the
    ``_enabled`` gate: any process touched by a *sampled* trace records
    its handler spans into the bounded buffer + flight recorder, which
    is what makes the merged cluster timeline possible. Returns the
    span (callers can stamp more attributes) or None when the wire
    context is absent/unsampled."""
    ctx = SpanContext.from_dict(wire)
    if ctx is None or not ctx.sampled:
        return None
    attrs = dict(attributes or {})
    if queue_wait_s is not None:
        attrs["queue_wait_ms"] = queue_wait_s * 1e3
    span = Span(
        name=name,
        trace_id=ctx.trace_id,
        span_id=os.urandom(8).hex(),
        parent_id=ctx.span_id,
        start_time=start_time,
        end_time=end_time,
        attributes=attrs,
        status=status,
    )
    _export(span)
    return span


def record_span_tree(root_name: str, wall_start: float,
                     children, attributes: Optional[dict] = None) -> None:
    """Record a completed root span plus sequential child spans from
    ``(name, duration_s)`` pairs — the scheduler tick anatomy: one
    ``scheduler.tick`` span whose children are the named phases laid
    end to end from ``wall_start``. No-op when tracing is off or the
    current trace is unsampled."""
    if not _enabled:
        return
    with start_span(root_name, attributes=attributes) as root:
        if root is None or not root.sampled:
            return
        root.start_time = wall_start
        t = wall_start
        for name, dur in children:
            child = Span(name=name, trace_id=root.trace_id,
                         span_id=os.urandom(8).hex(),
                         parent_id=root.span_id,
                         start_time=t, end_time=t + dur)
            t += dur
            _export(child)


def _export(span: Span) -> None:
    global _dropped
    with _lock:
        if len(_buffer) == _buffer.maxlen:
            _dropped += 1
        _buffer.append(span)
        exporters = list(_exporters)
    try:
        from ray_tpu_torch._private.config import Config
        if Config.instance().observability_plane_enabled:
            from ray_tpu_torch.observability import flight_recorder
            flight_recorder.global_recorder.record_span(span.to_dict())
    except Exception:
        pass
    for exp in exporters:
        try:
            exp(span)
        except Exception:
            pass
