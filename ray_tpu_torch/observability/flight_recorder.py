"""Per-process flight recorder: a bounded ring of recent spans/events.

Reference: Ray's per-worker profile-event buffer flushed to the GCS
profile table (core_worker/profiling.{h,cc}) and the ``ray timeline``
collector (python/ray/state.py chrome_tracing_dump). Here every process
keeps the *last N* spans and events in a bounded ring (a black box, not
a full log) and dumps them to JSONL when something goes wrong — on an
uncaught exception, on SIGUSR2, or on a FATAL event — so a crash
leaves behind the timeline that led up to it. The GCS `collect_timeline`
wire method pulls the same rings live from every node for
``cli.py timeline``.
"""

from __future__ import annotations

import json
import os
import signal
import sys
import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional, Tuple


class Ring:
    """Thread-safe bounded ring buffer that counts what it evicts.

    ``deque(maxlen=...)`` silently discards from the head on overflow;
    the ring keeps a ``dropped`` counter so dumps are honest about how
    much history was lost (raycheck RC10: no unbounded deques).
    """

    def __init__(self, capacity: int):
        self._dq: deque = deque(maxlen=max(1, int(capacity)))
        self._dropped = 0
        self._lock = threading.Lock()

    def append(self, item: Any) -> None:
        with self._lock:
            if len(self._dq) == self._dq.maxlen:
                self._dropped += 1
            self._dq.append(item)

    def snapshot(self) -> Tuple[List[Any], int]:
        with self._lock:
            return list(self._dq), self._dropped

    def clear(self) -> None:
        with self._lock:
            self._dq.clear()
            self._dropped = 0

    def __len__(self) -> int:
        with self._lock:
            return len(self._dq)

    @property
    def dropped(self) -> int:
        with self._lock:
            return self._dropped


class FlightRecorder:
    """Bounded recorder of recent spans + events with crash-dump hooks."""

    def __init__(self, capacity: Optional[int] = None):
        if capacity is None:
            from ray_tpu_torch._private.config import Config
            capacity = Config.instance().flight_recorder_capacity
        self._spans = Ring(capacity)
        self._events = Ring(capacity)
        self._clock_offset_s = 0.0
        self._installed = False
        self._prev_excepthook = None

    # ------------------------------------------------------------- feed
    def record_span(self, span: Dict[str, Any]) -> None:
        self._spans.append(span)

    def record_event(self, event: Dict[str, Any]) -> None:
        self._events.append(event)

    # ------------------------------------------------- clock correlation
    def set_clock_offset(self, offset_s: float) -> None:
        """GCS wall clock minus local wall clock, measured over the
        heartbeat RTT (raylet_server._heartbeat_loop); lets the
        timeline merger put every node on one clock."""
        self._clock_offset_s = float(offset_s)

    @property
    def clock_offset_s(self) -> float:
        return self._clock_offset_s

    # ------------------------------------------------------------- read
    def snapshot(self) -> Dict[str, Any]:
        spans, spans_dropped = self._spans.snapshot()
        events, events_dropped = self._events.snapshot()
        from ray_tpu_torch.cluster import fault_plane
        return {
            "pid": os.getpid(),
            "role": fault_plane.process_role(),
            "spans": spans,
            "events": events,
            "dropped": spans_dropped + events_dropped,
            "clock_offset_s": self._clock_offset_s,
            # raycheck: disable=RC02 — wall-clock timestamp for
            # cross-process correlation, not deadline arithmetic
            "wall_time": time.time(),
        }

    def clear(self) -> None:
        self._spans.clear()
        self._events.clear()

    # ------------------------------------------------------------- dump
    def dump(self, path: Optional[str] = None, reason: str = "manual"
             ) -> str:
        """Write the ring contents as JSON-lines; returns the path."""
        snap = self.snapshot()
        if path is None:
            path = os.path.join(
                os.environ.get("TMPDIR", "/tmp"),
                f"ray_tpu_flight_{snap['role']}_{snap['pid']}.jsonl")
        header = {
            "kind": "flight_recorder_dump", "reason": reason,
            "pid": snap["pid"], "role": snap["role"],
            "dropped": snap["dropped"],
            "clock_offset_s": snap["clock_offset_s"],
            "wall_time": snap["wall_time"],
        }
        with open(path, "w") as f:
            f.write(json.dumps(header, default=str) + "\n")
            for span in snap["spans"]:
                f.write(json.dumps({"kind": "span", **span}, default=str)
                        + "\n")
            for event in snap["events"]:
                f.write(json.dumps({"kind": "event", **event},
                                   default=str) + "\n")
        try:
            from ray_tpu_torch.observability import metrics
            metrics.flight_recorder_dumps.inc(
                tags={"reason": reason.split(":", 1)[0]})
        except Exception:
            pass
        return path

    # ------------------------------------------------------------ hooks
    def install(self) -> None:
        """Arm the crash hooks: SIGUSR2 → dump, uncaught exception →
        dump (chained to the previous excepthook). Idempotent; the
        signal handler only installs from the main thread."""
        if self._installed:
            return
        self._installed = True

        def _on_sigusr2(signum, frame):
            try:
                self.dump(reason="SIGUSR2")
            except Exception:
                pass

        try:
            signal.signal(signal.SIGUSR2, _on_sigusr2)
        except (ValueError, OSError):
            pass  # not the main thread / platform without SIGUSR2

        self._prev_excepthook = sys.excepthook

        def _on_uncaught(exc_type, exc, tb):
            try:
                self.dump(reason=f"uncaught:{exc_type.__name__}")
            except Exception:
                pass
            if self._prev_excepthook is not None:
                self._prev_excepthook(exc_type, exc, tb)

        sys.excepthook = _on_uncaught


def merge_chrome_trace(dumps: List[Dict[str, Any]]) -> Dict[str, Any]:
    """Merge per-node flight-recorder snapshots into one chrome://tracing
    document.

    Each dump carries ``clock_offset_s`` = GCS wall clock minus the
    node's local wall clock (measured over heartbeat RTT), so every
    span's timestamps are shifted onto the GCS reference clock before
    merging — one consistent time axis across the whole cluster.
    Unreachable nodes (dumps with an ``error`` key) become zero-length
    processes so the viewer still shows they were asked.
    """
    trace_events: List[Dict[str, Any]] = []
    for pid, dump in enumerate(dumps):
        node = str(dump.get("node_id", dump.get("role", "?")))[:16]
        role = dump.get("role", "?")
        label = (f"{node} [{role}] UNREACHABLE: {dump['error']}"
                 if "error" in dump else f"{node} [{role}]")
        trace_events.append({
            "ph": "M", "name": "process_name", "pid": pid, "tid": 0,
            "args": {"name": label},
        })
        # one named lane per live background thread, labelled by its
        # root function (threads.root_label) — the same naming
        # raycheck's RC16/RC17 data-race reports use, so a report and
        # a timeline lane identify a thread identically
        roots = dump.get("thread_roots") or {}
        for tid, tname in enumerate(sorted(roots), start=1):
            trace_events.append({
                "ph": "M", "name": "thread_name", "pid": pid,
                "tid": tid,
                "args": {"name": f"{tname} ({roots[tname]})"},
            })
        offset_us = float(dump.get("clock_offset_s") or 0.0) * 1e6
        for span in dump.get("spans") or []:
            start = span.get("start_time")
            if start is None:
                continue
            end = span.get("end_time") or start
            trace_events.append({
                "ph": "X", "name": span.get("name", "?"),
                "cat": span.get("status", "OK"),
                "pid": pid, "tid": 0,
                "ts": start * 1e6 + offset_us,
                "dur": max(0.0, (end - start) * 1e6),
                "args": {
                    "trace_id": span.get("trace_id"),
                    "span_id": span.get("span_id"),
                    "parent_id": span.get("parent_id"),
                    **(span.get("attributes") or {}),
                },
            })
        for event in dump.get("events") or []:
            ts = event.get("timestamp", event.get("time"))
            if ts is None:
                continue
            trace_events.append({
                "ph": "i", "name": event.get("name",
                                             event.get("kind", "event")),
                "pid": pid, "tid": 0, "s": "p",
                "ts": float(ts) * 1e6 + offset_us,
                "args": {k: v for k, v in event.items()
                         if k not in ("name", "timestamp", "time")},
            })
    return {"traceEvents": trace_events,
            "displayTimeUnit": "ms",
            "metadata": {"nodes": len(dumps)}}


global_recorder = FlightRecorder()


def install() -> None:
    """Arm the process's crash-dump hooks when the plane is enabled
    (called from gcs_server/raylet_server main() and Runtime init)."""
    from ray_tpu_torch._private.config import Config
    if Config.instance().observability_plane_enabled:
        global_recorder.install()


def record_fatal(event: Dict[str, Any]) -> None:
    """FATAL-severity hook (observability.events.emit): record the
    event, then dump the black box while the process can still write."""
    global_recorder.record_event(event)
    try:
        global_recorder.dump(reason="fatal_event")
    except Exception:
        pass
