"""Structured cluster events (reference: src/ray/util/event.{h,cc} +
dashboard/modules/event/): severity-labeled JSON records appended to a
per-process buffer and optionally a JSONL file, consumed by the
dashboard-lite state dump.
"""

from __future__ import annotations

import json
import os
import threading
import time
from collections import deque
from enum import Enum
from typing import Any, Deque, Dict, List, Optional


class Severity(str, Enum):
    DEBUG = "DEBUG"
    INFO = "INFO"
    WARNING = "WARNING"
    ERROR = "ERROR"
    FATAL = "FATAL"


class EventLog:
    def __init__(self, max_events: int = 10_000,
                 file_path: Optional[str] = None):
        self._events: Deque[Dict[str, Any]] = deque(maxlen=max_events)
        self._lock = threading.Lock()
        self._file_path = file_path
        self._counter = 0

    def emit(self, label: str, message: str,
             severity: Severity = Severity.INFO,
             **fields: Any) -> Dict[str, Any]:
        with self._lock:
            self._counter += 1
            event = {
                "event_id": self._counter,
                "timestamp": time.time(),
                "severity": str(severity.value
                                if isinstance(severity, Severity)
                                else severity),
                "label": label,
                "message": message,
                "pid": os.getpid(),
                **fields,
            }
            self._events.append(event)
            if self._file_path:
                with open(self._file_path, "a") as f:
                    f.write(json.dumps(event) + "\n")
        if event["severity"] == "FATAL":
            # A typed fatal error dumps the flight recorder while the
            # process can still write (outside self._lock: the recorder
            # has its own locking and may touch metrics/config).
            try:
                from ray_tpu_torch.observability import flight_recorder
                flight_recorder.record_fatal(event)
            except Exception:
                pass
        return event

    def list(self, label: Optional[str] = None,
             min_severity: Optional[Severity] = None
             ) -> List[Dict[str, Any]]:
        order = ["DEBUG", "INFO", "WARNING", "ERROR", "FATAL"]
        with self._lock:
            events = list(self._events)
        if label is not None:
            events = [e for e in events if e["label"] == label]
        if min_severity is not None:
            threshold = order.index(min_severity.value)
            events = [e for e in events
                      if order.index(e["severity"]) >= threshold]
        return events

    def clear(self) -> None:
        with self._lock:
            self._events.clear()


global_event_log = EventLog()


def emit(label: str, message: str, severity: Severity = Severity.INFO,
         **fields: Any) -> Dict[str, Any]:
    return global_event_log.emit(label, message, severity, **fields)
