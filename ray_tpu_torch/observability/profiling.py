"""Profile events → Chrome trace timeline.

Reference: core_worker/profiling.{h,cc} buffers span events per worker,
flushed to the GCS profile table; ``ray timeline`` (python/ray/state.py:
239 profile_table → chrome_tracing_dump) renders chrome://tracing JSON.
Here spans go to a process-global *bounded* ring (long-running raylets
and workers must not grow without limit — raycheck RC10); evicted
events are counted, not silently lost. ``timeline()`` dumps the same
Chrome trace-event format.
"""

from __future__ import annotations

import json
import os
import threading
import time
from contextlib import contextmanager
from typing import Any, Dict, List, Optional

from ray_tpu_torch.observability.flight_recorder import Ring

# Plenty for a timeline window; a busy raylet wraps in minutes, which is
# exactly the flight-recorder contract: keep the recent past, not a log.
_MAX_EVENTS = 65_536


def _enabled() -> bool:
    """``Config.enable_timeline`` master switch (reference:
    RAY_PROFILING): off means spans cost one boolean read and the ring
    stays empty — ``timeline()`` then renders an empty trace."""
    from ray_tpu_torch._private.config import Config

    return Config.instance().enable_timeline


class Profiler:
    def __init__(self, max_events: int = _MAX_EVENTS):
        self._events = Ring(max_events)

    @contextmanager
    def profile(self, event_type: str, extra_data: Optional[dict] = None):
        if not _enabled():
            yield
            return
        start = time.perf_counter()
        wall_start = time.time()
        try:
            yield
        finally:
            dur_us = (time.perf_counter() - start) * 1e6
            self._events.append({
                "cat": event_type,
                "name": event_type,
                "ph": "X",                      # complete event
                "ts": wall_start * 1e6,         # microseconds
                "dur": dur_us,
                "pid": os.getpid(),
                "tid": threading.get_ident() % 100_000,
                "args": extra_data or {},
            })

    def add_instant(self, name: str, extra_data: Optional[dict] = None
                    ) -> None:
        if not _enabled():
            return
        self._events.append({
            "cat": "instant", "name": name, "ph": "i",
            "ts": time.time() * 1e6, "s": "g",
            "pid": os.getpid(),
            "tid": threading.get_ident() % 100_000,
            "args": extra_data or {},
        })

    def events(self) -> List[Dict[str, Any]]:
        events, _ = self._events.snapshot()
        return events

    @property
    def dropped(self) -> int:
        """Events evicted from the ring since the last clear()."""
        return self._events.dropped

    def clear(self) -> None:
        self._events.clear()

    def chrome_trace(self) -> List[Dict[str, Any]]:
        return self.events()

    def dump(self, filename: str) -> str:
        with open(filename, "w") as f:
            json.dump(self.chrome_trace(), f)
        return filename


global_profiler = Profiler()


def profile(event_type: str, extra_data: Optional[dict] = None):
    """``with profile("task:execute"):`` — the reference's
    worker.profile() surface (_raylet.pyx:1478)."""
    return global_profiler.profile(event_type, extra_data)


def timeline(filename: Optional[str] = None):
    """``ray timeline`` equivalent: Chrome trace JSON (list) or file."""
    if filename is None:
        return global_profiler.chrome_trace()
    return global_profiler.dump(filename)
