"""ray_tpu_torch.observability — metrics, events, profiling.

Reference surface: src/ray/stats/ (metric registry), src/ray/util/event
(structured events), core_worker/profiling + ``ray timeline``.
"""

from ray_tpu_torch.observability.events import (  # noqa: F401
    EventLog,
    Severity,
    emit,
    global_event_log,
)
from ray_tpu_torch.observability.metrics import (  # noqa: F401
    Counter,
    Gauge,
    Histogram,
    get_metric,
    prometheus_text,
    start_metrics_server,
)
from ray_tpu_torch.observability.dashboard_head import DashboardHead  # noqa: F401
from ray_tpu_torch.observability.flight_recorder import (  # noqa: F401
    FlightRecorder,
    Ring,
    global_recorder,
)
from ray_tpu_torch.observability.profiling import (  # noqa: F401
    Profiler,
    global_profiler,
    profile,
    timeline,
)

__all__ = [
    "Counter", "Gauge", "Histogram", "get_metric", "prometheus_text",
    "start_metrics_server", "EventLog", "Severity", "emit",
    "DashboardHead", "FlightRecorder", "Ring", "global_recorder",
    "global_event_log", "Profiler", "global_profiler", "profile",
    "timeline",
]
