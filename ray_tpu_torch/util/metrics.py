"""User-facing custom metrics API.

Reference: python/ray/util/metrics.py — applications define
Counter/Gauge/Histogram that flow into the same registry the system
metrics use and out through the Prometheus endpoint / dashboard. The
classes ARE the observability registry's metric types; this module is
the public alias the reference places them under.

    from ray_tpu_torch.util.metrics import Counter

    requests = Counter("app_requests", description="requests served",
                       tag_keys=("route",))
    requests.inc(tags={"route": "/predict"})
"""

from ray_tpu_torch.observability.metrics import (  # noqa: F401
    Counter,
    Gauge,
    Histogram,
)

__all__ = ["Counter", "Gauge", "Histogram"]
