"""Dashboard-lite — the REST surface of the reference dashboard.

Reference: dashboard/head.py + modules/snapshot (REST API over GCS
state) + the metrics exporter. Serves JSON state endpoints and the
Prometheus text endpoint from one stdlib HTTP server:

    /api/cluster_status   nodes + resources
    /api/nodes            node table
    /api/actors           actor table
    /api/placement_groups PG table
    /api/objects          ownership/object table
    /api/events           structured event log
    /metrics              Prometheus exposition
"""

from __future__ import annotations

import json
from typing import Optional, Tuple


class Dashboard:
    def __init__(self, host: str = "127.0.0.1", port: int = 0):
        from ray_tpu_torch.observability.http_util import start_json_server

        routes = {path: (lambda fn: lambda query: fn())(fn)
                  for path, fn in self._routes().items()}
        self._server = start_json_server(routes, host, port)
        self.port = self._server.server_address[1]

    @property
    def url(self) -> str:
        return f"http://127.0.0.1:{self.port}"

    def stop(self) -> None:
        self._server.shutdown()
        self._server.server_close()

    def _routes(self):
        def as_json(fn):
            def inner() -> Tuple[bytes, str]:
                return (json.dumps(fn(), default=str).encode(),
                        "application/json")

            return inner

        def state():
            from ray_tpu_torch.gcs import state as gcs_state

            return gcs_state

        def metrics() -> Tuple[bytes, str]:
            from ray_tpu_torch.observability.metrics import prometheus_text

            return prometheus_text().encode(), "text/plain; version=0.0.4"

        def events():
            from ray_tpu_torch.observability.events import global_event_log

            return global_event_log.list()

        return {
            "/api/cluster_status": as_json(lambda: {
                "nodes": state().node_table(),
                "cluster_resources": state().cluster_resources(),
                "available_resources": state().available_resources(),
            }),
            "/api/nodes": as_json(lambda: state().node_table()),
            "/api/actors": as_json(lambda: state().actor_table()),
            "/api/placement_groups": as_json(
                lambda: state().placement_group_table()),
            "/api/objects": as_json(lambda: state().object_table()),
            "/api/events": as_json(events),
            "/metrics": metrics,
        }


def start_dashboard(host: str = "127.0.0.1", port: int = 0) -> Dashboard:
    return Dashboard(host, port)
