"""Process-tier dashboard head.

Reference: dashboard/head.py aggregating per-node agents
(dashboard/agent.py) — here each raylet process doubles as its node's
agent (`node_stats` carries reporter-style process stats), and the head
is an HTTP server over the GCS view, per-node agent polls, the actor
table, and a ring buffer of the pubsub LOG channel.

Routes (JSON):
  /             — single-page web UI (text/html; observability/web_ui.py)
  /api/cluster  — GCS cluster view
  /api/nodes    — per-node stats incl. agent process stats
  /api/actors   — GCS actor table
  /api/logs     — recent worker log lines (?n= to bound)
  /api/jobs     — job submission table
  /healthz      — liveness probe
"""

from __future__ import annotations

import json
import logging
import threading
from collections import deque
from typing import Dict, Optional

logger = logging.getLogger(__name__)


class DashboardHead:
    def __init__(self, gcs_address: str, host: str = "127.0.0.1",
                 port: int = 0, log_buffer: int = 5000):
        from ray_tpu_torch.cluster.rpc import ReconnectingRpcClient
        from ray_tpu_torch.observability.http_util import start_json_server

        self.gcs_address = gcs_address
        self._gcs = ReconnectingRpcClient(gcs_address)
        self._raylet_clients: Dict[str, object] = {}
        self._raylet_lock = threading.Lock()
        self._logs: deque = deque(maxlen=log_buffer)
        self._subscriber = None

        def as_json(fn):
            return lambda query: (json.dumps(fn(query)).encode(),
                                  "application/json")

        from ray_tpu_torch.observability.web_ui import INDEX_HTML

        routes = {
            "/": lambda q: (INDEX_HTML.encode(), "text/html"),
            "/healthz": as_json(lambda q: {"ok": True}),
            "/api/cluster": as_json(
                lambda q: self._gcs.call("cluster_view", timeout=10.0)),
            "/api/nodes": as_json(lambda q: self._nodes()),
            "/api/actors": as_json(
                lambda q: self._gcs.call("actor_list", timeout=10.0)),
            "/api/logs": as_json(self._recent_logs),
            "/api/jobs": as_json(lambda q: self._jobs()),
        }
        # bind the HTTP server BEFORE subscribing: a bind failure must
        # not leak a live poll thread with no handle to stop it
        self._server = start_json_server(routes, host, port)
        self.host, self.port = self._server.server_address
        try:
            self._start_log_subscriber()
        except Exception:
            self._server.shutdown()
            self._server.server_close()
            raise

    # ------------------------------------------------------------- plumbing
    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}"

    def _start_log_subscriber(self) -> None:
        from ray_tpu_torch.pubsub import LOG_CHANNEL, Subscriber

        def on_log(channel, node_id, message):
            for entry in message.get("batch", ()):
                self._logs.append({"node_id": node_id, **entry})

        self._subscriber = Subscriber(
            f"dashboard-{id(self):x}",
            poll_fn=lambda subscriber_id, timeout: self._gcs.call(
                "pubsub_poll", subscriber_id=subscriber_id,
                timeout_s=timeout, timeout=timeout + 10.0),
            subscribe_fn=lambda **kw: self._gcs.call(
                "pubsub_subscribe", timeout=10.0, **kw),
            unsubscribe_fn=lambda **kw: self._gcs.call(
                "pubsub_unsubscribe", timeout=10.0, **kw),
            poll_timeout_s=2.0)
        self._subscriber.subscribe(LOG_CHANNEL, None, on_log)

    def _raylet(self, address: str):
        from ray_tpu_torch.cluster.rpc import RpcClient

        with self._raylet_lock:
            c = self._raylet_clients.get(address)
            if c is None or c.closed:
                c = RpcClient(address)
                self._raylet_clients[address] = c
            return c

    # --------------------------------------------------------------- routes
    def _jobs(self) -> list:
        """Submitted jobs from the GCS KV (reference: dashboard job
        module listing)."""
        from ray_tpu_torch.cluster.job_manager import JOB_NS, list_job_rows

        return list_job_rows(
            lambda prefix: self._gcs.call("kv_keys", ns=JOB_NS,
                                          prefix=prefix, timeout=10.0),
            lambda key: self._gcs.call("kv_get", ns=JOB_NS, key=key,
                                       timeout=10.0))

    def _recent_logs(self, query: Dict) -> list:
        n = int(query.get("n", ["100"])[0])
        return list(self._logs)[-n:] if n > 0 else []

    def _nodes(self) -> list:
        view = self._gcs.call("cluster_view", timeout=10.0)
        rows = []
        calls = []
        for node_id, info in view["nodes"].items():
            row = {"node_id": node_id, "alive": info["alive"],
                   "address": info["address"]}
            call = None
            if info["alive"]:
                try:
                    # fan the polls out; one wedged node must cost the
                    # endpoint max(latency), not sum (reference:
                    # dashboard head polls agents concurrently)
                    call = self._raylet(info["address"]).call_async(
                        "node_stats")
                except Exception as e:  # noqa: BLE001 — node mid-death
                    row["stats_error"] = repr(e)
            rows.append(row)
            calls.append(call)
        for row, call in zip(rows, calls):
            if call is None:
                continue
            try:
                row.update(call.result(timeout=10.0))
            except Exception as e:  # noqa: BLE001
                row["stats_error"] = repr(e)
        return rows

    def stop(self) -> None:
        if self._subscriber is not None:
            self._subscriber.close()
        try:
            self._server.shutdown()
            self._server.server_close()
        except Exception:
            pass
        self._gcs.close()
        with self._raylet_lock:
            clients = list(self._raylet_clients.values())
        for c in clients:
            c.close()


def main(argv=None) -> None:
    import argparse

    parser = argparse.ArgumentParser()
    parser.add_argument("--gcs", required=True)
    parser.add_argument("--host", default="127.0.0.1")
    parser.add_argument("--port", type=int, default=0)
    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    head = DashboardHead(args.gcs, args.host, args.port)
    print(f"DASHBOARD_URL {head.url}", flush=True)
    threading.Event().wait()


if __name__ == "__main__":
    main()
