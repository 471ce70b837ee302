"""LoadMetrics — the autoscaler's view of cluster load.

Reference: python/ray/autoscaler/_private/load_metrics.py: per-node
used/total resources, queued (pending + infeasible) resource demands,
and pending placement-group bundle demands; plus last-busy timestamps
for idle-node detection.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional, Tuple


class LoadMetrics:
    def __init__(self):
        self.node_resources: Dict[str, Tuple[Dict[str, float],
                                             Dict[str, float]]] = {}
        self.pending_demands: List[Dict[str, float]] = []
        self.pending_pg_demands: List[List[Dict[str, float]]] = []
        self.last_used_time: Dict[str, float] = {}

    def update_from_runtime(self, runtime) -> None:
        """Poll the in-process cluster the way the reference monitor polls
        GCS resource reports (gcs_resource_report_poller.cc)."""
        now = time.time()
        self.pending_demands = []
        self.node_resources = {}
        for raylet in runtime.cluster_state.alive_raylets():
            ids = runtime.cluster_state.ids
            total = raylet.local_resources.to_map(ids)
            avail = raylet.local_resources.to_map(ids, available=True)
            key = raylet.node_id.hex()
            self.node_resources[key] = (total, avail)
            busy = False
            with raylet._lock:
                queued = list(raylet._pending) + list(raylet._infeasible)
                if raylet._running or raylet._dispatch_len or queued:
                    busy = True
                for task in queued:
                    self.pending_demands.append(dict(task.spec.resources))
            if busy or key not in self.last_used_time:
                self.last_used_time[key] = now
            # partially-used nodes also count as busy
            if any(avail.get(k, 0) < v for k, v in total.items()
                   if k in ("CPU", "GPU", "TPU")):
                self.last_used_time[key] = now
        self.pending_pg_demands = []
        pgm = getattr(runtime, "pg_manager", None)
        if pgm is not None:
            for pg in pgm.pending_pgs():
                self.pending_pg_demands.append(
                    [dict(b) for b in pg.bundles])

    def update_from_gcs(self, gcs_address: str) -> None:
        """Poll a PROCESS-backed cluster: node resources come from the
        GCS cluster view, per-demand task queues from each raylet
        process's node_stats (the queued_demands field — the process-
        tier equivalent of resource_load_by_shape in the reference's
        raylet resource reports): raylet-process demand drives
        LoadMetrics directly."""
        from ray_tpu_torch.cluster.rpc import (
            RpcClient,
            RpcConnectionError,
            ReconnectingRpcClient,
        )

        if getattr(self, "_gcs_client", None) is None or \
                getattr(self, "_gcs_address", None) != gcs_address:
            self.close()
            self._gcs_address = gcs_address
            self._gcs_client = ReconnectingRpcClient(gcs_address)
            self._raylet_clients: Dict[str, RpcClient] = {}
        now = time.time()
        view = self._gcs_client.call("cluster_view", timeout=10.0)
        self.pending_demands = []
        self.node_resources = {}
        for node_id, info in view["nodes"].items():
            if not info["alive"]:
                stale = self._raylet_clients.pop(node_id, None)
                if stale is not None:
                    stale.close()  # else its reader thread + fd leak
                continue
            if info.get("state") == "DRAINING":
                # capacity on its way out (drain / preemption notice):
                # report none of it, so the demand scheduler plans the
                # replacement while the node winds down, and the idle
                # scan never double-terminates it
                self.last_used_time.pop(node_id, None)
                continue
            total = dict(info["resources"])
            avail = dict(info["available"])
            self.node_resources[node_id] = (total, avail)
            busy = False
            try:
                client = self._raylet_clients.get(node_id)
                if client is None or client.closed:
                    client = RpcClient(info["address"])
                    self._raylet_clients[node_id] = client
                stats = client.call("node_stats", timeout=10.0)
                self.pending_demands.extend(
                    stats.get("queued_demands", []))
                busy = bool(stats.get("queued") or stats.get("running")
                            or stats.get("actors"))
            except (RpcConnectionError, TimeoutError, OSError):
                pass  # node died between view and stats: next tick
            if any(avail.get(k, 0) < v for k, v in total.items()
                   if k in ("CPU", "GPU", "TPU")):
                busy = True
            if busy or node_id not in self.last_used_time:
                self.last_used_time[node_id] = now
        try:
            reply = self._gcs_client.call("pg_pending", timeout=10.0)
            self.pending_pg_demands = reply.get("pending", [])
        except Exception:
            self.pending_pg_demands = []

    def close(self) -> None:
        """Release the polling clients (the monitor loop is long-lived;
        without this, dead-node churn accumulates sockets + reader
        threads)."""
        for client in getattr(self, "_raylet_clients", {}).values():
            try:
                client.close()
            except Exception:
                pass
        self._raylet_clients = {}
        gcs = getattr(self, "_gcs_client", None)
        if gcs is not None:
            try:
                gcs.close()
            except Exception:
                pass
            self._gcs_client = None

    def idle_nodes(self, idle_timeout_s: float) -> List[str]:
        now = time.time()
        return [nid for nid, t in self.last_used_time.items()
                if nid in self.node_resources
                and now - t > idle_timeout_s]

    def summary(self) -> str:
        lines = [f"{len(self.node_resources)} nodes"]
        for nid, (total, avail) in self.node_resources.items():
            lines.append(f"  {nid[:8]}: avail={avail} total={total}")
        lines.append(f"pending demands: {len(self.pending_demands)}")
        return "\n".join(lines)
