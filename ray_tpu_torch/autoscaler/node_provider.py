"""NodeProvider plugin API + the fake in-process provider.

Reference: python/ray/autoscaler/node_provider.py (the cloud plugin
surface) and autoscaler/_private/fake_multi_node/node_provider.py:225
(FakeMultiNodeProvider — "launches" nodes into the local cluster so the
full reconcile loop runs without a cloud).
"""

from __future__ import annotations

import threading
import uuid
from typing import Any, Dict, List, Optional

TAG_NODE_KIND = "ray-node-kind"
TAG_USER_NODE_TYPE = "ray-user-node-type"
TAG_NODE_STATUS = "ray-node-status"
NODE_KIND_HEAD = "head"
NODE_KIND_WORKER = "worker"
STATUS_UP_TO_DATE = "up-to-date"


class NodeProvider:
    """Cloud plugin interface (subset the autoscaler core needs)."""

    def __init__(self, provider_config: Dict[str, Any], cluster_name: str):
        self.provider_config = provider_config
        self.cluster_name = cluster_name

    def non_terminated_nodes(self, tag_filters: Dict[str, str]) -> List[str]:
        raise NotImplementedError

    def is_running(self, node_id: str) -> bool:
        raise NotImplementedError

    def node_tags(self, node_id: str) -> Dict[str, str]:
        raise NotImplementedError

    def internal_ip(self, node_id: str) -> str:
        raise NotImplementedError

    def create_node(self, node_config: Dict[str, Any],
                    tags: Dict[str, str], count: int) -> None:
        raise NotImplementedError

    def terminate_node(self, node_id: str) -> None:
        raise NotImplementedError


class FakeMultiNodeProvider(NodeProvider):
    """Launches "nodes" straight into the in-process runtime: create_node
    calls runtime.add_node with the node type's resources; terminate_node
    removes the raylet (which exercises actor restart / object loss the
    same way a real node death does)."""

    def __init__(self, provider_config: Dict[str, Any],
                 cluster_name: str = "fake", runtime=None):
        super().__init__(provider_config, cluster_name)
        from ray_tpu_torch.core import runtime as rt_mod

        self._runtime = runtime or rt_mod.global_runtime
        if self._runtime is None:
            raise RuntimeError("FakeMultiNodeProvider needs ray_tpu_torch.init()")
        self._lock = threading.Lock()
        # provider node id -> (tags, raylet NodeID)
        self._nodes: Dict[str, Dict[str, Any]] = {}
        head_id = f"fake-head-{uuid.uuid4().hex[:8]}"
        self._nodes[head_id] = {
            "tags": {TAG_NODE_KIND: NODE_KIND_HEAD,
                     TAG_NODE_STATUS: STATUS_UP_TO_DATE,
                     TAG_USER_NODE_TYPE: provider_config.get(
                         "head_node_type", "head")},
            "node_id": self._runtime.head_raylet.node_id,
        }

    def non_terminated_nodes(self, tag_filters: Dict[str, str]) -> List[str]:
        with self._lock:
            out = []
            for nid, info in self._nodes.items():
                if all(info["tags"].get(k) == v
                       for k, v in tag_filters.items()):
                    out.append(nid)
            return out

    def is_running(self, node_id: str) -> bool:
        with self._lock:
            return node_id in self._nodes

    def node_tags(self, node_id: str) -> Dict[str, str]:
        with self._lock:
            return dict(self._nodes[node_id]["tags"])

    def internal_ip(self, node_id: str) -> str:
        return node_id

    def raylet_node_id(self, node_id: str):
        with self._lock:
            return self._nodes[node_id]["node_id"]

    def create_node(self, node_config: Dict[str, Any],
                    tags: Dict[str, str], count: int) -> None:
        resources = dict(node_config.get("resources", {"CPU": 1}))
        for _ in range(count):
            raylet = self._runtime.add_node(dict(resources))
            nid = f"fake-{uuid.uuid4().hex[:8]}"
            with self._lock:
                self._nodes[nid] = {
                    "tags": {**tags, TAG_NODE_STATUS: STATUS_UP_TO_DATE},
                    "node_id": raylet.node_id,
                }

    def terminate_node(self, node_id: str) -> None:
        with self._lock:
            info = self._nodes.pop(node_id, None)
        if info is not None and info["tags"].get(
                TAG_NODE_KIND) != NODE_KIND_HEAD:
            self._runtime.remove_node(info["node_id"])


class ClusterNodeProvider(NodeProvider):
    """Backs the autoscaler with a live ProcessCluster: create_node spawns
    a real raylet process, terminate_node drains it through the GCS before
    stopping it (ProcessCluster.remove_node), and externally-killed nodes
    (preemption storms) fall out of non_terminated_nodes on the next poll
    so the reconcile loop replaces the lost capacity.

    Provider node ids ARE raylet node ids — raylet_node_id is the
    identity, and exposing ``gcs_address`` routes
    StandardAutoscaler.update through LoadMetrics.update_from_gcs (demand
    from real raylet queues, capacity from heartbeat-fed cluster_view).
    """

    def __init__(self, provider_config: Dict[str, Any],
                 cluster_name: str = "process", cluster=None):
        super().__init__(provider_config, cluster_name)
        if cluster is None:
            raise ValueError("ClusterNodeProvider needs a ProcessCluster")
        self._cluster = cluster
        self._lock = threading.Lock()
        self._default_type = provider_config.get("worker_node_type",
                                                 "worker")
        self._tags: Dict[str, Dict[str, str]] = {}
        self._reconcile()

    @property
    def gcs_address(self) -> str:
        return self._cluster.gcs_address

    def _reconcile(self) -> None:
        """Sync the tag table with the cluster's real process set: adopt
        raylets launched outside the provider, drop ones whose process is
        gone (preempted / hard-killed / drained away)."""
        with self._lock:
            procs = dict(self._cluster.raylets)
            for node_id in list(self._tags):
                proc = procs.get(node_id)
                if proc is None or proc.poll() is not None:
                    del self._tags[node_id]
            for node_id, proc in procs.items():
                if proc.poll() is None and node_id not in self._tags:
                    self._tags[node_id] = {
                        TAG_NODE_KIND: NODE_KIND_WORKER,
                        TAG_NODE_STATUS: STATUS_UP_TO_DATE,
                        TAG_USER_NODE_TYPE: self._default_type,
                    }

    def non_terminated_nodes(self, tag_filters: Dict[str, str]) -> List[str]:
        self._reconcile()
        with self._lock:
            return [nid for nid, tags in self._tags.items()
                    if all(tags.get(k) == v for k, v in tag_filters.items())]

    def is_running(self, node_id: str) -> bool:
        proc = self._cluster.raylets.get(node_id)
        return proc is not None and proc.poll() is None

    def node_tags(self, node_id: str) -> Dict[str, str]:
        with self._lock:
            return dict(self._tags.get(node_id, {}))

    def internal_ip(self, node_id: str) -> str:
        return self._cluster.node_addresses.get(node_id, node_id)

    def raylet_node_id(self, node_id: str) -> str:
        return node_id  # provider ids are raylet ids

    def create_node(self, node_config: Dict[str, Any],
                    tags: Dict[str, str], count: int) -> None:
        resources = dict(node_config.get("resources", {"CPU": 1}))
        num_cpus = float(resources.get("CPU", 1.0))
        for _ in range(count):
            node_id = self._cluster.add_node(num_cpus=num_cpus,
                                             resources=dict(resources))
            with self._lock:
                self._tags[node_id] = {
                    **tags, TAG_NODE_STATUS: STATUS_UP_TO_DATE}

    def terminate_node(self, node_id: str) -> None:
        with self._lock:
            info = self._tags.pop(node_id, None)
        if info is not None and info.get(TAG_NODE_KIND) != NODE_KIND_HEAD:
            # graceful path: GCS drain (actors migrate, sole-copy objects
            # re-replicate) before the process stops
            self._cluster.remove_node(node_id)
