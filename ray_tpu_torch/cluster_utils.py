"""Multi-node test cluster on one host.

Mirrors the reference's python/ray/cluster_utils.py:101 ``Cluster``
(add_node:170, remove_node:244): nodes share one control plane; killing a
node exercises failure detection, actor restart and object recovery. The
in-process implementation backs each node with a thread-pool raylet; the
multiprocess runtime substitutes OS-process nodes behind the same API.
"""

from __future__ import annotations

from typing import Dict, List, Optional

from ray_tpu_torch.core import runtime as rt_mod
from ray_tpu_torch.core.raylet import Raylet


class Cluster:
    def __init__(self, initialize_head: bool = True,
                 head_node_args: Optional[dict] = None):
        self.head_node: Optional[Raylet] = None
        self.worker_nodes: List[Raylet] = []
        self._rt = None
        if initialize_head:
            self.add_node(**(head_node_args or {}))

    def add_node(self, num_cpus: float = 1, num_gpus: float = 0,
                 resources: Optional[Dict[str, float]] = None,
                 object_store_memory: Optional[int] = None, **kwargs
                 ) -> Raylet:
        if self._rt is None:
            from ray_tpu_torch.core.api import init

            # the head brings the runtime up: ``device`` (where its
            # placement solve runs, CUDA unless given) and
            # ``_system_config`` apply to the head only
            self._rt = init(num_cpus=num_cpus, num_gpus=num_gpus,
                            resources=resources,
                            object_store_memory=object_store_memory,
                            device=kwargs.get("device"),
                            _system_config=kwargs.get("_system_config"))
            self.head_node = self._rt.head_raylet
            return self.head_node
        node_resources = dict(resources or {})
        node_resources.setdefault("CPU", num_cpus)
        if num_gpus:
            node_resources["GPU"] = num_gpus
        node = self._rt.add_node(node_resources)
        self.worker_nodes.append(node)
        return node

    def remove_node(self, node: Raylet) -> None:
        if self._rt is None:
            return
        self._rt.remove_node(node.node_id)
        if node in self.worker_nodes:
            self.worker_nodes.remove(node)

    def drain_node(self, node: Raylet,
                   deadline_s: Optional[float] = None) -> None:
        """Graceful removal (drain plane): placement excludes the node
        immediately, in-flight work gets the drain deadline to finish,
        then the node is removed (reference: the autoscaler's
        drain-before-terminate path)."""
        if self._rt is None:
            return
        self._rt.drain_node(node.node_id, deadline_s=deadline_s)
        if node in self.worker_nodes:
            self.worker_nodes.remove(node)

    def wait_for_nodes(self, timeout: float = 10.0) -> None:
        pass  # in-process nodes register synchronously

    @property
    def address(self) -> str:
        return "local"

    def shutdown(self) -> None:
        from ray_tpu_torch.core.api import shutdown

        shutdown()
        self._rt = None
