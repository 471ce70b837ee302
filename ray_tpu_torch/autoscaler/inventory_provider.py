"""Inventory node provider: a fixed fleet of SSH-reachable machines.

Reference shape: python/ray/autoscaler/_private/local/node_provider.py
(the "local" provider — a list of machines instead of a cloud API)
composed with command_runner.py (exec over ssh) and updater.py (node
bootstrap). ``ray up`` against an inventory claims a free machine per
node, bootstraps it through a NodeUpdater (initialization / setup
commands, file mounts), and starts a raylet on it detached; the
raylet's announce line is polled out of a remote log file, so the
whole flow works identically over ssh and on local machines.

provider config keys:
  machines        [{"host": ..., "user": ..., "port": ..., "ssh_key":
                   ..., "local": true}] — "local": true runs commands
                   as local shells (LocalCommandRunner); otherwise an
                   SSHCommandRunner speaks to the host
  gcs_address     optional external control plane; when absent a GCS
                   server process is spawned (the head's control plane)
  gcs_device      the spawned GCS's solve device: absent means CUDA,
                   "cpu" asks for the CPU (ProcessCluster's gcs_device)
  initialization_commands / setup_commands   run on every node before
                   the raylet starts (reference cluster-config keys)
  file_mounts     {target: source} synced before setup
"""

from __future__ import annotations

import json
import logging
import threading
import time
import uuid
from typing import Any, Dict, List, Optional

from ray_tpu_torch.autoscaler.command_runner import (
    LocalCommandRunner,
    SSHCommandRunner,
)
from ray_tpu_torch.autoscaler.node_provider import (
    NODE_KIND_HEAD,
    NODE_KIND_WORKER,
    TAG_NODE_KIND,
    TAG_NODE_STATUS,
    TAG_USER_NODE_TYPE,
    NodeProvider,
)
from ray_tpu_torch.autoscaler.updater import NodeUpdater

logger = logging.getLogger(__name__)


class InventoryNodeProvider(NodeProvider):
    def __init__(self, provider_config: Dict[str, Any],
                 cluster_name: str = "inventory"):
        super().__init__(provider_config, cluster_name)
        import sys

        self._python = provider_config.get("python", sys.executable)
        machines = provider_config.get("machines") or []
        if not machines:
            raise ValueError("inventory provider needs machines: [...]")
        self._machines: List[Dict[str, Any]] = [dict(m) for m in machines]
        self._claimed: Dict[int, str] = {}  # machine idx -> node id
        self._nodes: Dict[str, Dict[str, Any]] = {}
        self._lock = threading.Lock()
        self._gcs_proc = None
        self.gcs_address = provider_config.get("gcs_address")
        if not self.gcs_address:
            from ray_tpu_torch.cluster.process_cluster import (
                _gcs_visible_devices,
                _spawn,
            )

            self._gcs_proc, fields = _spawn(
                ["ray_tpu_torch.cluster.gcs_server"], "GCS_ADDRESS",
                timeout=120.0, extra_env={
                    "CUDA_VISIBLE_DEVICES": _gcs_visible_devices(
                        provider_config.get("gcs_device"))})
            self.gcs_address = fields[1]

    # ------------------------------------------------------------- machines
    def _claim_machine(self) -> int:
        with self._lock:
            for idx in range(len(self._machines)):
                if idx not in self._claimed:
                    self._claimed[idx] = "pending"
                    return idx
        raise RuntimeError("inventory exhausted: no free machines")

    def _runner_for(self, machine: Dict[str, Any]):
        if machine.get("local"):
            return LocalCommandRunner()
        return SSHCommandRunner(
            host=machine["host"], user=machine.get("user", ""),
            port=int(machine.get("port", 22)),
            ssh_key=machine.get("ssh_key"))

    # -------------------------------------------------------------- factory
    def _launch(self, node_config: Dict[str, Any],
                tags: Dict[str, str]) -> str:
        idx = self._claim_machine()
        machine = self._machines[idx]
        nid = f"inv-{idx}-{uuid.uuid4().hex[:6]}"
        with self._lock:
            self._claimed[idx] = nid
            self._nodes[nid] = {"tags": dict(tags), "machine_idx": idx,
                                "raylet": None, "address": None}
        runner = self._runner_for(machine)
        resources = dict(node_config.get("resources", {"CPU": 1}))
        log = f"/tmp/ray_tpu_torch_{self.cluster_name}_{nid}.log"
        pidfile = log + ".pid"
        start = (
            f"nohup {self._python} -m ray_tpu_torch.cluster.raylet_server "
            f"--gcs {self.gcs_address} "
            f"--resources '{json.dumps(resources)}' "
            f"> {log} 2>&1 & echo $! > {pidfile}")
        updater = NodeUpdater(
            nid, self, runner,
            initialization_commands=self.provider_config.get(
                "initialization_commands", []),
            setup_commands=self.provider_config.get("setup_commands", []),
            start_commands=[start],
            file_mounts=self.provider_config.get("file_mounts", {}),
            ready_timeout_s=float(
                self.provider_config.get("ready_timeout_s", 60.0)))
        try:
            updater.run()
            deadline = time.monotonic() + 60.0
            while time.monotonic() < deadline:
                rc, out = runner.run(f"cat {log} 2>/dev/null || true")
                for line in out.splitlines():
                    if line.startswith("RAYLET_ADDRESS"):
                        fields = line.split()
                        with self._lock:
                            self._nodes[nid]["address"] = fields[1]
                            self._nodes[nid]["raylet"] = fields[3]
                            self._nodes[nid]["log"] = log
                            self._nodes[nid]["pidfile"] = pidfile
                        return nid
                time.sleep(0.5)
            raise RuntimeError(
                f"raylet on machine {machine.get('host', idx)} never "
                f"announced (see {log})")
        except BaseException:
            # reap any half-started raylet BEFORE releasing the machine:
            # a detached process that announces later would register as
            # a ghost node, and the next claim would double-book the
            # machine with its pidfile orphaned
            try:
                runner.run(f"[ -f {pidfile} ] && "
                           f"kill $(cat {pidfile}) 2>/dev/null; "
                           f"rm -f {pidfile}", timeout=30.0)
            except Exception:  # noqa: BLE001 — best-effort reap
                pass
            with self._lock:
                self._claimed.pop(idx, None)
                self._nodes.pop(nid, None)
            raise

    def create_head(self, node_config: Dict[str, Any],
                    node_type: str) -> str:
        return self._launch(node_config, {
            TAG_NODE_KIND: NODE_KIND_HEAD,
            TAG_USER_NODE_TYPE: node_type})

    def create_node(self, node_config: Dict[str, Any],
                    tags: Dict[str, str], count: int) -> None:
        for _ in range(count):
            self._launch(node_config, {TAG_NODE_KIND: NODE_KIND_WORKER,
                                       **tags})

    # ------------------------------------------------------------- surface
    def non_terminated_nodes(self, tag_filters: Dict[str, str]
                             ) -> List[str]:
        with self._lock:
            return [nid for nid, info in self._nodes.items()
                    if all(info["tags"].get(k) == v
                           for k, v in tag_filters.items())]

    def is_running(self, node_id: str) -> bool:
        with self._lock:
            return node_id in self._nodes

    def node_tags(self, node_id: str) -> Dict[str, str]:
        with self._lock:
            info = self._nodes.get(node_id)
            return dict(info["tags"]) if info else {}

    def set_node_tags(self, node_id: str, tags: Dict[str, str]) -> None:
        with self._lock:
            info = self._nodes.get(node_id)
            if info is not None:
                info["tags"].update(tags)

    def internal_ip(self, node_id: str) -> str:
        with self._lock:
            info = self._nodes.get(node_id)
        if not info:
            return ""
        machine = self._machines[info["machine_idx"]]
        return machine.get("host", "127.0.0.1")

    def raylet_node_id(self, node_id: str) -> Optional[str]:
        with self._lock:
            info = self._nodes.get(node_id)
            return info["raylet"] if info else None

    def terminate_node(self, node_id: str) -> None:
        with self._lock:
            info = self._nodes.pop(node_id, None)
            if info is not None:
                self._claimed.pop(info["machine_idx"], None)
        if info is None or info.get("pidfile") is None:
            return
        machine = self._machines[info["machine_idx"]]
        runner = self._runner_for(machine)
        try:
            runner.run(f"kill $(cat {info['pidfile']}) 2>/dev/null; "
                       f"rm -f {info['pidfile']}", timeout=30.0)
        except Exception:  # noqa: BLE001 — best-effort reap
            logger.warning("terminate of %s failed", node_id,
                           exc_info=True)

    def shutdown(self) -> None:
        for nid in list(self._nodes):
            self.terminate_node(nid)
        if self._gcs_proc is not None:
            self._gcs_proc.terminate()

    def state(self) -> Dict[str, Any]:
        """For ray down from a fresh process (commands state file)."""
        pids = []
        if self._gcs_proc is not None:
            pids.append(self._gcs_proc.pid)
        return {"pids": pids, "provider": "inventory"}
