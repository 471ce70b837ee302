"""`ray up` / `ray down` command layer.

Reference: python/ray/autoscaler/_private/commands.py
(create_or_update_cluster:121, teardown_cluster:211, get_head_node_ip)
driven by scripts/scripts.py. The cluster YAML schema is the reference's
(cluster_name, provider, max_workers, available_node_types,
head_node_type, idle_timeout_minutes); setup/init commands are accepted
but ignored by the local providers (no SSH surface on one host).

Providers resolve through a registry (reference:
python/ray/autoscaler/node_provider.py _get_node_provider):
  fake_multinode — nodes inside the current in-process runtime
  process       — one REAL raylet OS process per node against a GCS
                  server process (cluster/process_cluster.py machinery)
  command       — the SSH shape: nodes come up by running a shell
                  command template that announces a raylet on stdout
  external      — dotted path to a user NodeProvider subclass
"""

from __future__ import annotations

import importlib
import logging
import threading
import uuid
from typing import Any, Dict, List, Optional

from ray_tpu_torch.autoscaler.node_provider import (
    NODE_KIND_HEAD,
    NODE_KIND_WORKER,
    STATUS_UP_TO_DATE,
    TAG_NODE_KIND,
    TAG_NODE_STATUS,
    TAG_USER_NODE_TYPE,
    FakeMultiNodeProvider,
    NodeProvider,
)

logger = logging.getLogger(__name__)


# --------------------------------------------------------------------------
# config loading (reference: autoscaler/_private/util.py prepare_config)
# --------------------------------------------------------------------------

def load_cluster_config(path_or_dict) -> Dict[str, Any]:
    """Read + validate + fill defaults for a cluster config (YAML path,
    YAML string, or dict)."""
    if isinstance(path_or_dict, dict):
        config = dict(path_or_dict)
    else:
        import os

        import yaml

        if os.path.exists(path_or_dict):
            with open(path_or_dict) as f:
                config = yaml.safe_load(f)
        else:
            config = yaml.safe_load(path_or_dict)
        if not isinstance(config, dict):
            raise ValueError("cluster config must be a mapping")
    return prepare_config(config)


def prepare_config(config: Dict[str, Any]) -> Dict[str, Any]:
    config = dict(config)
    config.setdefault("cluster_name", "default")
    provider = config.setdefault("provider", {"type": "fake_multinode"})
    if "type" not in provider:
        raise ValueError("provider.type is required")
    types = config.setdefault("available_node_types", {
        "head": {"resources": {"CPU": 1}, "min_workers": 0,
                 "max_workers": 0},
        "worker": {"resources": {"CPU": 1}, "min_workers": 0,
                   "max_workers": 2},
    })
    config.setdefault("head_node_type", next(iter(types)))
    if config["head_node_type"] not in types:
        raise ValueError(
            f"head_node_type {config['head_node_type']!r} is not in "
            f"available_node_types {sorted(types)}")
    for name, spec in types.items():
        if not isinstance(spec.get("resources", {}), dict):
            raise ValueError(f"node type {name}: resources must be a map")
        spec.setdefault("resources", {"CPU": 1})
        spec.setdefault("min_workers", 0)
        spec.setdefault("max_workers", config.get("max_workers", 2))
    config.setdefault(
        "max_workers",
        sum(t["max_workers"] for n, t in types.items()
            if n != config["head_node_type"]))
    config.setdefault("idle_timeout_minutes", 5)
    return config


# --------------------------------------------------------------------------
# provider registry
# --------------------------------------------------------------------------

_PROVIDERS: Dict[str, Any] = {}


def register_node_provider(type_name: str, cls) -> None:
    _PROVIDERS[type_name] = cls


def _get_node_provider(provider_config: Dict[str, Any],
                       cluster_name: str) -> NodeProvider:
    ptype = provider_config["type"]
    if ptype == "external":
        module_path, _, cls_name = provider_config["module"].rpartition(".")
        cls = getattr(importlib.import_module(module_path), cls_name)
        return cls(provider_config, cluster_name)
    if ptype in _PROVIDERS:
        return _PROVIDERS[ptype](provider_config, cluster_name)
    if ptype == "fake_multinode":
        return FakeMultiNodeProvider(provider_config, cluster_name)
    if ptype == "process":
        return ProcessNodeProvider(provider_config, cluster_name)
    if ptype == "command":
        return CommandNodeProvider(provider_config, cluster_name)
    if ptype == "inventory":
        from ray_tpu_torch.autoscaler.inventory_provider import (
            InventoryNodeProvider,
        )

        return InventoryNodeProvider(provider_config, cluster_name)
    if ptype == "aws":
        from ray_tpu_torch.autoscaler.aws_provider import AwsNodeProvider

        return AwsNodeProvider(provider_config, cluster_name)
    raise ValueError(f"unknown provider type {ptype!r}")


class CommandNodeProvider(NodeProvider):
    """SSH-shape provider: a node comes up by RUNNING A COMMAND whose
    stdout announces the raylet it started (reference: the SSH command
    runner under autoscaler/_private/command_runner.py behind the
    NodeProvider plugin surface — on a real fleet the template is
    ``ssh {host} python -m ray_tpu_torch.cluster.raylet_server --gcs ...``;
    the announce line rides the ssh stdout the same way).

    provider config keys:
      gcs_address            optional external control plane; when
                             absent the provider starts a GCS server
                             process (the head's control plane)
      gcs_device             that GCS's solve device: absent means
                             CUDA, "cpu" asks for the CPU
                             (ProcessCluster's gcs_device)
      create_node_command    template; placeholders {gcs_address},
                             {resources_json}, {num_cpus}. Default
                             spawns a raylet via this interpreter —
                             the loopback stand-in for ssh.
      terminate_node_command optional template; placeholders
                             {node_id}, {address}, {pid}. Default:
                             terminate the locally-tracked process.
    """

    DEFAULT_CREATE = (
        "exec %s -m ray_tpu_torch.cluster.raylet_server "
        "--gcs {gcs_address} --resources '{resources_json}'")

    def __init__(self, provider_config: Dict[str, Any],
                 cluster_name: str = "command"):
        super().__init__(provider_config, cluster_name)
        import sys

        self._gcs_proc = None
        self.gcs_address = provider_config.get("gcs_address")
        if not self.gcs_address:
            from ray_tpu_torch.cluster.process_cluster import (
                _gcs_visible_devices,
                _spawn,
            )

            self._gcs_proc, fields = _spawn(
                ["ray_tpu_torch.cluster.gcs_server",
                 "--heartbeat-period-ms",
                 str(provider_config.get("heartbeat_period_ms", 100)),
                 "--num-heartbeats-timeout",
                 str(provider_config.get("num_heartbeats_timeout", 20))],
                "GCS_ADDRESS", timeout=120.0, extra_env={
                    "CUDA_VISIBLE_DEVICES": _gcs_visible_devices(
                        provider_config.get("gcs_device"))})
            self.gcs_address = fields[1]
        self._create_cmd = provider_config.get(
            "create_node_command", self.DEFAULT_CREATE % sys.executable)
        self._terminate_cmd = provider_config.get("terminate_node_command")
        self._lock = threading.Lock()
        self._nodes: Dict[str, Dict[str, Any]] = {}

    def _run_create(self, node_config: Dict[str, Any]) -> str:
        import json
        import os
        import select
        import subprocess
        import time as _time

        resources = dict(node_config.get("resources", {"CPU": 1}))
        cmd = self._create_cmd.format(
            gcs_address=self.gcs_address,
            resources_json=json.dumps(resources),
            num_cpus=resources.get("CPU", 1))
        # shared child-env hygiene (cluster/child_env.py): no eager
        # accelerator hooks, a resolvable JAX backend, ray_tpu_torch
        # importable regardless of the caller's cwd
        from ray_tpu_torch.cluster.child_env import sanitized_env

        env = sanitized_env(pin_pythonpath=True)
        proc = subprocess.Popen(cmd, shell=True, stdout=subprocess.PIPE,
                                env=env, text=True)
        deadline = _time.monotonic() + 60.0
        buf = ""
        try:
            os.set_blocking(proc.stdout.fileno(), False)
            while _time.monotonic() < deadline:
                # select-bounded read: a silent command must FAIL after
                # the deadline, not park the monitor thread in readline
                ready, _, _ = select.select(
                    [proc.stdout], [], [],
                    max(0.0, deadline - _time.monotonic()))
                if not ready:
                    continue
                chunk = proc.stdout.read()
                if chunk == "" and proc.poll() is not None:
                    raise RuntimeError(
                        f"create command exited rc={proc.poll()}: {cmd}")
                buf += chunk or ""
                for line in buf.splitlines():
                    if line.startswith("RAYLET_ADDRESS"):
                        fields = line.split()
                        nid = f"cmd-{uuid.uuid4().hex[:8]}"
                        with self._lock:
                            self._nodes[nid] = {
                                "tags": {}, "raylet": fields[3],
                                "address": fields[1], "proc": proc,
                            }
                        return nid
            raise RuntimeError(f"create command never announced: {cmd}")
        except BaseException:
            # never leak the process: an unannounced raylet may already
            # be registered with the GCS and would be unreapable
            try:
                proc.kill()
                proc.wait(timeout=10)
                from ray_tpu_torch.cluster.byte_store import (
                    remove_segments_of,
                )

                remove_segments_of([proc.pid])
            except Exception:
                pass
            raise

    def create_head(self, node_config: Dict[str, Any],
                    node_type: str) -> str:
        nid = self._run_create(node_config)
        with self._lock:
            self._nodes[nid]["tags"] = {
                TAG_NODE_KIND: NODE_KIND_HEAD,
                TAG_NODE_STATUS: STATUS_UP_TO_DATE,
                TAG_USER_NODE_TYPE: node_type,
            }
        return nid

    def create_node(self, node_config: Dict[str, Any],
                    tags: Dict[str, str], count: int) -> None:
        for _ in range(count):
            nid = self._run_create(node_config)
            with self._lock:
                self._nodes[nid]["tags"] = {
                    **tags, TAG_NODE_STATUS: STATUS_UP_TO_DATE}

    def non_terminated_nodes(self, tag_filters: Dict[str, str]
                             ) -> List[str]:
        with self._lock:
            return [nid for nid, info in self._nodes.items()
                    if all(info["tags"].get(k) == v
                           for k, v in tag_filters.items())]

    def is_running(self, node_id: str) -> bool:
        with self._lock:
            info = self._nodes.get(node_id)
        return info is not None and info["proc"].poll() is None

    def node_tags(self, node_id: str) -> Dict[str, str]:
        with self._lock:
            return dict(self._nodes[node_id]["tags"])

    def internal_ip(self, node_id: str) -> str:
        with self._lock:
            return self._nodes[node_id]["address"].rsplit(":", 1)[0]

    def raylet_node_id(self, node_id: str) -> Optional[str]:
        with self._lock:
            info = self._nodes.get(node_id)
        return None if info is None else info["raylet"]

    def terminate_node(self, node_id: str) -> None:
        import subprocess

        from ray_tpu_torch.cluster.byte_store import remove_segments_of

        with self._lock:
            info = self._nodes.pop(node_id, None)
        if info is None:
            return
        if self._terminate_cmd:
            subprocess.run(self._terminate_cmd.format(
                node_id=info["raylet"], address=info["address"],
                pid=info["proc"].pid), shell=True, timeout=60)
        else:
            info["proc"].terminate()
        try:
            info["proc"].wait(timeout=10)
        except Exception:
            info["proc"].kill()
            info["proc"].wait(timeout=10)
        # the default create command execs the raylet in the shell's
        # pid, and a terminated raylet leaves its segment behind
        remove_segments_of([info["proc"].pid])

    def shutdown(self) -> None:
        with self._lock:
            nodes = list(self._nodes)
        for nid in nodes:
            try:
                self.terminate_node(nid)
            except Exception:
                pass
        if self._gcs_proc is not None:
            self._gcs_proc.kill()
            try:
                self._gcs_proc.wait(timeout=5)
            except Exception:
                pass

    def state(self) -> Dict[str, Any]:
        with self._lock:
            return {"gcs_address": self.gcs_address,
                    "nodes": {nid: info["address"]
                              for nid, info in self._nodes.items()}}


class ProcessNodeProvider(NodeProvider):
    """Real OS processes per node: the head is a GCS server process, each
    worker is a raylet server process registered to it (the single-host
    analogue of a cloud provider; reference:
    autoscaler/_private/fake_multi_node/node_provider.py but with real
    process isolation). The provider config's ``gcs_device`` is
    ProcessCluster's: absent means a GCS that solves on CUDA, ``"cpu"``
    asks for the CPU."""

    def __init__(self, provider_config: Dict[str, Any],
                 cluster_name: str = "process"):
        super().__init__(provider_config, cluster_name)
        from ray_tpu_torch.cluster.process_cluster import ProcessCluster

        self._cluster = ProcessCluster(
            heartbeat_period_ms=provider_config.get(
                "heartbeat_period_ms", 100),
            num_heartbeats_timeout=provider_config.get(
                "num_heartbeats_timeout", 20),
            gcs_device=provider_config.get("gcs_device"))
        self._lock = threading.Lock()
        self._nodes: Dict[str, Dict[str, Any]] = {}

    @property
    def gcs_address(self) -> str:
        return self._cluster.gcs_address

    def create_head(self, node_config: Dict[str, Any],
                    node_type: str) -> str:
        # the GCS process started in the ProcessCluster ctor IS the head
        # control plane; the head node also runs a raylet for its
        # resources, like the reference head node
        nid = self._create_raylet(node_config)
        with self._lock:
            self._nodes[nid]["tags"] = {
                TAG_NODE_KIND: NODE_KIND_HEAD,
                TAG_NODE_STATUS: STATUS_UP_TO_DATE,
                TAG_USER_NODE_TYPE: node_type,
            }
        return nid

    def _create_raylet(self, node_config: Dict[str, Any]) -> str:
        resources = dict(node_config.get("resources", {"CPU": 1}))
        cpus = float(resources.get("CPU", 1))
        raylet_node_id = self._cluster.add_node(
            num_cpus=cpus, resources={
                k: v for k, v in resources.items() if k != "CPU"})
        nid = f"proc-{uuid.uuid4().hex[:8]}"
        with self._lock:
            self._nodes[nid] = {"tags": {}, "raylet": raylet_node_id}
        return nid

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
            return dict(self._nodes[node_id]["tags"])

    def internal_ip(self, node_id: str) -> str:
        return "127.0.0.1"

    def raylet_node_id(self, node_id: str) -> str:
        with self._lock:
            return self._nodes[node_id]["raylet"]

    def create_node(self, node_config: Dict[str, Any],
                    tags: Dict[str, str], count: int) -> None:
        for _ in range(count):
            nid = self._create_raylet(node_config)
            with self._lock:
                self._nodes[nid]["tags"] = {
                    **tags, TAG_NODE_STATUS: STATUS_UP_TO_DATE}

    def terminate_node(self, node_id: str) -> None:
        with self._lock:
            info = self._nodes.pop(node_id, None)
        if info is not None:
            try:
                self._cluster.remove_node(info["raylet"])
            except Exception:
                logger.exception("terminating node %s failed", node_id)

    def shutdown(self) -> None:
        self._cluster.shutdown()

    def state(self) -> Dict[str, Any]:
        return {
            "gcs_address": self._cluster.gcs_address,
            "pids": [self._cluster.gcs_proc.pid] + [
                p.pid for p in self._cluster.raylets.values()],
        }


# --------------------------------------------------------------------------
# commands (reference: commands.py create_or_update_cluster / teardown)
# --------------------------------------------------------------------------

_CLUSTERS: Dict[str, "ClusterHandle"] = {}
_CLUSTERS_LOCK = threading.Lock()
# serializes whole up/down operations: provider construction spawns real
# processes, and a check-then-create race would leak an entire cluster
_CREATE_LOCK = threading.Lock()


class ClusterHandle:
    """What `ray up` returns: the provider plus identity/introspection."""

    def __init__(self, config: Dict[str, Any], provider: NodeProvider,
                 head_id: str):
        self.config = config
        self.provider = provider
        self.head_id = head_id
        self.autoscaler = None
        self._monitor_stop: Optional[threading.Event] = None
        self._monitor_thread: Optional[threading.Thread] = None

    @property
    def name(self) -> str:
        return self.config["cluster_name"]

    def head_node_ip(self) -> str:
        return self.provider.internal_ip(self.head_id)

    def worker_ids(self) -> List[str]:
        return self.provider.non_terminated_nodes(
            {TAG_NODE_KIND: NODE_KIND_WORKER})

    def start_monitor(self, interval_s: float = 1.0) -> None:
        """Run the StandardAutoscaler reconcile loop in a thread
        (reference: monitor.py driving StandardAutoscaler.update).
        Idempotent: a second call stops the previous loop first — two
        concurrent loops would race node launches."""
        from ray_tpu_torch.autoscaler.autoscaler import StandardAutoscaler

        self.stop_monitor()
        if self.autoscaler is None:
            self.autoscaler = StandardAutoscaler(self.config, self.provider)
        stop = threading.Event()
        self._monitor_stop = stop

        def loop():
            while not stop.wait(interval_s):
                try:
                    self.autoscaler.update()
                    # monitor launches/terminations change the process
                    # set: keep the state file current so a cross-process
                    # `ray down` can reap every node
                    _save_cluster_state(self)
                except Exception:
                    logger.exception("autoscaler tick failed")

        self._monitor_thread = threading.Thread(
            target=loop, daemon=True, name=f"monitor-{self.name}")
        self._monitor_thread.start()

    def stop_monitor(self) -> None:
        """Stop AND JOIN the loop: teardown must not race an in-flight
        tick that could relaunch nodes or resurrect the state file."""
        if self._monitor_stop is not None:
            self._monitor_stop.set()
            self._monitor_stop = None
        thread = getattr(self, "_monitor_thread", None)
        if thread is not None and thread.is_alive():
            thread.join(timeout=60.0)
        self._monitor_thread = None
        if self.autoscaler is not None:
            try:
                self.autoscaler.load_metrics.close()
            except Exception:
                pass


def create_or_update_cluster(config) -> ClusterHandle:
    """`ray up`: ensure the head node exists and min_workers of every
    node type are up (reference: commands.py:121 + get_or_create_head_node)."""
    config = load_cluster_config(config)
    name = config["cluster_name"]
    with _CREATE_LOCK:
        return _create_or_update_locked(config, name)


def _create_or_update_locked(config: Dict[str, Any],
                             name: str) -> ClusterHandle:
    with _CLUSTERS_LOCK:
        handle = _CLUSTERS.get(name)
    if handle is None:
        provider = _get_node_provider(config["provider"], name)
        head_type = config["head_node_type"]
        head_cfg = config["available_node_types"][head_type]
        if hasattr(provider, "create_head"):
            head_id = provider.create_head(head_cfg, head_type)
        else:
            heads = provider.non_terminated_nodes(
                {TAG_NODE_KIND: NODE_KIND_HEAD})
            head_id = heads[0] if heads else None
            if head_id is None:
                raise RuntimeError("provider has no head node")
        handle = ClusterHandle(config, provider, head_id)
        with _CLUSTERS_LOCK:
            _CLUSTERS[name] = handle
    else:
        handle.config = config  # ray up on a live cluster updates config
        if handle.autoscaler is not None:
            # the running monitor reads handle.autoscaler each tick:
            # rebuilding it makes updated YAML limits take effect
            from ray_tpu_torch.autoscaler.autoscaler import StandardAutoscaler

            handle.autoscaler = StandardAutoscaler(config, handle.provider)
    # scale to min_workers per type (idempotent)
    for type_name, spec in config["available_node_types"].items():
        if type_name == config["head_node_type"]:
            continue
        want = spec.get("min_workers", 0)
        have = len(handle.provider.non_terminated_nodes(
            {TAG_NODE_KIND: NODE_KIND_WORKER,
             TAG_USER_NODE_TYPE: type_name}))
        if have < want:
            handle.provider.create_node(
                spec,
                {TAG_NODE_KIND: NODE_KIND_WORKER,
                 TAG_USER_NODE_TYPE: type_name},
                want - have)
    logger.info("cluster %s up: head=%s workers=%d", name,
                handle.head_id, len(handle.worker_ids()))
    _save_cluster_state(handle)
    return handle


def _state_path(name: str) -> str:
    import os

    d = os.path.join(os.path.expanduser("~"), ".ray_tpu_torch", "clusters")
    os.makedirs(d, exist_ok=True)
    return os.path.join(d, f"{name}.json")


def _save_cluster_state(handle: ClusterHandle) -> None:
    """Process-backed clusters outlive the `ray up` CLI process; persist
    enough for a later `ray down` in a fresh process to reap them
    (reference: ray up writes cluster state under ~/.ray)."""
    if not hasattr(handle.provider, "state"):
        return
    import json

    with open(_state_path(handle.name), "w") as f:
        json.dump(handle.provider.state(), f)


def _teardown_from_state_file(name: str) -> bool:
    import json
    import os
    import signal as _signal

    path = _state_path(name)
    if not os.path.exists(path):
        return False
    with open(path) as f:
        state = json.load(f)
    for pid in reversed(state.get("pids", [])):  # raylets, then GCS
        try:
            os.kill(pid, _signal.SIGTERM)
        except (ProcessLookupError, PermissionError):
            pass
    # a SIGTERMed raylet ends without unlinking its segment
    from ray_tpu_torch.cluster.byte_store import remove_segments_when_gone

    remove_segments_when_gone(state.get("pids", []))
    os.unlink(path)
    logger.info("cluster %s (from state file) torn down", name)
    return True


def teardown_cluster(config_or_name, keep_min_workers: bool = False) -> None:
    """`ray down` (reference: commands.py:211)."""
    if isinstance(config_or_name, str) and "\n" not in config_or_name \
            and not config_or_name.endswith((".yaml", ".yml")):
        name = config_or_name
    else:
        name = load_cluster_config(config_or_name)["cluster_name"]
    with _CLUSTERS_LOCK:
        handle = _CLUSTERS.pop(name, None)
    if handle is None:
        # a `ray up` in another (exited) process may have left a
        # process-backed cluster running: reap it from the state file
        if not _teardown_from_state_file(name):
            logger.warning("no live cluster named %s", name)
        return
    handle.stop_monitor()
    keep: Dict[str, int] = {}
    if keep_min_workers:
        for tname, spec in handle.config["available_node_types"].items():
            keep[tname] = spec.get("min_workers", 0)
    for nid in handle.worker_ids():
        tname = handle.provider.node_tags(nid).get(TAG_USER_NODE_TYPE)
        if keep.get(tname, 0) > 0:
            keep[tname] -= 1
            continue
        handle.provider.terminate_node(nid)
    if not keep_min_workers:
        handle.provider.terminate_node(handle.head_id)
        if hasattr(handle.provider, "shutdown"):
            handle.provider.shutdown()
        import os

        try:
            os.unlink(_state_path(name))
        except FileNotFoundError:
            pass
    else:
        with _CLUSTERS_LOCK:
            _CLUSTERS[name] = handle  # still alive, head retained
        # terminated workers must leave the persisted pid list too, or a
        # later cross-process down would SIGTERM recycled pids
        _save_cluster_state(handle)


def get_head_node_ip(config_or_name) -> str:
    handle = _resolve(config_or_name)
    return handle.head_node_ip()


def get_worker_node_ips(config_or_name) -> List[str]:
    handle = _resolve(config_or_name)
    return [handle.provider.internal_ip(n) for n in handle.worker_ids()]


def _resolve(config_or_name) -> ClusterHandle:
    if isinstance(config_or_name, str) and "\n" not in config_or_name \
            and not config_or_name.endswith((".yaml", ".yml")):
        name = config_or_name
    else:
        name = load_cluster_config(config_or_name)["cluster_name"]
    with _CLUSTERS_LOCK:
        handle = _CLUSTERS.get(name)
    if handle is None:
        raise RuntimeError(f"no live cluster named {name}")
    return handle
