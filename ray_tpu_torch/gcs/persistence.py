"""GCS durability: snapshot and restore of cluster metadata.

Reference: the GCS persists its tables (actor/job/node/PG/KV) to Redis
(gcs_table_storage.cc, gcs/store_client/redis_store_client.cc) and bulk
re-loads them on restart (gcs_init_data.cc), restarting detached actors
and re-placing placement groups. This build's control plane lives
in-process, so durability is an explicit snapshot file:

  save_snapshot(path)     serialize internal KV, job info, node resource
                          configs, detached-actor creation specs, and
                          placement-group specs (cloudpickle).
  restore_snapshot(path)  after a fresh ``init``: re-register the KV,
                          re-create detached named actors (fresh state —
                          the reference also loses actor memory on
                          restart-from-GCS) and re-place PGs.

Like the reference, only *detached* actors survive the control plane:
non-detached actors die with their owner (job)."""

from __future__ import annotations

import os
from typing import Any, Dict, List, Optional

import cloudpickle

from ray_tpu_torch.core import runtime as rt_mod

SNAPSHOT_VERSION = 1


def _runtime():
    rt = rt_mod.global_runtime
    if rt is None or rt.is_shutdown:
        raise RuntimeError("ray_tpu_torch is not initialized")
    return rt


def capture() -> Dict[str, Any]:
    """Materialize the durable subset of cluster state."""
    rt = _runtime()
    from ray_tpu_torch.core.actor_runtime import ActorState

    actors: List[Dict[str, Any]] = []
    for rec in rt.actor_directory.list():
        if not rec.detached or rec.state is ActorState.DEAD:
            continue
        creation = rec.creation_spec
        actors.append({
            "cls": creation.cls,
            "cls_descriptor": creation.cls_descriptor,
            "init_args": creation.init_args,
            "init_kwargs": creation.init_kwargs,
            "options": creation.options,
            "name": rec.name,
            "namespace": rec.namespace,
        })
    from ray_tpu_torch.scheduler.placement_group import PlacementGroupState

    pgs: List[Dict[str, Any]] = []
    for pg in rt.pg_manager._groups.values():
        if pg.state is PlacementGroupState.REMOVED:
            continue
        pgs.append({
            "id": pg.id,  # stable identity -> idempotent restore
            "bundles": [dict(b) for b in pg.bundles],
            "strategy": pg.strategy,
            "name": pg.name,
        })
    with rt._kv_lock:
        kv = dict(rt.kv)
    nodes = []
    for raylet in rt.cluster_state.alive_raylets():
        nodes.append({
            "resources": raylet.local_resources.to_map(rt.cluster_state.ids),
            "is_head": raylet is rt.head_raylet,
        })
    return {
        "version": SNAPSHOT_VERSION,
        "namespace": rt.namespace,
        "kv": kv,
        "detached_actors": actors,
        "placement_groups": pgs,
        "nodes": nodes,
    }


def save_snapshot(path: str) -> str:
    data = capture()
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "wb") as f:
        cloudpickle.dump(data, f)
    os.replace(tmp, path)  # atomic publish, never a torn snapshot
    return path


def load_snapshot(path: str) -> Dict[str, Any]:
    with open(path, "rb") as f:
        data = cloudpickle.load(f)
    if data.get("version") != SNAPSHOT_VERSION:
        raise ValueError(
            f"snapshot version {data.get('version')} != {SNAPSHOT_VERSION}")
    return data


def restore_snapshot(path: str, *, restore_nodes: bool = False) -> Dict[str, int]:
    """Apply a snapshot to the (already initialized) runtime. Returns
    counts per restored table (reference: gcs_init_data.cc load +
    GcsActorManager restart of detached actors)."""
    rt = _runtime()
    data = load_snapshot(path)
    counts = {"kv": 0, "actors": 0, "placement_groups": 0, "nodes": 0}
    if restore_nodes:
        # re-create worker-node capacity (head node already exists)
        for node in data["nodes"]:
            if node["is_head"]:
                continue
            rt.add_node(dict(node["resources"]))
            counts["nodes"] += 1
    with rt._kv_lock:
        for key, value in data["kv"].items():
            if key not in rt.kv:
                rt.kv[key] = value
                counts["kv"] += 1
    from ray_tpu_torch.scheduler.placement_group import PlacementGroup

    for pg in data["placement_groups"]:
        # re-create under the ORIGINAL id (the reference keys its PG
        # table by id), so unnamed groups are idempotent too
        if pg["id"] in rt.pg_manager._groups:
            continue
        rt.pg_manager.create(PlacementGroup(
            id=pg["id"],
            bundles=[dict(b) for b in pg["bundles"]],
            strategy=pg["strategy"],
            name=pg["name"]))
        counts["placement_groups"] += 1
    for spec in data["detached_actors"]:
        # anonymous-namespace actors re-register under the *current*
        # runtime namespace, so the duplicate check must look there
        ns = getattr(spec["options"], "namespace", None) or rt.namespace
        existing = rt.actor_directory.get_by_name(
            spec["name"], ns) if spec["name"] else None
        if existing is not None:
            continue
        rt.create_actor(spec["cls"], spec["cls_descriptor"],
                        spec["init_args"], spec["init_kwargs"],
                        spec["options"])
        counts["actors"] += 1
    return counts


class PeriodicSnapshotter:
    """Background autosave (reference: the GCS continuously writes table
    mutations to Redis; here the whole table set flushes on an interval)."""

    def __init__(self, path: str, interval_s: float = 30.0):
        import threading

        self.path = path
        self.interval_s = interval_s
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def _loop(self) -> None:
        while not self._stop.wait(self.interval_s):
            try:
                save_snapshot(self.path)
            except Exception:
                pass

    def stop(self, final_save: bool = True) -> None:
        self._stop.set()
        self._thread.join(timeout=5)
        if final_save:
            try:
                save_snapshot(self.path)
            except Exception:
                pass
