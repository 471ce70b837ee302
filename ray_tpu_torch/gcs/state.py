"""GlobalState — cluster introspection tables.

Reference: python/ray/state.py:20 (GlobalState over GlobalStateAccessor:
actor_table, node_table, placement_group_table, jobs) and
python/ray/internal/internal_api.py (``ray memory`` ownership dump).
Reads come straight from the runtime's authoritative structures — the
same data the reference's GCS tables hold.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

from ray_tpu_torch.core import runtime as rt_mod


def _runtime():
    rt = rt_mod.global_runtime
    if rt is None or rt.is_shutdown:
        raise RuntimeError("ray_tpu_torch is not initialized")
    return rt


class GlobalState:
    # ------------------------------------------------------------- nodes
    def node_table(self) -> List[Dict[str, Any]]:
        return _runtime().nodes()

    # ------------------------------------------------------------ actors
    def actor_table(self) -> Dict[str, Dict[str, Any]]:
        rt = _runtime()
        out = {}
        for rec in rt.actor_directory.list():
            out[rec.actor_id.hex()] = {
                "ActorID": rec.actor_id.hex(),
                "State": rec.state.name,
                "Name": rec.name or "",
                "Namespace": rec.namespace,
                "NodeID": rec.node_id.hex() if rec.node_id else None,
                "NumRestarts": rec.num_restarts,
                "RestartsRemaining": rec.restarts_remaining,
                "DeathCause": rec.death_cause,
                "ClassName": rec.creation_spec.cls_descriptor,
            }
        return out

    # --------------------------------------------------- placement groups
    def placement_group_table(self) -> Dict[str, Dict[str, Any]]:
        rt = _runtime()
        out = {}
        with rt.pg_manager._lock:
            groups = dict(rt.pg_manager._groups)
        for pg_id, pg in groups.items():
            out[pg_id.hex()] = {
                "PlacementGroupID": pg_id.hex(),
                "Name": pg.name or "",
                "State": pg.state.name,
                "Strategy": pg.strategy,
                "Bundles": [dict(b) for b in pg.bundles],
                "BundleNodes": [n.hex() if n else None
                                for n in pg.bundle_nodes],
            }
        return out

    # ------------------------------------------------------------ objects
    def object_table(self) -> Dict[str, Dict[str, Any]]:
        rt = _runtime()
        from ray_tpu_torch._private.ids import ObjectID

        out = {}
        for oid_hex, entry in rt.reference_counter.dump().items():
            stored = rt.object_store.peek(ObjectID.from_hex(oid_hex))
            out[oid_hex] = {
                "ObjectID": oid_hex,
                "LocalRefCount": entry.get("local", 0),
                "SubmittedTaskRefCount": entry.get("submitted", 0),
                "Borrowers": entry.get("borrowers", 0),
                "Pinned": entry.get("pinned", False),
                "Present": stored is not None,
                "SizeBytes": stored.size if stored is not None else 0,
            }
        return out

    def memory_summary(self) -> str:
        """``ray memory`` — ownership/refcount dump."""
        rows = self.object_table().values()
        total = sum(r["SizeBytes"] for r in rows)
        lines = [
            f"{len(rows)} objects tracked, "
            f"{total / (1024 ** 2):.3f} MiB resident",
            f"{'ObjectID':<44} {'refs':>5} {'task_refs':>9} "
            f"{'present':>8} {'bytes':>12}",
        ]
        for r in rows:
            lines.append(
                f"{r['ObjectID']:<44} {r['LocalRefCount']:>5} "
                f"{r['SubmittedTaskRefCount']:>9} "
                f"{str(r['Present']):>8} {r['SizeBytes']:>12}")
        return "\n".join(lines)

    # --------------------------------------------------------------- jobs
    def job_table(self) -> List[Dict[str, Any]]:
        rt = _runtime()
        return [{
            "JobID": rt.job_id.hex(),
            "Namespace": rt.namespace,
            "Alive": not rt.is_shutdown,
        }]

    def cluster_resources(self) -> Dict[str, float]:
        return _runtime().cluster_resources()

    def available_resources(self) -> Dict[str, float]:
        return _runtime().available_resources()


state = GlobalState()


def actors(actor_id: Optional[str] = None):
    table = state.actor_table()
    return table if actor_id is None else table.get(actor_id)


def nodes():
    return state.node_table()


def memory_summary() -> str:
    return state.memory_summary()


def actor_node_of(handle) -> "Optional[str]":
    """Node id hosting an actor handle (the locality signal behind
    dataset.split(locality_hints=...) — reference dataset.py:735 maps
    hint actors to nodes through the actor table)."""
    actor_id = getattr(handle, "_actor_id", None) or getattr(
        handle, "actor_id", None)
    if actor_id is None:
        return None
    rt = _runtime()
    rec = rt.actor_directory.get(actor_id)
    if rec is None or rec.node_id is None:
        return None
    return rec.node_id.hex()
