"""GCS server — the cluster-global control plane, as its own process.

Process-tier equivalent of the reference's gcs_server
(src/ray/gcs/gcs_server/gcs_server.cc:121-165 composition root;
gcs_server_main.cc:36 entry): node table + heartbeat failure detection
(gcs_heartbeat_manager.cc, num_heartbeats_timeout), internal KV
(gcs_kv_manager.cc), object directory (the GCS fallback of
ownership_based_object_directory.cc), actor management with
restart-on-node-death (gcs_actor_manager.cc:945 ReconstructActor), and
placement-group packing + 2PC driving raylet processes
(gcs_placement_group_scheduler.cc).

Run as ``python -m ray_tpu_torch.cluster.gcs_server --port N``; raylet
processes register over the framed-TCP RPC substrate (cluster/rpc.py).
"""

from __future__ import annotations

import functools
import logging
import threading
import time
from typing import Any, Dict, List, Optional, Set, Tuple

import numpy as np

from ray_tpu_torch._private.config import Config
from ray_tpu_torch.cluster.rpc import RpcClient, RpcConnectionError, RpcServer
from ray_tpu_torch.cluster.threads import ThreadRegistry
from ray_tpu_torch.exceptions import ActorInitError

logger = logging.getLogger(__name__)


def token_deduped(fn):
    """Wrap a GCS mutation RPC handler with the request-token dedupe
    path (reference: the GCS dedupes retried RPCs by request id). The
    wrapper owns the reserved ``token`` kwarg: a client retry after a
    lost ack — or a fault-plane frame duplication — replays the cached
    reply instead of double-applying the mutation (double-counted actor
    restarts, twice-killed actors, double-placed PGs). Handlers declare
    only their domain arguments. raycheck RC04 enforces that every
    registered mutation handler carries this decorator."""

    @functools.wraps(fn)
    def wrapper(self, *args, token: str = "", **kwargs):
        cached = self._token_seen(token)
        if cached is not None:
            return cached
        return self._token_store(token, fn(self, *args, **kwargs))

    wrapper.__raycheck_token_deduped__ = True
    return wrapper


class _NodeRecord:
    __slots__ = ("node_id", "address", "resources", "available", "alive",
                 "last_heartbeat", "missed", "overload", "integrity",
                 "serve", "worker_pool", "threads", "draining",
                 "drain_deadline", "drain_reason", "max_gap_s")

    def __init__(self, node_id: str, address: str,
                 resources: Dict[str, float]):
        self.node_id = node_id
        self.address = address
        self.resources = dict(resources)
        self.available = dict(resources)
        self.alive = True
        self.last_heartbeat = time.monotonic()
        self.missed = 0
        # the longest wait between two of its heartbeats (registration
        # counts as the first): how close the detector came to a verdict
        self.max_gap_s = 0.0
        # drain plane: DRAINING lifecycle state (alive but leaving —
        # placement solves exclude it, actors migrate, sole-copy
        # objects re-replicate; _mark_node_dead finishes the exit)
        self.draining = False
        self.drain_deadline = 0.0  # monotonic; hard-kill fallback past it
        self.drain_reason = ""
        # latest overload-plane counters the node heartbeated (sheds,
        # backpressure, breaker states) — surfaced via cluster_view
        self.overload: Dict = {}
        # latest integrity-plane counters (corruption detections,
        # discarded replicas, verified bytes) — same surfacing
        self.integrity: Dict = {}
        # latest serve-resilience counters (unhealthy replicas,
        # completed drains, router exclusions, backpressure) — same
        self.serve: Dict = {}
        # latest warm worker-pool counters (idle size, warm hits and
        # misses, returns, reaps, create-latency p50) — same
        self.worker_pool: Dict = {}
        # live daemon-thread roots the node last heartbeated
        # ({thread name -> root function label}) — cluster_view
        # carries them so `cli.py status` can show per-node threads
        self.threads: Dict = {}


class _ActorRecord:
    __slots__ = ("actor_id", "name", "cls_bytes", "args_bytes", "resources",
                 "max_restarts", "restarts_used", "state", "node_id",
                 "incarnation", "owner", "placing", "init_error")

    def __init__(self, actor_id: str, cls_bytes: bytes, args_bytes: bytes,
                 resources: Dict[str, float], max_restarts: int,
                 name: str = ""):
        self.actor_id = actor_id
        self.name = name
        self.cls_bytes = cls_bytes
        self.args_bytes = args_bytes
        self.resources = dict(resources)
        self.max_restarts = max_restarts
        self.restarts_used = 0
        self.state = "PENDING"  # PENDING|ALIVE|RESTARTING|DEAD
        self.node_id: Optional[str] = None
        self.incarnation = 0
        self.owner = ""
        self.placing = False  # a placement RPC is in flight
        # deterministic creation failure (class unpickle or __init__
        # raised): the actor is DEAD with this message instead of
        # burning placement retries on other nodes
        self.init_error = ""

    def view(self) -> dict:
        return {
            "actor_id": self.actor_id, "name": self.name,
            "state": self.state, "node_id": self.node_id,
            "incarnation": self.incarnation,
            "restarts_used": self.restarts_used,
            "max_restarts": self.max_restarts,
            "init_error": self.init_error,
        }


class _PgRecord:
    __slots__ = ("pg_id", "bundles", "strategy", "placements", "state",
                 "placing")

    def __init__(self, pg_id: str, bundles: List[Dict[str, float]],
                 strategy: str):
        self.pg_id = pg_id
        self.bundles = bundles
        self.strategy = strategy
        # bundle_index -> node_id
        self.placements: Dict[int, str] = {}
        self.state = "PENDING"  # PENDING|CREATED|RESCHEDULING|REMOVED
        self.placing = False  # a pack/2PC attempt is in flight

    def view(self) -> dict:
        return {"pg_id": self.pg_id, "state": self.state,
                "placements": dict(self.placements),
                "bundles": self.bundles, "strategy": self.strategy}


class GcsService:
    # The device of the burst solve: None means CUDA, as every entry
    # point's; a spawned GCS's warm_device sets it from the rule
    # (_private/device.py:control_plane_device), and a state-only
    # instance (``GcsService.__new__``, as the tests build one) may set
    # another.
    device = None
    warmup_ms: Optional[float] = None  # what warm_device took
    # the burst solves' counters (_record_burst_solve), made at the first
    _burst_stats: Optional[dict] = None

    def __init__(self, heartbeat_period_ms: Optional[int] = None,
                 num_heartbeats_timeout: Optional[int] = None,
                 storage_path: Optional[str] = None):
        from ray_tpu_torch.cluster import fault_plane

        fault_plane.set_process_role("gcs")
        cfg = Config.instance()
        self.heartbeat_period_s = (
            heartbeat_period_ms or cfg.raylet_heartbeat_period_ms) / 1000.0
        self.num_heartbeats_timeout = (
            num_heartbeats_timeout or cfg.num_heartbeats_timeout)
        self._lock = threading.RLock()
        # Request-token dedupe for mutation RPCs (reference: the GCS
        # dedupes retried RPCs by request ids). A client retry after a
        # lost ack — or a fault-plane frame duplication — replays the
        # cached reply instead of double-applying the mutation
        # (double-counted actor restarts, twice-killed actors, ...).
        from collections import OrderedDict

        self._request_tokens: "OrderedDict[str, Any]" = OrderedDict()
        self._request_token_cap = 10_000
        self._nodes: Dict[str, _NodeRecord] = {}
        self._kv: Dict[Tuple[str, bytes], bytes] = {}
        # object directory: object_id -> {node_id}; sizes tracked once
        self._locations: Dict[bytes, Set[str]] = {}
        self._object_sizes: Dict[bytes, int] = {}
        self._location_cv = threading.Condition(self._lock)
        # actor_wait long-poll: waiters block here until a state
        # transition is published (shares self._lock, like the
        # location cv, so the wait predicate reads _actors safely)
        self._actor_cv = threading.Condition(self._lock)
        self._actors: Dict[str, _ActorRecord] = {}
        self._named_actors: Dict[str, str] = {}
        self._pgs: Dict[str, _PgRecord] = {}
        self._change_seq = 0
        # raylet-client cache: get-or-create races between concurrent
        # handler/loop threads would leak duplicate open connections —
        # every read/insert holds _client_lock, with the blocking
        # connect itself outside it (RC01)
        self._clients: Dict[str, RpcClient] = {}  # address -> client
        self._client_lock = threading.Lock()
        # check-and-set under self._lock: detector vs finishing sweep
        self._sweep_running = False
        # nodes whose preemption notice already spawned a drain worker
        # but whose _begin_drain has not run yet — the inline heartbeat
        # handler must not spawn one worker per 100 ms heartbeat
        self._preempt_pending: Set[str] = set()
        # GCS-hosted pubsub channels (reference:
        # gcs_server/pubsub_handler.cc over pubsub/publisher.cc)
        import os as _os

        from ray_tpu_torch.pubsub import Publisher

        # fresh per process: raylets detect a GCS restart by watching
        # this token change in heartbeat replies and re-report state the
        # restarted GCS cannot restore (object locations)
        self.instance_id = _os.urandom(8).hex()
        self.publisher = Publisher()
        # pluggable table storage (reference: gcs_table_storage.h over
        # store_client/); a durable backend makes the GCS restartable
        from ray_tpu_torch.gcs.table_storage import open_table_storage

        self.storage = open_table_storage(storage_path)
        self._restore_from_storage()
        self._stop = threading.Event()
        # every background thread (detector, retry sweeps) spawns
        # through the registry so stop() joins them BY NAME instead of
        # leaking a sweep that is still issuing placement RPCs
        self._threads = ThreadRegistry("gcs")
        self._detector: Optional[threading.Thread] = None
        self.server: Optional[RpcServer] = None

    # ------------------------------------------------------------- serving
    def serve(self, host: str = "127.0.0.1", port: int = 0) -> RpcServer:
        srv = RpcServer(host, port)
        fast = {  # pure bookkeeping: dispatch inline, no thread spawn
            "register_node", "heartbeat", "cluster_view",
            "kv_put", "kv_get", "kv_del", "kv_keys",
            "object_add_location", "object_add_locations",
            "object_remove_location",
            "object_locations", "actor_get", "actor_by_name",
            "actor_list", "pg_get", "job_view", "ping",
            "pubsub_subscribe", "pubsub_unsubscribe", "pubsub_publish",
        }
        for name in (
            "register_node", "heartbeat", "cluster_view", "drain_node",
            "kv_put", "kv_get", "kv_del", "kv_keys",
            "object_add_location", "object_add_locations",
            "object_remove_location",
            "object_locations", "object_wait_location",
            "actor_create", "actor_get", "actor_by_name", "actor_kill",
            "actor_create_batch", "actor_kill_batch",
            "actor_wait",  # long-poll: MUST dispatch on its own thread
            "actor_list", "report_actor_failure",
            "pg_create", "pg_get", "pg_remove", "pg_pending",
            "job_view", "ping",
            "pubsub_subscribe", "pubsub_unsubscribe", "pubsub_publish",
            "pubsub_poll",  # long-poll: MUST dispatch on its own thread
            "collect_timeline",  # fans RPCs to raylets: own thread
        ):
            srv.register(name, getattr(self, name), inline=name in fast)
        srv.start()
        self.server = srv
        self._detector = self._threads.spawn(self._detector_loop,
                                             "gcs-detector")
        # drains interrupted by a GCS restart resume here: the restored
        # record carries the remaining deadline budget, and the worker
        # re-runs migration/re-replication idempotently (already-moved
        # actors are off the node; already-replicated objects have >1
        # location and are no longer sole-copy)
        with self._lock:
            resumable = [nid for nid, rec in self._nodes.items()
                         if rec.alive and rec.draining]
        for nid in resumable:
            self._threads.spawn(
                functools.partial(self._resume_drain, nid),
                f"gcs-drain-resume-{nid[:8]}")
        return srv

    def stop(self) -> None:
        self._stop.set()
        if self.server is not None:
            self.server.stop()
        with self._client_lock:
            clients = list(self._clients.values())
        for c in clients:
            c.close()
        # the detector/sweep threads issue persistence writes: join
        # them (by name, surfacing any hung one) before closing the
        # sqlite connection under them
        self._threads.join_all(timeout=10.0)
        self.storage.close()

    def ping(self) -> str:
        return "pong"

    # -------------------------------------------------- request-token dedupe
    def _token_seen(self, token: str) -> Optional[Any]:
        """Cached reply for a duplicated/retried mutation, or None."""
        if not token:
            return None
        with self._lock:
            return self._request_tokens.get(token)

    def _token_store(self, token: str, reply: Any) -> Any:
        if token:
            with self._lock:
                self._request_tokens[token] = reply
                while len(self._request_tokens) > self._request_token_cap:
                    self._request_tokens.popitem(last=False)
        return reply

    def _row_tokens_resolve(self, rows: List[dict],
                            method: str) -> Dict[int, Any]:
        """Batched per-row dedupe lookup for a ``*_batch`` frame: one
        lock hold resolves every row's ``token`` against the request-
        token cache. Returns {row index: cached result} for rows whose
        mutation already applied — a RETRIED frame (lost ack, client
        reconnect, fault-plane duplication) replays exactly the rows it
        already acked and re-runs only the rest, which is the partial-
        application recovery contract: a frame interrupted mid-fanout
        stored tokens only for the rows that finished."""
        replayed: Dict[int, Any] = {}
        with self._lock:
            for i, row in enumerate(rows):
                tok = row.get("token") or ""
                if tok:
                    cached = self._request_tokens.get(tok)
                    if cached is not None:
                        replayed[i] = cached
        if replayed:
            from ray_tpu_torch.observability import metrics

            metrics.batch_rows_deduped.inc(
                len(replayed), tags={"method": method})
        return replayed

    def _row_tokens_store(self, pairs: List[Tuple[str, Any]]) -> None:
        """Batched store of (row token, row result) pairs under one
        lock hold, AFTER each row's mutation fully applied (rows that
        never finished store nothing, so a retry re-runs them)."""
        pairs = [(t, r) for t, r in pairs if t]
        if not pairs:
            return
        with self._lock:
            for tok, result in pairs:
                self._request_tokens[tok] = result
            while len(self._request_tokens) > self._request_token_cap:
                self._request_tokens.popitem(last=False)

    # -------------------------------------------------------------- pubsub
    # Reference: gcs_server/pubsub_handler.cc — the GCS hosts the
    # cluster-wide channels; clients long-poll over the RPC substrate.
    def pubsub_subscribe(self, subscriber_id: str, channel: str,
                         key: Optional[str] = None) -> dict:
        return self.publisher.subscribe(subscriber_id, channel, key)

    def pubsub_unsubscribe(self, subscriber_id: str,
                           channel: Optional[str] = None,
                           key: Optional[str] = None) -> dict:
        return self.publisher.unsubscribe(subscriber_id, channel, key)

    def pubsub_publish(self, channel: str, key: str, message) -> dict:
        return {"reached": self.publisher.publish(channel, key, message)}

    def pubsub_poll(self, subscriber_id: str,
                    timeout_s: float = 30.0) -> dict:
        return self.publisher.poll(subscriber_id, timeout_s)

    def _publish_actor(self, rec: "_ActorRecord") -> None:
        """Actor state transitions fan out on the ACTOR channel AND
        write through to table storage (reference: gcs_actor_manager
        publishes + persists ActorTableData on every transition)."""
        from ray_tpu_torch.pubsub import ACTOR_CHANNEL

        self.publisher.publish(ACTOR_CHANNEL, rec.actor_id, rec.view())
        self._persist_actor(rec)
        # callers hold self._lock (== the cv's lock): wake actor_wait
        # long-polls so clients see the transition without hot-polling
        self._actor_cv.notify_all()

    # ------------------------------------------------------- table storage
    def _persist_actor(self, rec: "_ActorRecord") -> None:
        import cloudpickle

        from ray_tpu_torch.gcs.table_storage import ACTOR_TABLE

        if rec.state == "DEAD":
            # reclaim the row — dead actors must not accumulate in the
            # table nor re-materialize on restart
            self.storage.delete(ACTOR_TABLE, rec.actor_id.encode())
            return
        self.storage.put(ACTOR_TABLE, rec.actor_id.encode(),
                         cloudpickle.dumps({
                             s: getattr(rec, s) for s in rec.__slots__}))

    def _persist_pg(self, rec: "_PgRecord") -> None:
        import cloudpickle

        from ray_tpu_torch.gcs.table_storage import PG_TABLE

        self.storage.put(PG_TABLE, rec.pg_id.encode(),
                         cloudpickle.dumps({
                             s: getattr(rec, s) for s in rec.__slots__}))

    def _persist_node(self, rec: "_NodeRecord") -> None:
        import cloudpickle

        from ray_tpu_torch.gcs.table_storage import NODE_TABLE

        row = {"node_id": rec.node_id,
               "address": rec.address,
               "resources": rec.resources}
        if rec.draining:
            # persist the drain (with its REMAINING budget) so a GCS
            # restart resumes it instead of stranding a half-migrated
            # node; non-draining rows keep the legacy shape byte-for-
            # byte (drain-plane-off parity)
            row["draining"] = True
            row["drain_reason"] = rec.drain_reason
            row["drain_remaining_s"] = max(
                0.0, rec.drain_deadline - time.monotonic())
        self.storage.put(NODE_TABLE, rec.node_id.encode(),
                         cloudpickle.dumps(row))

    def _restore_from_storage(self) -> None:
        """Rebuild state after a GCS restart (reference:
        gcs_init_data.cc loading every table before serving). Restored
        nodes get a full heartbeat grace window; truly dead ones fall to
        the detector, which then drives actor/PG recovery as usual."""
        import cloudpickle

        from ray_tpu_torch.gcs.table_storage import (
            ACTOR_TABLE,
            KV_TABLE,
            NODE_TABLE,
            PG_TABLE,
        )

        for blob in self.storage.all(NODE_TABLE).values():
            row = cloudpickle.loads(blob)
            rec = _NodeRecord(
                row["node_id"], row["address"], row["resources"])
            if row.get("draining"):
                # resume the interrupted drain (serve() respawns its
                # worker); grant a minimum budget so a restart landing
                # right at the deadline still attempts migration
                rec.draining = True
                rec.drain_reason = row.get("drain_reason", "")
                rec.drain_deadline = time.monotonic() + max(
                    1.0, float(row.get("drain_remaining_s", 0.0)))
            self._nodes[row["node_id"]] = rec
        for blob in self.storage.all(ACTOR_TABLE).values():
            row = cloudpickle.loads(blob)
            if row["state"] == "DEAD":
                continue  # tombstone from an older storage format
            rec = _ActorRecord(row["actor_id"], row["cls_bytes"],
                               row["args_bytes"], row["resources"],
                               row["max_restarts"], row["name"])
            for slot in ("restarts_used", "state", "node_id",
                         "incarnation", "owner"):
                setattr(rec, slot, row[slot])
            rec.placing = False  # in-flight RPCs did not survive
            if rec.state == "RESTARTING":
                # the placement that was in flight died with the old
                # GCS; PENDING puts it back in the retry sweep's set
                rec.state = "PENDING"
            self._actors[rec.actor_id] = rec
            if rec.name:
                self._named_actors[rec.name] = rec.actor_id
        for blob in self.storage.all(PG_TABLE).values():
            row = cloudpickle.loads(blob)
            rec = _PgRecord(row["pg_id"], row["bundles"], row["strategy"])
            rec.placements = dict(row["placements"])
            rec.state = row["state"]
            self._pgs[rec.pg_id] = rec
        for key, value in self.storage.all(KV_TABLE).items():
            ns, k = cloudpickle.loads(key)
            self._kv[(ns, k)] = value
        if self._actors or self._kv or self._pgs or self._nodes:
            logger.info(
                "restored from table storage: %d nodes, %d actors, "
                "%d pgs, %d kv entries", len(self._nodes),
                len(self._actors), len(self._pgs), len(self._kv))

    # ------------------------------------------------------- raylet clients
    def _client_for(self, address: str) -> RpcClient:
        with self._client_lock:
            c = self._clients.get(address)
        if c is not None and not c.closed:
            return c
        # connect OUTSIDE the lock (RC01: the TCP dial blocks); on a
        # lost race the loser closes its own dial instead of leaking it
        fresh = RpcClient(address)
        with self._client_lock:
            cur = self._clients.get(address)
            if cur is not None and not cur.closed:
                c = cur
            else:
                self._clients[address] = fresh
                c = fresh
        if c is not fresh:
            fresh.close()
        return c

    def _client_for_node(self, node_id: str) -> Optional[RpcClient]:
        with self._lock:
            rec = self._nodes.get(node_id)
            if rec is None or not rec.alive:
                return None
            address = rec.address
        try:
            return self._client_for(address)
        except (RpcConnectionError, OSError):
            return None

    # ----------------------------------------------------------- node table
    def register_node(self, node_id: str, address: str,
                      resources: Dict[str, float]) -> dict:
        from ray_tpu_torch.pubsub import NODE_CHANNEL

        with self._lock:
            rec = _NodeRecord(node_id, address, resources)
            old = self._nodes.get(node_id)
            if old is not None and old.draining:
                # a draining node re-announcing itself (reconcile after
                # a GCS restart mid-drain) stays draining: the resumed
                # drain worker reads this record, and a fresh one would
                # silently re-admit the node to placement
                rec.draining = True
                rec.drain_deadline = old.drain_deadline
                rec.drain_reason = old.drain_reason
            self._nodes[node_id] = rec
            self._change_seq += 1
            self.publisher.publish(NODE_CHANNEL, node_id, {
                "alive": True, "address": address, "resources": resources})
            self._persist_node(rec)
        logger.info("node %s registered at %s %s", node_id[:8], address,
                    resources)
        return {"heartbeat_period_ms": self.heartbeat_period_s * 1000,
                "num_heartbeats_timeout": self.num_heartbeats_timeout}

    def heartbeat(self, node_id: str,
                  available: Optional[Dict[str, float]] = None,
                  resources: Optional[Dict[str, float]] = None,
                  overload: Optional[Dict] = None,
                  integrity: Optional[Dict] = None,
                  serve: Optional[Dict] = None,
                  worker_pool: Optional[Dict] = None,
                  preempt_notice_s: Optional[float] = None,
                  threads: Optional[Dict] = None) -> dict:
        start_drain = False
        with self._lock:
            rec = self._nodes.get(node_id)
            if rec is None:
                return {"registered": False}
            now = time.monotonic()
            rec.max_gap_s = max(rec.max_gap_s, now - rec.last_heartbeat)
            rec.last_heartbeat = now
            rec.missed = 0
            if available is not None:
                rec.available = dict(available)
            if resources is not None:
                # totals change when PG bundles commit shadow resources
                rec.resources = dict(resources)
            if overload is not None:
                rec.overload = dict(overload)
            if integrity is not None:
                rec.integrity = dict(integrity)
            if serve is not None:
                rec.serve = dict(serve)
            if worker_pool is not None:
                rec.worker_pool = dict(worker_pool)
            if threads is not None:
                rec.threads = dict(threads)
            was_dead = not rec.alive
            rec.alive = True
            if was_dead:
                self._change_seq += 1
            # drain plane: a raylet-reported preemption notice starts a
            # graceful drain inside the notice window. Heartbeat runs
            # INLINE on the reader thread, so the drain itself goes to
            # a registry worker; _preempt_pending dedupes the spawn
            # across the per-100ms heartbeats until _begin_drain flips
            # rec.draining.
            if (preempt_notice_s is not None
                    and Config.instance().drain_plane_enabled
                    and not rec.draining
                    and node_id not in self._preempt_pending):
                self._preempt_pending.add(node_id)
                start_drain = True
            draining = rec.draining or start_drain
        if start_drain:
            from ray_tpu_torch.observability import metrics

            metrics.preemption_notices.inc(tags={"role": "gcs"})
            self._threads.spawn(
                functools.partial(self._drain_for_preemption, node_id,
                                  float(preempt_notice_s)),
                f"gcs-preempt-drain-{node_id[:8]}")
        reply = {"registered": not was_dead,
                 "gcs_instance": self.instance_id,
                 # the raylet pairs this with its heartbeat RTT to
                 # estimate per-node clock offset (`cli.py timeline`
                 # merges every node's spans onto the GCS clock)
                 # raycheck: disable=RC02 — wall-clock sample for cross-node clock correlation, not deadline arithmetic
                 "server_time": time.time()}
        if draining:
            # only present while draining, so the drain-plane-off reply
            # stays byte-identical to the legacy shape
            reply["draining"] = True
        return reply

    def cluster_view(self) -> dict:
        with self._lock:
            view = {
                "seq": self._change_seq,
                "nodes": {
                    nid: {
                        "address": r.address,
                        "resources": dict(r.resources),
                        "available": dict(r.available),
                        "alive": r.alive,
                        # lifecycle: ALIVE -> (DRAINING) -> DEAD; with
                        # the drain plane off, draining never sets, so
                        # state is a pure function of `alive`
                        "state": ("DEAD" if not r.alive else
                                  "DRAINING" if r.draining else "ALIVE"),
                        "overload": dict(r.overload),
                        "integrity": dict(r.integrity),
                        "serve": dict(r.serve),
                        "worker_pool": dict(r.worker_pool),
                        "threads": dict(r.threads),
                        "heartbeat_max_gap_ms": r.max_gap_s * 1e3,
                    }
                    for nid, r in self._nodes.items()
                },
            }
            draining_now = sum(1 for r in self._nodes.values()
                               if r.alive and r.draining)
        # the GCS's own admission/shed counters ride the same view so
        # `cli.py status` shows overload cluster-wide in one call
        if self.server is not None:
            view["overload"] = self.server.overload_stats()
        # batched actor-lifecycle counters (these metrics live in the
        # GCS process, so the view is the only way clients see them)
        from ray_tpu_torch.observability import metrics

        view["actor_batch"] = {
            "creates_batched": sum(
                metrics.actor_creates_batched.series().values()),
            "kills_batched": sum(
                metrics.actor_kills_batched.series().values()),
        }
        # the actor-burst placer's solves (_batch_assign_actors)
        with self._lock:
            stats = self._burst_counters()
            view["actor_placement"] = {
                k: list(v) if isinstance(v, list) else v
                for k, v in stats.items()}
        # drain/preemption counters live in the GCS process too; the
        # view is how `cli.py status` and the tests read them
        view["drain"] = {
            "nodes_draining": draining_now,
            "drains_completed": sum(
                metrics.drains_completed.series().values()),
            "preemption_notices": sum(
                metrics.preemption_notices.series().values()),
            "objects_rereplicated": sum(
                metrics.objects_rereplicated.series().values()),
        }
        return view

    def collect_timeline(self, per_node_timeout_s: float = 5.0) -> dict:
        """Observability plane: pull every alive node's flight-recorder
        ring (perf_dump) plus the GCS's own, for the clock-offset-
        corrected merge in `cli.py timeline` (reference: `ray timeline`
        rendering the GCS profile table). A dead or slow node becomes
        an error entry instead of stalling the whole collection."""
        from ray_tpu_torch.observability import flight_recorder

        gcs_snap = flight_recorder.global_recorder.snapshot()
        gcs_snap["node_id"] = "gcs"
        # the GCS wall clock is the merge's reference clock
        gcs_snap["clock_offset_s"] = 0.0
        dumps: List[dict] = [gcs_snap]
        with self._lock:
            alive = [nid for nid, rec in self._nodes.items()
                     if rec.alive]
        for nid in alive:
            client = self._client_for_node(nid)
            if client is None:
                dumps.append({"node_id": nid, "error": "unreachable"})
                continue
            try:
                snap = client.call("perf_dump",
                                   timeout=per_node_timeout_s)
                snap.setdefault("node_id", nid)
                dumps.append(snap)
            except Exception as e:  # noqa: BLE001 — per-node isolation
                dumps.append({"node_id": nid, "error": repr(e)})
        return {"dumps": dumps}

    @token_deduped
    def drain_node(self, node_id: str, reason: str = "",
                   deadline_s: Optional[float] = None) -> dict:
        """Explicit graceful removal (ray stop / scale-down /
        preemption). Drain plane ON: DRAINING state + actor migration +
        sole-copy re-replication, bounded by ``deadline_s`` (default
        Config.drain_deadline_s), then deregistration — the handler is
        registered THREADED, so blocking here until the drain finishes
        is the synchronization callers like ProcessCluster.remove_node
        rely on. OFF: the legacy immediate hard-kill recovery.
        Token-deduped (reference: the DrainNode RPC is idempotent): a
        retried frame after a lost ack replays the cached reply instead
        of re-running the migration fan-out."""
        if not Config.instance().drain_plane_enabled:
            self._mark_node_dead(node_id, reason="drained")
            return {"ok": True}
        return self._drain_node_graceful(node_id, reason, deadline_s)

    # ------------------------------------------------- graceful node drain
    def _drain_node_graceful(self, node_id: str, reason: str = "",
                             deadline_s: Optional[float] = None) -> dict:
        cfg = Config.instance()
        budget = cfg.drain_deadline_s if deadline_s is None \
            else float(deadline_s)
        if self._begin_drain(node_id, reason, budget):
            return {"ok": True, "outcome": self._run_drain(node_id)}
        with self._lock:
            rec = self._nodes.get(node_id)
            if rec is None or not rec.alive:
                return {"ok": True, "outcome": "already_dead"}
        # a drain is already in flight (e.g. a preemption notice beat a
        # scale-down request to the same node): join it instead of
        # racing it, so this caller's "drain returned" still means the
        # node is gone
        join_deadline = time.monotonic() + budget + 5.0
        while time.monotonic() < join_deadline:
            with self._lock:
                rec = self._nodes.get(node_id)
                if rec is None or not rec.alive:
                    return {"ok": True, "outcome": "joined"}
            time.sleep(0.05)
        return {"ok": False, "outcome": "join_timeout"}

    def _begin_drain(self, node_id: str, reason: str,
                     deadline_s: float) -> bool:
        """Move NODE to DRAINING: placement solves exclude it from here
        on (pick/pack/batch-assign all test rec.draining), the change is
        published and persisted (a GCS restart resumes the drain), and
        the deadline arms the hard-kill fallback. Returns False if the
        node is unknown, dead, or already draining."""
        from ray_tpu_torch.observability import metrics
        from ray_tpu_torch.pubsub import NODE_CHANNEL

        with self._lock:
            rec = self._nodes.get(node_id)
            if rec is None or not rec.alive or rec.draining:
                return False
            rec.draining = True
            rec.drain_reason = reason or "drain"
            rec.drain_deadline = time.monotonic() + deadline_s
            self._change_seq += 1
            self.publisher.publish(NODE_CHANNEL, node_id, {
                "alive": True, "draining": True,
                "reason": rec.drain_reason})
            self._persist_node(rec)
            draining_now = sum(1 for r in self._nodes.values()
                               if r.alive and r.draining)
        metrics.nodes_draining.set(draining_now)
        logger.info("node %s DRAINING (%s, deadline %.1fs)",
                    node_id[:8], rec.drain_reason, deadline_s)
        return True

    def _run_drain(self, node_id: str) -> str:
        """Execute a drain whose record is already DRAINING: migrate
        actors off (kill-first, so the old incarnation never runs
        concurrently with its replacement), re-replicate sole-copy
        objects to survivors over the data plane, then deregister via
        the ordinary death path. Every step is bounded by the drain
        deadline; whatever is left when it lapses falls to
        _mark_node_dead's recovery (restart + location drop), so a
        wedged drain degrades to hard-kill semantics instead of
        stranding the cluster."""
        from ray_tpu_torch.observability import metrics

        with self._lock:
            rec = self._nodes.get(node_id)
            if rec is None or not rec.alive or not rec.draining:
                return "lost"
            deadline = rec.drain_deadline
            drain_addr = rec.address
            actors = [a for a in self._actors.values()
                      if a.node_id == node_id and a.state == "ALIVE"]
        width = Config.instance().actor_batch_fanout

        def migrate(actor: "_ActorRecord") -> None:
            if time.monotonic() >= deadline:
                return  # leftover: _mark_node_dead restarts it
            client = self._client_for_node(node_id)
            if client is not None:
                try:
                    client.call(
                        "kill_actor", actor_id=actor.actor_id,
                        timeout=max(0.5, min(
                            5.0, deadline - time.monotonic())))
                except Exception as e:
                    # the node is leaving either way; a lost kill frame
                    # means the process dies with the node
                    logger.debug("drain kill of %s on %s failed: %r",
                                 actor.actor_id[:8], node_id[:8], e)
            with self._lock:
                if actor.state != "ALIVE" or actor.node_id != node_id:
                    return  # killed or moved concurrently
                # detach from the draining node BEFORE restarting, so
                # _mark_node_dead's sweep below cannot collect it again
                # and burn a second restart for one migration
                actor.node_id = None
            self._restart_actor(actor, dead_node=node_id)

        self._parallel_each("gcs-drain-migrate", actors, migrate,
                            width=width)
        # quiesce: let the raylet's queued/running tasks finish inside
        # the deadline — their results are objects born DURING the
        # drain, and deregistering while they're in flight would drop
        # the only copy and force a lineage re-execution (a duplicate
        # side effect the exactly-once probe would catch)
        quiesce_client = self._client_for_node(node_id)
        while quiesce_client is not None and \
                time.monotonic() < deadline:
            try:
                stats = quiesce_client.call(
                    "node_stats",
                    timeout=max(0.5, min(5.0,
                                         deadline - time.monotonic())))
            except Exception:
                break  # raylet already gone: nothing left to wait on
            if not stats.get("queued") and not stats.get("running"):
                break
            time.sleep(0.05)
        # sole-copy re-replication: an object whose ONLY replica sits
        # on the draining node would be lost at deregistration — direct
        # a survivor to pull it (chunk-tree data plane underneath)
        # while the holder is still up
        with self._lock:
            sole = [oid for oid, nodes in self._locations.items()
                    if nodes == {node_id}]
            targets = [nid for nid, r in self._nodes.items()
                       if r.alive and not r.draining]
        moved: List[bytes] = []  # list.append is atomic under the GIL
        pairs = ([(oid, targets[i % len(targets)])
                  for i, oid in enumerate(sole)] if targets else [])

        def rereplicate(pair: Tuple[bytes, str]) -> None:
            oid, target = pair
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                return
            client = self._client_for_node(target)
            if client is None:
                return
            try:
                reply = client.call("pull_object", object_id=oid,
                                    from_address=drain_addr,
                                    timeout=max(0.5, remaining))
            except Exception as e:
                logger.debug("drain re-replication of %s -> %s failed: "
                             "%r", oid.hex()[:8], target[:8], e)
                return
            if isinstance(reply, dict) and not reply.get("ok", True):
                return
            moved.append(oid)

        self._parallel_each("gcs-drain-replicate", pairs, rereplicate,
                            width=width)
        if moved:
            metrics.objects_rereplicated.inc(len(moved))
        graceful = (time.monotonic() < deadline
                    and len(moved) == len(sole))
        outcome = "graceful" if graceful else "deadline"
        metrics.drains_completed.inc(tags={"outcome": outcome})
        if not graceful:
            logger.warning(
                "drain of %s hit its deadline (%d/%d sole-copy objects "
                "moved); falling back to hard-kill recovery",
                node_id[:8], len(moved), len(sole))
        self._mark_node_dead(node_id, reason="drained")
        return outcome

    def _drain_for_preemption(self, node_id: str, notice_s: float) -> None:
        """Heartbeat-reported preemption notice -> graceful drain inside
        the notice window (never longer: the node is gone at eviction)."""
        try:
            budget = min(max(0.5, notice_s),
                         Config.instance().drain_deadline_s)
            self._drain_node_graceful(node_id, reason="preempted",
                                      deadline_s=budget)
        except Exception:
            logger.exception("preemption drain of %s failed", node_id[:8])
        finally:
            with self._lock:
                self._preempt_pending.discard(node_id)

    def _resume_drain(self, node_id: str) -> None:
        """Finish a drain interrupted by a GCS restart (the restored
        node record carries the remaining deadline budget)."""
        from ray_tpu_torch.observability import metrics

        try:
            if not Config.instance().drain_plane_enabled:
                # the plane was disabled across the restart: finish the
                # exit the pre-plane way rather than strand the node
                self._mark_node_dead(node_id, reason="drained")
                return
            with self._lock:
                draining_now = sum(1 for r in self._nodes.values()
                                   if r.alive and r.draining)
            metrics.nodes_draining.set(draining_now)
            # the restarted GCS boots with an EMPTY location directory;
            # raylets re-report their objects on their next heartbeat's
            # reconcile — wait for the draining node's re-report (its
            # heartbeat landing post-boot) before snapshotting sole
            # copies, else the re-replication pass sees nothing to move
            boot = time.monotonic()
            settle_until = boot + min(
                2.0, max(0.5, 10 * self.heartbeat_period_s))
            while time.monotonic() < settle_until:
                with self._lock:
                    rec = self._nodes.get(node_id)
                    heard = (rec is not None
                             and rec.last_heartbeat >= boot)
                if heard:
                    # one more beat of grace: the reconcile's location
                    # re-report follows the heartbeat that tripped this
                    time.sleep(2 * self.heartbeat_period_s)
                    break
                time.sleep(0.05)
            self._run_drain(node_id)
        except Exception:
            logger.exception("resumed drain of %s failed", node_id[:8])

    # ------------------------------------------------------ failure detector
    def _detector_loop(self) -> None:
        """Reference: gcs_heartbeat_manager.cc — tick once per heartbeat
        period; a node missing num_heartbeats_timeout consecutive periods
        is declared dead and its recovery fans out."""
        ticks = 0
        while not self._stop.wait(self.heartbeat_period_s):
            now = time.monotonic()
            dead: List[str] = []
            with self._lock:
                for rec in self._nodes.values():
                    if not rec.alive:
                        continue
                    gap = now - rec.last_heartbeat
                    rec.missed = int(gap / self.heartbeat_period_s)
                    if rec.missed >= self.num_heartbeats_timeout:
                        dead.append(rec.node_id)
            for nid in dead:
                self._mark_node_dead(nid, reason="heartbeat timeout")
            ticks += 1
            if ticks % 100 == 0:
                # abandoned subscribers (crashed drivers that never
                # closed) leak mailboxes: reap them periodically
                # (reference: Publisher::CheckDeadSubscribers)
                self.publisher.gc_dead_subscribers()
            if ticks % 10 == 0:
                # capacity may have appeared: retry placements on a
                # separate thread — a sweep can block on 60s create RPCs
                # and must never stall death detection. Check-and-set
                # atomically so a sweep finishing mid-check can't let
                # two sweeps run at once (RC16).
                with self._lock:
                    spawn_sweep = not self._sweep_running
                    if spawn_sweep:
                        self._sweep_running = True
                if spawn_sweep:
                    self._threads.spawn(self._sweep_thread_main,
                                        "gcs-pending-sweep")

    def _sweep_thread_main(self) -> None:
        try:
            self._retry_pending()
        except Exception:
            logger.exception("pending retry sweep failed")
        finally:
            with self._lock:
                self._sweep_running = False

    def _retry_pending(self) -> None:
        """Re-place PENDING actors and re-pack PENDING/RESCHEDULING
        placement groups — capacity appears when tasks finish, nodes
        join, or heartbeats refresh the availability view (reference:
        GcsActorManager retries pending actors on resource change)."""
        with self._lock:
            # _place_actor parks unplaceable actors (fresh or restarting)
            # back in PENDING, so PENDING is the full retry set
            actors = [a for a in self._actors.values()
                      if a.state == "PENDING"]
            pgs = [p for p in self._pgs.values()
                   if p.state in ("PENDING", "RESCHEDULING")]
        assignments = self._batch_assign_actors(actors)
        for rec in actors:
            self._place_actor(rec,
                              preferred_node=assignments.get(rec.actor_id))
        for pg in pgs:
            with self._lock:
                if pg.placing:
                    continue  # an attempt is already in flight
                pg.placing = True
            try:
                if pg.state == "PENDING":
                    placements = self._pack_bundles(pg.bundles,
                                                    pg.strategy)
                    if placements is not None and \
                            self._commit_bundles(pg, placements):
                        pg.state = "CREATED"
                        self._persist_pg(pg)
                else:  # RESCHEDULING: a previous attempt found no room
                    missing = [i for i, n in pg.placements.items()
                               if n not in self._nodes
                               or not self._nodes[n].alive]
                    if missing:
                        dead_node = pg.placements[missing[0]]
                        self._reschedule_pg(pg, dead_node)
            finally:
                pg.placing = False

    def _batch_assign_actors(self, actors) -> Dict[str, str]:
        """Vectorized placement of a pending-actor burst through the
        same policy seam the raylet tick uses: group identical demands
        into scheduling classes, solve all classes against the dense
        node matrix in one pass (fused jit solve + exact int64 repair
        above scheduler_device_solve_min_cells; numpy water-filling
        below), and hand each actor its assigned node. The per-actor
        create RPC stays the commit point — an RPC failure falls back to
        the sequential scorer with the node excluded.

        Reference seam: GcsResourceScheduler / LeastResourceScorer
        (gcs_resource_scheduler.cc:331) — replaced by the batched solve
        rather than an O(actors x nodes) python scan.

        The fused solve runs as torch ops on ``self.device`` (``None``
        means CUDA; a spawned GCS's follows
        ``_private/device.py:control_plane_device``), which a spawned
        GCS warmed before it served (:meth:`warm_device`). The JAX
        package's subprocess probe
        of its backend (``device_solve_available``) has no counterpart:
        a card this process was given and cannot reach raises."""
        from ray_tpu_torch.scheduler.policy import (
            BatchedHybridPolicy,
            SchedulingOptions,
            shared_batched_policy,
        )
        from ray_tpu_torch.scheduler.resources import to_fixed

        cfg = Config.instance()
        if len(actors) < cfg.scheduler_batch_threshold:
            return {}
        with self._lock:
            # draining nodes are alive but leaving: the batch solve
            # must not hand them fresh actors (same exclusion as
            # _pick_node / _pack_bundles)
            nodes = [(nid, dict(rec.resources), dict(rec.available))
                     for nid, rec in self._nodes.items()
                     if rec.alive and not rec.draining]
        if not nodes:
            return {}
        names = sorted({k for _, res, _ in nodes for k in res}
                       | {k for a in actors for k in a.resources})
        idx = {k: i for i, k in enumerate(names)}
        n, r = len(nodes), max(len(names), 1)
        total = np.zeros((n, r), dtype=np.int64)
        avail = np.zeros((n, r), dtype=np.int64)
        for s, (_, res, av) in enumerate(nodes):
            for k, v in res.items():
                total[s, idx[k]] = to_fixed(v)
            for k, v in av.items():
                avail[s, idx[k]] = to_fixed(v)
        classes: Dict[tuple, list] = {}
        for a in actors:
            key = tuple(sorted(a.resources.items()))
            classes.setdefault(key, []).append(a)
        class_list = list(classes.items())
        reqs = np.zeros((len(class_list), r), dtype=np.int64)
        for c, (key, _) in enumerate(class_list):
            for k, v in key:
                reqs[c, idx[k]] = to_fixed(v)
        ks = np.array([len(members) for _, members in class_list],
                      dtype=np.int64)
        opts = SchedulingOptions(
            spread_threshold=cfg.scheduler_spread_threshold)
        alive = np.ones(n, dtype=bool)
        use_device = (
            cfg.scheduler_use_vectorized_policy
            and cfg.scheduler_device_solve_min_cells >= 0
            and n * len(class_list) >= cfg.scheduler_device_solve_min_cells)
        t0 = time.perf_counter()
        if use_device:
            from ray_tpu_torch._private.device import resolve_device

            device = resolve_device(self.device)
            policy = shared_batched_policy(device)
            counts_dev = policy.schedule_tick_fused(
                reqs, ks, total, avail, alive, -1, opts)
            counts = policy.repair_oversubscription(
                reqs, counts_dev.pull(), avail)
        else:
            device = None
            counts = BatchedHybridPolicy().schedule_classes(
                reqs, ks, total, avail, alive, -1, opts)
        self._record_burst_solve(device, len(actors),
                                 (time.perf_counter() - t0) * 1e3)
        out: Dict[str, str] = {}
        for (_, members), row in zip(class_list, counts):
            it = iter(members)
            for slot in np.flatnonzero(row):
                nid = nodes[slot][0]
                for _ in range(int(row[slot])):
                    try:
                        out[next(it).actor_id] = nid
                    except StopIteration:
                        break
        return out

    def _record_burst_solve(self, device, num_actors: int,
                            ms: float) -> None:
        """Counters of the burst solves, surfaced in ``cluster_view``
        (``actor_placement``): the device of the last one, each route's
        count, and the times of the last few solves on each route, in
        ms, with their burst sizes, and what warming the device at start
        took (``warmup_ms``)."""
        with self._lock:
            stats = self._burst_counters()
            route = "host" if device is None else "device"
            stats[f"{route}_solves"] += 1
            if device is not None:
                stats["device"] = str(device)
            recent = stats[f"{route}_ms"]
            recent.append((ms, num_actors))
            del recent[:-8]

    def _burst_counters(self) -> dict:
        if self._burst_stats is None:
            self._burst_stats = {
                "device": None, "device_solves": 0, "host_solves": 0,
                "device_ms": [], "host_ms": [],
                "warmup_ms": self.warmup_ms}
        return self._burst_stats

    @classmethod
    def warm_device(cls) -> None:
        """Set the solve device of this process's GCS from its
        environment (``_private/device.py:control_plane_device``), then
        import torch, take the CUDA context when it is CUDA, and run the
        fused solve at a few node counts, before the GCS restores its
        tables and serves (restored nodes' heartbeat clocks start at
        the restore). Paid inside
        the first burst's ``actor_create_batch`` handler, the import
        alone holds the interpreter long enough that the heartbeat
        handlers fall behind a detector that declares a node dead after
        ``num_heartbeats_timeout`` periods (0.5 s by default), and the
        first launch of each CUDA kernel loads its module. A card that
        CUDA cannot reach raises here, so the GCS exits and its spawner
        sees why."""
        from ray_tpu_torch._private.device import (
            control_plane_device,
            resolve_device,
        )
        from ray_tpu_torch.scheduler.policy import (
            SchedulingOptions,
            shared_batched_policy,
        )

        t0 = time.perf_counter()
        cls.device = control_plane_device()
        policy = shared_batched_policy(resolve_device(cls.device))
        reqs = np.ones((2, 2), dtype=np.int64)
        ks = np.full(2, 3, dtype=np.int64)
        for n in (2, 64, 8192):  # sorts and scans pick kernels by size
            total = np.full((n, 2), 4, dtype=np.int64)
            policy.schedule_tick_fused(
                reqs, ks, total, total, np.ones(n, dtype=bool), -1,
                SchedulingOptions()).pull()
        cls.warmup_ms = (time.perf_counter() - t0) * 1e3

    def _mark_node_dead(self, node_id: str, reason: str) -> None:
        with self._lock:
            rec = self._nodes.get(node_id)
            if rec is None or not rec.alive:
                return
            rec.alive = False
            if rec.draining:
                # the drain (graceful or deadline-forced) ends here;
                # gauge updates stay inside this guard so the drain-
                # plane-off death path is untouched
                rec.draining = False
                from ray_tpu_torch.observability import metrics

                metrics.nodes_draining.set(
                    sum(1 for r in self._nodes.values()
                        if r.alive and r.draining))
            self._change_seq += 1
            # drop every object location on the dead node
            for oid, nodes in list(self._locations.items()):
                nodes.discard(node_id)
                if not nodes:
                    del self._locations[oid]
            self._location_cv.notify_all()
            affected_actors = [a for a in self._actors.values()
                               if a.node_id == node_id
                               and a.state in ("ALIVE", "PENDING")]
            affected_pgs = [p for p in self._pgs.values()
                            if node_id in p.placements.values()
                            and p.state == "CREATED"]
            from ray_tpu_torch.pubsub import NODE_CHANNEL

            self.publisher.publish(NODE_CHANNEL, node_id,
                                   {"alive": False, "reason": reason})
            from ray_tpu_torch.gcs.table_storage import NODE_TABLE

            self.storage.delete(NODE_TABLE, node_id.encode())
        logger.warning("node %s declared DEAD (%s); %d actors, %d pgs "
                       "affected", node_id[:8], reason,
                       len(affected_actors), len(affected_pgs))
        for actor in affected_actors:
            try:
                self._restart_actor(actor, dead_node=node_id)
            except Exception:
                logger.exception("actor %s restart failed",
                                 actor.actor_id[:8])
        for pg in affected_pgs:
            try:
                self._reschedule_pg(pg, dead_node=node_id)
            except Exception:
                logger.exception("pg %s reschedule failed", pg.pg_id[:8])

    # ------------------------------------------------------------------- KV
    def kv_put(self, ns: str, key: bytes, value: bytes) -> dict:
        import cloudpickle

        from ray_tpu_torch.gcs.table_storage import KV_TABLE

        with self._lock:
            self._kv[(ns, key)] = value
            # write-through under the lock: an interleaved delete must
            # not persist in the opposite order it was applied
            self.storage.put(KV_TABLE, cloudpickle.dumps((ns, key)),
                             value)
        return {"ok": True}

    def kv_get(self, ns: str, key: bytes) -> Optional[bytes]:
        with self._lock:
            return self._kv.get((ns, key))

    def kv_del(self, ns: str, key: bytes) -> dict:
        import cloudpickle

        from ray_tpu_torch.gcs.table_storage import KV_TABLE

        with self._lock:
            deleted = self._kv.pop((ns, key), None) is not None
            self.storage.delete(KV_TABLE, cloudpickle.dumps((ns, key)))
        return {"deleted": deleted}

    def kv_keys(self, ns: str, prefix: bytes = b"") -> List[bytes]:
        with self._lock:
            return [k for (n, k) in self._kv if n == ns
                    and k.startswith(prefix)]

    # ----------------------------------------------------- object directory
    def object_add_location(self, object_id: bytes, node_id: str,
                            size: int = 0) -> dict:
        self.object_add_locations(node_id, [(object_id, size)])
        return {"ok": True}

    def object_add_locations(self, node_id: str,
                             entries: List[tuple]) -> dict:
        """Batched location re-report: one RPC for a node's whole
        resident set (used after a GCS restart — per-object RPCs inside
        the heartbeat loop would stall liveness past the death
        threshold)."""
        from ray_tpu_torch.pubsub import OBJECT_LOCATION_CHANNEL

        with self._lock:
            for object_id, size in entries:
                self._locations.setdefault(object_id, set()).add(node_id)
                if size:
                    self._object_sizes[object_id] = size
                self.publisher.publish(OBJECT_LOCATION_CHANNEL,
                                       object_id.hex(),
                                       {"node_id": node_id, "added": True,
                                        "size": size})
            self._location_cv.notify_all()
        return {"ok": True, "count": len(entries)}

    def object_remove_location(self, object_id: bytes, node_id: str) -> dict:
        from ray_tpu_torch.pubsub import OBJECT_LOCATION_CHANNEL

        with self._lock:
            nodes = self._locations.get(object_id)
            if nodes is not None:
                nodes.discard(node_id)
                if not nodes:
                    del self._locations[object_id]
            self.publisher.publish(OBJECT_LOCATION_CHANNEL,
                                   object_id.hex(),
                                   {"node_id": node_id, "added": False})
        return {"ok": True}

    def object_locations(self, object_id: bytes) -> dict:
        with self._lock:
            nodes = [nid for nid in self._locations.get(object_id, ())
                     if self._nodes.get(nid) and self._nodes[nid].alive]
            return {
                "locations": [
                    {"node_id": nid, "address": self._nodes[nid].address}
                    for nid in nodes],
                "size": self._object_sizes.get(object_id, 0),
            }

    def object_wait_location(self, object_id: bytes,
                             timeout_s: float = 30.0) -> dict:
        """Block until at least one live location exists (the directory
        subscription of ownership_based_object_directory.cc, by polling
        condition variable instead of pubsub)."""
        deadline = time.monotonic() + timeout_s
        with self._location_cv:
            while True:
                nodes = [nid for nid in self._locations.get(object_id, ())
                         if self._nodes.get(nid) and self._nodes[nid].alive]
                if nodes:
                    return {
                        "locations": [
                            {"node_id": nid,
                             "address": self._nodes[nid].address}
                            for nid in nodes],
                        "size": self._object_sizes.get(object_id, 0),
                    }
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return {"locations": [],
                            "size": self._object_sizes.get(object_id, 0)}
                self._location_cv.wait(min(remaining, 1.0))

    # ---------------------------------------------------------------- actors
    def _pick_node(self, resources: Dict[str, float],
                   exclude: Optional[Set[str]] = None) -> Optional[str]:
        """Least-loaded feasible node (LeastResourceScorer spirit,
        gcs_resource_scheduler.cc)."""
        exclude = exclude or set()
        best, best_score = None, None
        with self._lock:
            for nid, rec in self._nodes.items():
                # draining nodes are excluded like dead ones: a fresh
                # placement there would just migrate again in seconds
                if not rec.alive or rec.draining or nid in exclude:
                    continue
                if any(rec.resources.get(k, 0.0) < v
                       for k, v in resources.items()):
                    continue
                if any(rec.available.get(k, 0.0) < v
                       for k, v in resources.items()):
                    continue
                # fraction of critical resource left after placement
                score = min(
                    (rec.available.get(k, 0.0) - v)
                    / max(rec.resources.get(k, 1.0), 1e-9)
                    for k, v in resources.items()) if resources else 1.0
                if best_score is None or score > best_score:
                    best, best_score = nid, score
        return best

    @token_deduped
    def actor_create(self, actor_id: str, cls_bytes: bytes,
                     args_bytes: bytes, resources: Dict[str, float],
                     max_restarts: int = 0, name: str = "",
                     owner: str = "") -> dict:
        rec = _ActorRecord(actor_id, cls_bytes, args_bytes, resources,
                           max_restarts, name)
        rec.owner = owner
        with self._lock:
            existing = self._actors.get(actor_id)
            if existing is not None:
                # retried create (client lost the reply): ids are
                # client-generated, so same id = same logical create —
                # dedupe instead of double-placing
                return existing.view()
            if name:
                if name in self._named_actors:
                    raise ValueError(
                        f"actor name {name!r} is already taken")
                self._named_actors[name] = actor_id
            self._actors[actor_id] = rec
            self._persist_actor(rec)
        self._place_actor(rec)
        return rec.view()

    def _place_actor(self, rec: _ActorRecord,
                     exclude: Optional[Set[str]] = None,
                     preferred_node: Optional[str] = None) -> None:
        with self._lock:
            if rec.placing or rec.state in ("ALIVE", "DEAD"):
                # another thread (creation handler vs the pending retry
                # sweep) is placing this actor or already placed it: a
                # duplicate would spawn a second process. (The JAX
                # package checks ``placing`` alone, so a sweep that took
                # a fresh burst's records as PENDING places them again
                # once the burst's own placement has finished; the second
                # create fails for resources and parks the live actor
                # PENDING for good.)
                return
            rec.placing = True
        try:
            self._place_actor_inner(rec, exclude, preferred_node)
        finally:
            rec.placing = False

    def _place_actor_inner(self, rec: _ActorRecord,
                           exclude: Optional[Set[str]] = None,
                           preferred_node: Optional[str] = None) -> None:
        def park() -> None:
            # back to PENDING until capacity appears — but never clobber
            # a concurrent kill (DEAD is terminal)
            with self._lock:
                if rec.state != "DEAD":
                    rec.state = "PENDING"

        # preferred_node comes from the batched placement solve; the
        # create RPC below is the commit point, and on failure we fall
        # back to the per-actor scorer with the node excluded.
        node_id = preferred_node or self._pick_node(rec.resources, exclude)
        if node_id is None:
            park()
            return
        client = self._client_for_node(node_id)
        if client is None:
            park()
            return
        try:
            client.call(
                "create_actor", actor_id=rec.actor_id,
                cls_bytes=rec.cls_bytes, args_bytes=rec.args_bytes,
                resources=rec.resources, incarnation=rec.incarnation,
                timeout=60.0)
        except ActorInitError as e:
            # DETERMINISTIC creation failure (class unpickle or user
            # __init__ raised) — it would fail identically on every
            # node, so mark DEAD with the error instead of burning the
            # whole cluster's placement retries (infra failures take
            # the branch below and stay retryable)
            with self._lock:
                if rec.state != "DEAD":
                    rec.state = "DEAD"
                    rec.init_error = str(e)
                    if rec.name:
                        self._named_actors.pop(rec.name, None)
                    self._change_seq += 1
                    self._publish_actor(rec)
            logger.warning("actor %s creation failed deterministically: "
                           "%s", rec.actor_id[:8], e)
            return
        except Exception:
            # conn loss, timeout, or a raylet-side allocation race: the
            # node is unusable for this actor right now — try the next.
            # Never let an exception escape: _place_actor runs on the
            # detector thread during node-death recovery.
            self._place_actor_inner(rec, (exclude or set()) | {node_id},
                                    preferred_node=None)
            return
        with self._lock:
            if rec.state == "DEAD":
                # killed while the create RPC was in flight: never
                # resurrect — tear the fresh process back down
                reap = self._client_for_node(node_id)
            else:
                rec.node_id = node_id
                rec.state = "ALIVE"
                self._change_seq += 1
                reap = None
                # publish under the same lock hold that mutated the
                # state: a publish outside it could interleave with a
                # concurrent kill's DEAD publish and invert the order
                self._publish_actor(rec)
        if reap is not None:
            try:
                reap.call("kill_actor", actor_id=rec.actor_id,
                          timeout=10.0)
            except Exception as e:
                # the raylet's own kill/GC path reaps the orphan when
                # this teardown RPC is lost
                logger.debug("reap of killed-mid-create actor %s on %s "
                             "failed: %r", rec.actor_id[:8], node_id[:8],
                             e)

    def _restart_actor(self, rec: _ActorRecord, dead_node: str) -> None:
        """gcs_actor_manager.cc:945 ReconstructActor with max_restarts
        (:961-971): infinite when -1, else bounded."""
        with self._lock:
            if rec.state == "DEAD":
                return
            unlimited = rec.max_restarts < 0
            if not unlimited and rec.restarts_used >= rec.max_restarts:
                rec.state = "DEAD"
                self._change_seq += 1
                logger.warning("actor %s is out of restarts -> DEAD",
                               rec.actor_id[:8])
                self._publish_actor(rec)
                return
            rec.restarts_used += 1
            rec.incarnation += 1
            rec.state = "RESTARTING"
            self._change_seq += 1
            self._publish_actor(rec)
        self._place_actor(rec, exclude={dead_node})

    @token_deduped
    def report_actor_failure(self, actor_id: str) -> dict:
        """Caller-observed actor-process death (e.g. worker crash without
        node death): restart in place or elsewhere. Token-deduped — a
        duplicated report must not burn two restarts for one death."""
        with self._lock:
            rec = self._actors.get(actor_id)
            if rec is None:
                return {"ok": False}
            node = rec.node_id or ""
        self._restart_actor(rec, dead_node="")
        return {"ok": True, "prev_node": node}

    def actor_get(self, actor_id: str) -> dict:
        with self._lock:
            rec = self._actors.get(actor_id)
            if rec is None:
                raise KeyError(f"no actor {actor_id}")
            view = rec.view()
            if rec.node_id and rec.node_id in self._nodes:
                view["address"] = self._nodes[rec.node_id].address
            return view

    def actor_wait(self, actor_id: str, timeout_s: float = 30.0) -> dict:
        """Long-poll until the actor leaves PENDING/RESTARTING limbo
        (ALIVE with a node, or DEAD) or the timeout lapses — the
        wait_object pattern applied to actor state, replacing the
        client's actor_get + sleep hot-poll. Registered THREADED (never
        inline): a waiter parks a dispatch thread, not the reader."""
        deadline = time.monotonic() + timeout_s
        with self._actor_cv:
            while True:
                rec = self._actors.get(actor_id)
                if rec is None:
                    raise KeyError(f"no actor {actor_id}")
                settled = (rec.state == "DEAD"
                           or (rec.state == "ALIVE" and rec.node_id))
                remaining = deadline - time.monotonic()
                if settled or remaining <= 0:
                    view = rec.view()
                    if rec.node_id and rec.node_id in self._nodes:
                        view["address"] = self._nodes[rec.node_id].address
                    return view
                # wake periodically even without a notify: a GCS restart
                # or missed transition must not park the waiter forever
                self._actor_cv.wait(min(remaining, 1.0))

    def actor_by_name(self, name: str) -> dict:
        with self._lock:
            actor_id = self._named_actors.get(name)
        if actor_id is None:
            raise KeyError(f"no actor named {name!r}")
        return self.actor_get(actor_id)

    def actor_list(self) -> List[dict]:
        with self._lock:
            return [a.view() for a in self._actors.values()]

    @token_deduped
    def actor_kill(self, actor_id: str, no_restart: bool = True) -> dict:
        # token-deduped: a duplicated kill-with-restart must not
        # consume two restarts
        return self._actor_kill_inner(actor_id, no_restart)

    def _actor_kill_inner(self, actor_id: str, no_restart: bool) -> dict:
        with self._lock:
            rec = self._actors.get(actor_id)
            if rec is None:
                return {"ok": False}
            node_id = rec.node_id
            if no_restart:
                rec.state = "DEAD"
                if rec.name:
                    self._named_actors.pop(rec.name, None)
                self._publish_actor(rec)
        client = self._client_for_node(node_id) if node_id else None
        if client is not None:
            try:
                client.call("kill_actor", actor_id=actor_id, timeout=10.0)
            except Exception as e:
                # actor record is already DEAD; an unreachable host node
                # means the process dies with it
                logger.debug("kill_actor %s on %s failed: %r",
                             actor_id[:8], node_id[:8], e)
        if not no_restart:
            # kill-with-restart recreates the actor (consuming a restart,
            # like any other death) so the record never points at a node
            # that no longer hosts it
            self._restart_actor(rec, dead_node="")
        return {"ok": True}

    # ------------------------------------------- batched actor lifecycle
    def _parallel_each(self, name: str, items: List, fn,
                       width: int) -> None:
        """Fan ``fn(item)`` across up to WIDTH registry threads and join
        them — the parallel replacement for the serial per-record loops
        in the batch handlers. Exceptions are logged, never propagated:
        per-record outcomes are read from the records afterwards."""
        import itertools

        if not items:
            return
        if width <= 1 or len(items) == 1:
            for item in items:
                try:
                    fn(item)
                except Exception:
                    logger.exception("%s: batch entry failed", name)
            return
        counter = itertools.count()  # .__next__ is atomic in CPython

        def drain() -> None:
            while True:
                i = next(counter)
                if i >= len(items):
                    return
                try:
                    fn(items[i])
                except Exception:
                    logger.exception("%s: batch entry failed", name)

        workers = [self._threads.spawn(drain, f"{name}-{t}")
                   for t in range(min(width, len(items)))]
        # budgeted join (RC17): a worker wedged on one record's RPC
        # must not hang the whole batch handler forever
        deadline = (time.monotonic()
                    + Config.instance().batch_fanout_join_timeout_s)
        for w in workers:
            w.join(max(0.0, deadline - time.monotonic()))
            if w.is_alive():
                logger.warning("%s: worker %s still busy past join "
                               "budget", name, w.name)

    @token_deduped
    def actor_create_batch(self, creates: List[dict]) -> dict:
        """Coalesced creates: register every record under ONE lock
        hold, solve placement for the whole batch in one pass, then fan
        the create RPCs across raylets in parallel — the serial
        register->place->ack chain is what capped creation at a few
        actors per second. The reply carries one result row per input
        row (rec.view() + error), so partial failure is typed per
        actor, never a batch-wide exception. One token dedupes the
        whole frame; each row's own ``token`` dedupes that row across
        frames, so a retry after a lost ack re-runs only the rows this
        server never finished."""
        from ray_tpu_torch.observability import metrics

        # On an exception mid-frame the reply is never acked, so leaving
        # the rows' tokens unstored is load-bearing: the sender's retry
        # must re-apply exactly the rows this pass never finished.
        # raycheck: disable=RC12 — tokens intentionally unstored on error
        replayed = self._row_tokens_resolve(creates, "actor_create_batch")
        todo = [row for i, row in enumerate(creates) if i not in replayed]
        rows_by_id: Dict[str, dict] = {}
        fresh: List[_ActorRecord] = []
        with self._lock:
            for row in todo:
                actor_id = row["actor_id"]
                existing = self._actors.get(actor_id)
                if existing is not None:
                    # retried batch row: same dedupe-by-id contract as
                    # the serial actor_create
                    rows_by_id[actor_id] = existing.view()
                    continue
                name = row.get("name", "")
                if name and name in self._named_actors:
                    rows_by_id[actor_id] = {
                        "actor_id": actor_id, "state": "ERROR",
                        "error": f"actor name {name!r} is already taken"}
                    continue
                rec = _ActorRecord(actor_id, row["cls_bytes"],
                                   row["args_bytes"],
                                   row.get("resources") or {},
                                   row.get("max_restarts", 0), name)
                rec.owner = row.get("owner", "")
                if name:
                    self._named_actors[name] = actor_id
                self._actors[actor_id] = rec
                self._persist_actor(rec)
                fresh.append(rec)
        assignments = self._batch_assign_actors(fresh)
        self._parallel_each(
            "gcs-batch-place", fresh,
            lambda rec: self._place_actor(
                rec, preferred_node=assignments.get(rec.actor_id)),
            width=Config.instance().actor_batch_fanout)
        metrics.actor_creates_batched.inc(len(creates))
        with self._lock:
            for rec in fresh:
                view = rec.view()
                if rec.init_error:
                    view["error"] = rec.init_error
                rows_by_id[rec.actor_id] = view
        results: List[dict] = []
        store: List[Tuple[str, Any]] = []
        for i, row in enumerate(creates):
            if i in replayed:
                results.append(replayed[i])
                continue
            res = rows_by_id[row["actor_id"]]
            results.append(res)
            store.append((row.get("token") or "", res))
        self._row_tokens_store(store)
        return {"results": results}

    @token_deduped
    def actor_kill_batch(self, kills: List[dict]) -> dict:
        """Coalesced kills: mark every record DEAD under ONE lock hold,
        then send each hosting raylet ONE kill_actor_batch frame (fanned
        in parallel across nodes) instead of a serial 10s-timeout RPC
        per actor — the path that took minutes to tear down a few
        thousand actors. Per-row results; one token per frame, plus a
        per-row ``token`` so a retried frame replays the rows it
        already applied instead of double-killing (a kill-with-restart
        row applied twice would consume TWO restarts)."""
        from ray_tpu_torch.observability import metrics

        # On an exception mid-frame the reply is never acked; unstored
        # tokens make the sender's retry re-apply the unfinished rows
        # (exactly-once by re-execution).
        # raycheck: disable=RC12 — tokens intentionally unstored on error
        replayed = self._row_tokens_resolve(kills, "actor_kill_batch")
        by_node: Dict[str, List[str]] = {}
        restart_recs: List[_ActorRecord] = []
        rows_out: Dict[int, dict] = {}
        with self._lock:
            for i, row in enumerate(kills):
                if i in replayed:
                    continue
                actor_id = row["actor_id"]
                no_restart = row.get("no_restart", True)
                rec = self._actors.get(actor_id)
                if rec is None:
                    rows_out[i] = {"actor_id": actor_id, "ok": False}
                    continue
                if rec.node_id:
                    by_node.setdefault(rec.node_id, []).append(actor_id)
                if no_restart:
                    rec.state = "DEAD"
                    if rec.name:
                        self._named_actors.pop(rec.name, None)
                    self._change_seq += 1
                    self._publish_actor(rec)
                else:
                    restart_recs.append(rec)
                rows_out[i] = {"actor_id": actor_id, "ok": True}

        def kill_on_node(entry: Tuple[str, List[str]]) -> None:
            node_id, actor_ids = entry
            client = self._client_for_node(node_id)
            if client is None:
                return  # node dead: its processes die with it
            try:
                client.call("kill_actor_batch", actor_ids=actor_ids,
                            timeout=30.0)
            except Exception as e:
                # records are already DEAD; the raylet's own GC reaps
                # orphans if this teardown frame is lost
                logger.debug("kill_actor_batch on %s failed: %r",
                             node_id[:8], e)

        self._parallel_each("gcs-batch-kill", list(by_node.items()),
                            kill_on_node,
                            width=Config.instance().actor_batch_fanout)
        for rec in restart_recs:
            # kill-with-restart keeps the serial semantics: consume a
            # restart and re-place (rare path, not worth batching)
            self._restart_actor(rec, dead_node="")
        metrics.actor_kills_batched.inc(len(kills))
        results = []
        store: List[Tuple[str, Any]] = []
        for i, row in enumerate(kills):
            if i in replayed:
                results.append(replayed[i])
                continue
            results.append(rows_out[i])
            store.append((row.get("token") or "", rows_out[i]))
        self._row_tokens_store(store)
        return {"results": results}

    # -------------------------------------------------------- placement grp
    def pg_pending(self) -> dict:
        """Bundle demands of placement groups not yet placed — the
        autoscaler's PG demand feed (reference: pending PG bundles ride
        the resource reports into LoadMetrics.pending_placement_groups).
        """
        with self._lock:
            return {"pending": [[dict(b) for b in p.bundles]
                                for p in self._pgs.values()
                                if p.state == "PENDING"]}

    @token_deduped
    def pg_create(self, pg_id: str, bundles: List[Dict[str, float]],
                  strategy: str = "PACK") -> dict:
        rec = _PgRecord(pg_id, bundles, strategy)
        rec.placing = True  # registered mid-flight: sweep must not race
        with self._lock:
            existing = self._pgs.get(pg_id)
            if existing is not None:
                # retried create: dedupe by id
                return existing.view()
            self._pgs[pg_id] = rec
        try:
            placements = self._pack_bundles(bundles, strategy)
            if placements is None:
                rec.state = "PENDING"
                return rec.view()
            ok = self._commit_bundles(rec, placements)
            rec.state = "CREATED" if ok else "PENDING"
            return rec.view()
        finally:
            rec.placing = False
            self._persist_pg(rec)

    def _pack_bundles(self, bundles: List[Dict[str, float]], strategy: str,
                      exclude: Optional[Set[str]] = None
                      ) -> Optional[Dict[int, str]]:
        """Greedy scored packing over the live resource view (the
        GcsScheduleStrategy family, gcs_placement_group_scheduler.cc).
        Returns bundle_index -> node_id, or None if infeasible."""
        exclude = exclude or set()
        with self._lock:
            avail = {nid: dict(r.available) for nid, r in self._nodes.items()
                     if r.alive and not r.draining and nid not in exclude}
        placements: Dict[int, str] = {}
        order = sorted(range(len(bundles)),
                       key=lambda i: -sum(bundles[i].values()))
        for i in order:
            demand = bundles[i]
            candidates = [
                nid for nid, a in avail.items()
                if all(a.get(k, 0.0) >= v for k, v in demand.items())]
            if strategy in ("SPREAD", "STRICT_SPREAD"):
                unused = [n for n in candidates if n not in
                          placements.values()]
                if strategy == "STRICT_SPREAD":
                    candidates = unused
                elif unused:
                    candidates = unused
            elif strategy == "STRICT_PACK":
                if placements:
                    first = next(iter(placements.values()))
                    candidates = [n for n in candidates if n == first]
            else:  # PACK: prefer nodes already used
                used = [n for n in candidates if n in placements.values()]
                if used:
                    candidates = used
            if not candidates:
                return None
            # least-loaded first among candidates
            nid = max(candidates, key=lambda n: min(
                (avail[n].get(k, 0.0) - v) / max(v, 1e-9)
                for k, v in demand.items()) if demand else 0.0)
            placements[i] = nid
            for k, v in demand.items():
                avail[nid][k] = avail[nid].get(k, 0.0) - v
        return placements

    def _commit_bundles(self, rec: _PgRecord,
                        placements: Dict[int, str]) -> bool:
        """2PC against raylet processes: prepare everywhere, then commit;
        roll back prepared bundles if any prepare fails (the raylet-side
        contract of placement_group_resource_manager.h).

        Both phases are idempotent on the raylet (keyed by
        (pg_id, bundle_index)), so commits are RETRIED on transient
        failures instead of fire-and-forgotten — a dropped commit frame
        must not leave a PG marked CREATED with a bundle whose shadow
        resources never applied (lost placement). A commit that finds
        its prepare lease expired re-prepares and tries again; a commit
        that cannot land within its window rolls the whole attempt back
        (return_bundle everywhere, also idempotent) and reports failure
        so the pending sweep re-packs from a clean slate."""
        prepared: List[Tuple[int, str]] = []
        for index, node_id in placements.items():
            client = self._client_for_node(node_id)
            ok = False
            if client is not None:
                try:
                    ok = client.call(
                        "prepare_bundle", pg_id=rec.pg_id,
                        bundle_index=index, bundle=rec.bundles[index],
                        timeout=30.0)
                except Exception:
                    ok = False
            if not ok:
                self._rollback_bundles(rec, prepared)
                return False
            prepared.append((index, node_id))
        for index, node_id in placements.items():
            if not self._commit_one(rec, index, node_id):
                self._rollback_bundles(rec, list(placements.items()))
                return False
        with self._lock:
            rec.placements = dict(placements)
        return True

    def _commit_one(self, rec: _PgRecord, index: int, node_id: str,
                    window_s: float = 10.0) -> bool:
        """Land one commit_bundle, retrying through connection loss and
        re-preparing if the raylet's prepare lease expired meanwhile.
        Safe because commit is idempotent raylet-side."""
        bundle = rec.bundles[index]
        deadline = time.monotonic() + window_s
        attempt = 0
        while True:
            client = self._client_for_node(node_id)
            reply = None
            if client is not None:
                try:
                    reply = client.call(
                        "commit_bundle", pg_id=rec.pg_id,
                        bundle_index=index, bundle=bundle, timeout=10.0)
                except Exception:
                    reply = None
            if isinstance(reply, dict) and reply.get("ok", True):
                return True
            if isinstance(reply, dict) and not reply.get("ok", True):
                # prepare lease expired under us: re-reserve, then retry
                try:
                    if client is None or not client.call(
                            "prepare_bundle", pg_id=rec.pg_id,
                            bundle_index=index, bundle=bundle,
                            timeout=10.0):
                        return False  # capacity is gone: full rollback
                except Exception as e:
                    # transient: the surrounding loop re-attempts the
                    # commit until its window closes
                    logger.debug("re-prepare of %s[%d] on %s failed: "
                                 "%r", rec.pg_id[:8], index,
                                 node_id[:8], e)
            if time.monotonic() >= deadline:
                return False
            time.sleep(min(0.05 * (2 ** attempt), 1.0))
            attempt += 1

    def _rollback_bundles(self, rec: _PgRecord,
                          entries: List[Tuple[int, str]]) -> None:
        """Best-effort return of prepared/committed bundles after a
        failed 2PC attempt (idempotent raylet-side; unreachable nodes
        are backstopped by the prepare-lease expiry)."""
        for index, node_id in entries:
            client = self._client_for_node(node_id)
            if client is None:
                continue
            try:
                client.call("return_bundle", pg_id=rec.pg_id,
                            bundle_index=index,
                            bundle=rec.bundles[index],
                            committed=True, timeout=30.0)
            except Exception as e:
                # best-effort: the raylet's prepare-lease expiry
                # backstops a rollback that cannot reach the node
                logger.debug("2PC rollback of %s[%d] on %s failed: %r",
                             rec.pg_id[:8], index, node_id[:8], e)

    def _reschedule_pg(self, rec: _PgRecord, dead_node: str) -> None:
        """Bundles on a dead node move; surviving bundles stay put
        (gcs_placement_group_manager.cc node-death path). Callers other
        than the sweep (which claims rec.placing itself) run from
        _mark_node_dead, where a concurrent sweep attempt on the same PG
        is blocked by the placing flag check below."""
        with self._lock:
            if rec.placing and rec.state == "RESCHEDULING":
                return  # another reschedule is already in flight
            rec.state = "RESCHEDULING"
            lost = {i: n for i, n in rec.placements.items()
                    if n == dead_node}
        lost_sorted = sorted(lost)
        lost_bundles = [rec.bundles[i] for i in lost_sorted]
        repacked = self._pack_bundles(lost_bundles, rec.strategy,
                                      exclude={dead_node})
        if repacked is None:
            logger.warning("pg %s cannot reschedule %d bundles",
                           rec.pg_id[:8], len(lost))
            return
        # repacked is keyed by position in lost_bundles, which was built
        # from lost_sorted — map each slot back to its original index
        new_placements: Dict[int, str] = {}
        for j, i in enumerate(lost_sorted):
            new_placements[i] = repacked[j]
        sub = _PgRecord(rec.pg_id, rec.bundles, rec.strategy)
        if self._commit_bundles(sub, new_placements):
            with self._lock:
                rec.placements.update(new_placements)
                rec.state = "CREATED"
                self._change_seq += 1
            self._persist_pg(rec)

    def pg_get(self, pg_id: str) -> dict:
        with self._lock:
            rec = self._pgs.get(pg_id)
            if rec is None:
                raise KeyError(f"no placement group {pg_id}")
            return rec.view()

    @token_deduped
    def pg_remove(self, pg_id: str) -> dict:
        with self._lock:
            rec = self._pgs.pop(pg_id, None)
        if rec is None:
            return {"ok": False}
        for index, node_id in rec.placements.items():
            client = self._client_for_node(node_id)
            if client is not None:
                try:
                    client.call("return_bundle", pg_id=pg_id,
                                bundle_index=index,
                                bundle=rec.bundles[index], committed=True,
                                timeout=30.0)
                except RpcConnectionError as e:
                    # node unreachable: the prepare-lease expiry (or
                    # node death) reclaims its bundle server-side
                    logger.debug("pg_remove %s: return_bundle[%d] to "
                                 "%s failed: %r", pg_id[:8], index,
                                 node_id[:8], e)
        rec.state = "REMOVED"
        from ray_tpu_torch.gcs.table_storage import PG_TABLE

        self.storage.delete(PG_TABLE, pg_id.encode())
        return {"ok": True}

    # ------------------------------------------------------------------ jobs
    def job_view(self) -> dict:
        from ray_tpu_torch.observability.metrics import actors_alive

        with self._lock:
            alive_actors = sum(1 for a in self._actors.values()
                               if a.state == "ALIVE")
            actors_alive.set(alive_actors)
            return {
                "nodes": len(self._nodes),
                "alive": sum(1 for r in self._nodes.values() if r.alive),
                "actors": len(self._actors),
                "actors_alive": alive_actors,
                "objects": len(self._locations),
                "pgs": len(self._pgs),
            }


def main(argv: Optional[List[str]] = None) -> None:
    import argparse

    parser = argparse.ArgumentParser()
    parser.add_argument("--host", default="127.0.0.1")
    parser.add_argument("--port", type=int, default=0)
    parser.add_argument("--heartbeat-period-ms", type=int, default=None)
    parser.add_argument("--num-heartbeats-timeout", type=int, default=None)
    parser.add_argument("--storage", default="",
                        help="sqlite path for durable table storage")
    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    # arm the crash-dump hooks (SIGUSR2 / uncaught exception → JSONL)
    from ray_tpu_torch.observability import flight_recorder
    flight_recorder.install()
    GcsService.warm_device()
    svc = GcsService(args.heartbeat_period_ms, args.num_heartbeats_timeout,
                     storage_path=args.storage or None)
    srv = svc.serve(args.host, args.port)
    # announce the bound port on stdout for the parent to scrape
    print(f"GCS_ADDRESS {srv.address}", flush=True)
    try:
        threading.Event().wait()
    except KeyboardInterrupt:
        svc.stop()


if __name__ == "__main__":
    main()
