"""Raylet server — the per-node daemon, as its own process.

Process-tier equivalent of the reference raylet (src/ray/raylet/main.cc:72
entry; node_manager.h:140 NodeManager): hosts the node's object store,
leases OS worker processes (cluster/process_pool.py) for task execution,
resolves task-argument dependencies by pulling objects from peer raylets
(the object-transfer plane of object_manager.cc:302,463,509 — chunked
push/pull over the framed-TCP RPC substrate, admission-gated by
scheduler/pull_manager.py), registers object locations with the GCS
directory, heartbeats the GCS failure detector, and serves the
placement-group bundle 2PC (placement_group_resource_manager.h).

Run as ``python -m ray_tpu_torch.cluster.raylet_server --gcs HOST:PORT``.
SIGKILLing this process is a *node death*: its worker children exit when
their control pipes close, the GCS detector declares the node dead after
``num_heartbeats_timeout`` missed beats, and owners re-submit lost work.
"""

from __future__ import annotations

import itertools
import logging
import os
import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional, Tuple

from ray_tpu_torch._private.config import Config
from ray_tpu_torch.cluster import integrity, protocol
from ray_tpu_torch.cluster import overload as _overload
from ray_tpu_torch.cluster.byte_store import ByteStore, PushManager, shm_key
from ray_tpu_torch.cluster.process_pool import ProcessWorkerPool
from ray_tpu_torch.cluster.rpc import RpcClient, RpcConnectionError, RpcServer
from ray_tpu_torch.cluster.threads import ThreadRegistry
from ray_tpu_torch.exceptions import (
    ActorInitError,
    ObjectCorruptedError,
    RetryLaterError,
    WorkerCrashedError,
)

logger = logging.getLogger(__name__)


class _QueuedTask:
    __slots__ = ("spec", "attempts")

    def __init__(self, spec: dict):
        self.spec = spec
        self.attempts = 0


class RayletServer:
    def __init__(self, gcs_address: str,
                 resources: Optional[Dict[str, float]] = None,
                 num_workers: int = 2, node_id: Optional[str] = None,
                 object_store_memory: Optional[int] = None):
        from ray_tpu_torch._private.ids import NodeID
        from ray_tpu_torch.cluster import fault_plane

        fault_plane.set_process_role("raylet")
        self.node_id = node_id or NodeID.from_random().hex()
        self.gcs_address = gcs_address
        from ray_tpu_torch.cluster.rpc import ReconnectingRpcClient

        # survives GCS restarts: directory/pubsub/KV calls retry through
        # a fresh connection while the heartbeat loop re-registers us
        self.gcs = ReconnectingRpcClient(gcs_address)
        # dropped-replica ids queue here; a background flusher
        # deregisters their GCS locations (eviction must never block on
        # a GCS round trip)
        # raycheck: disable=RC10 — growth is bounded by eviction churn (entries are 28-byte ids of replicas the bounded store just dropped); a maxlen would silently leak stale GCS directory entries instead
        self._dropped_replicas: deque = deque()
        self.store = ByteStore(
            object_store_memory,
            on_replica_dropped=self._dropped_replicas.append)
        self.push_manager = PushManager(self._send_push)
        # inbound chunked pushes being reassembled: oid -> state; and an
        # event for pulls to wait on instead of double-fetching
        self._inbound_lock = threading.Lock()
        self._inbound_pushes: Dict[bytes, dict] = {}
        # chunk-tree failover: (object_id, dest) pairs whose next push
        # is a re-root re-offer — push_begin travels with reroot=True
        # so the orphaned receiver supersedes its half-open inbound
        # instead of declining until the stale sweep
        self._reroot_lock = threading.Lock()
        self._reroot_pending: set = set()
        self.resources = dict(resources or {"CPU": float(num_workers)})
        self._avail_lock = threading.RLock()
        self.available = dict(self.resources)
        # worker stderr lines fan out on the GCS LOG channel, keyed by
        # node (reference: log_monitor.py tails worker logs and publishes
        # them for the driver to print). Log state must exist BEFORE the
        # pool: workers spawn in its ctor and drain threads start at once.
        self._log_lock = threading.Lock()
        self._log_buffer: deque = deque(maxlen=10_000)  # drop-oldest
        self._log_flusher: Optional[threading.Thread] = None
        self._stop = threading.Event()
        # background threads spawn through the registry so shutdown()
        # joins them by name (a hung teardown surfaces its culprit);
        # must exist before the pool — workers spawn in its ctor and
        # the log flusher can start at once
        self._threads = ThreadRegistry(f"raylet-{self.node_id[:8]}")
        # explicit seeded stream (raycheck RC03): replica-shuffle
        # decisions replay under a fault plan's single seed instead of
        # drawing from the process-global RNG
        self._pull_rng = fault_plane.derive_rng(
            f"raylet-pull|{self.node_id}")
        # workers (and their subprocesses, e.g. job entrypoints) learn
        # their node through the environment
        import os as _os

        _os.environ["RAY_TPU_NODE_ID"] = self.node_id
        # workers attach the node's shm segment: large task args and
        # results move through shared memory, not the control pipe
        # (plasma worker-mmap contract)
        _cfg = Config.instance()
        self.pool = ProcessWorkerPool(
            size=num_workers,
            shm_path=self.store.shm_path or "",
            log_callback=self._publish_log,
            # warm actor-worker pool (worker_pool.cc prestart): off ⇒
            # exact fork-per-actor behavior
            warm_size=(_cfg.worker_pool_warm_size
                       if _cfg.worker_pool_enabled else 0),
            threads=self._threads)
        from collections import OrderedDict

        # raycheck: disable=RC10 — bounded by the submit_task admission check (raylet_max_queued_tasks): over-bound submits are shed with RetryLaterError, never enqueued
        self._task_queue: deque[_QueuedTask] = deque()
        self._queue_cv = threading.Condition()
        # guards the plain int/float stats counters (num_*, ct_*):
        # they are bumped from dispatch/handler threads and read by
        # node_stats — a bare += is a lost-update race (raycheck RC16).
        # Hold it only for the increment/read itself, never across
        # calls.
        self._stats_lock = threading.Lock()
        self.num_tasks_shed = 0  # submits pushed back (backpressure)
        self._running: Dict[str, dict] = {}
        # task_id -> "done"|"failed"; LRU-bounded so a long-lived node
        # does not grow one entry per task forever
        self._done: "OrderedDict[str, str]" = OrderedDict()
        self._done_cap = 100_000
        # per-row batch-frame dedupe (exactly-once submit rows): row
        # token -> cached reply row, LRU-bounded, guarded by _queue_cv
        self._row_tokens: "OrderedDict[str, dict]" = OrderedDict()
        self._row_token_cap = 100_000
        self._actors: Dict[str, dict] = {}
        self._actor_lock = threading.RLock()
        # peer-client cache: get-or-create races between concurrent
        # handlers (pull/push/actor paths) would leak duplicate open
        # connections — every read/insert holds _peer_lock, with the
        # blocking connect itself outside it (RC01)
        self._peer_clients: Dict[str, RpcClient] = {}
        self._peer_lock = threading.Lock()
        # PG 2PC bundle state, all under _avail_lock: prepared
        # reservations (with lease timestamps, so a GCS that dies
        # between prepare and commit cannot leak the reservation) and
        # the committed set making commit/return idempotent under
        # frame duplication and GCS retries.
        self._prepared_bundles: Dict[Tuple[str, int], Dict[str, float]] = {}
        self._prepared_at: Dict[Tuple[str, int], float] = {}
        self._committed_bundles: set = set()
        self.server: Optional[RpcServer] = None
        self._pull_lock = threading.Lock()
        self._inflight_pulls: Dict[bytes, threading.Event] = {}
        # drain plane: monotonic eviction deadline of a pending
        # preemption notice (None = no notice). Written by the
        # preempt_notice RPC, read by the heartbeat loop, which
        # reports the REMAINING window so the GCS can drain inside it.
        # Both drain-plane flags cross the preempt-handler /
        # heartbeat / node_stats threads, so _drain_lock guards every
        # access (RC16).
        self._drain_lock = threading.Lock()
        self._preempt_deadline: Optional[float] = None
        # set when a heartbeat reply says the GCS is draining this node
        self._draining = False
        cfg = Config.instance()
        self.chunk_size = cfg.object_chunk_size
        self.heartbeat_period_s = cfg.raylet_heartbeat_period_ms / 1000.0

    def _publish_log(self, pid: int, line: str) -> None:
        """Buffer one worker log line for the GCS LOG channel. Appending
        never blocks the stderr drain thread — a hung GCS must not
        back-pressure the worker's stderr pipe and stall user code
        (the deque's maxlen drops oldest, best effort)."""
        with self._log_lock:
            self._log_buffer.append({"pid": pid, "line": line})
            if self._log_flusher is None:
                self._log_flusher = self._threads.spawn(
                    self._log_flush_loop,
                    f"log-flush-{self.node_id[:8]}")

    def _log_flush_loop(self) -> None:
        """Ship buffered lines in batches (reference: log_monitor.py
        publishes batches, not lines)."""
        from ray_tpu_torch.pubsub import LOG_CHANNEL

        while not self._stop.wait(0.2):
            with self._log_lock:
                if not self._log_buffer:
                    continue
                batch = list(self._log_buffer)
                self._log_buffer.clear()
            try:
                self.gcs.call("pubsub_publish", channel=LOG_CHANNEL,
                              key=self.node_id,
                              message={"batch": batch}, timeout=5.0)
            except Exception as e:
                # GCS briefly unreachable: logs are best-effort
                logger.debug("log batch publish (%d lines) failed: %r",
                             len(batch), e)

    # ------------------------------------------------------------- lifecycle
    def serve(self, host: str = "127.0.0.1", port: int = 0) -> RpcServer:
        srv = RpcServer(host, port)
        fast = {  # queue appends / store lookups: inline dispatch
            # (put_object stays threaded: it calls out to the GCS to
            # register the location)
            "submit_task", "submit_task_batch", "task_state",
            "prepare_bundle", "commit_bundle", "return_bundle",
            "node_stats", "ping", "get_object_info",
            "preempt_notice",  # one timestamp write: pure bookkeeping
            # inline => handled on the sender's connection reader
            # thread, so a pipelined begin/chunk.../end sequence stays
            # ordered (threaded dispatch would race chunks past begin)
            "push_begin", "push_chunk", "push_end", "push_abort",
            "perf_dump",
        }
        for name in (
            "submit_task", "submit_task_batch", "wait_task",
            "task_state",
            "put_object", "wait_object",
            "free_objects", "get_object_info",
            "push_object", "push_offer", "push_begin", "push_chunk",
            "push_end", "push_abort", "pull_object",
            "create_actor", "actor_call", "kill_actor",
            "kill_actor_batch",
            "prepare_bundle", "commit_bundle", "return_bundle",
            "node_stats", "ping", "perf_dump", "preempt_notice",
        ):
            srv.register(name, getattr(self, name), inline=name in fast)
        srv.register_stream("get_object", self.get_object)
        # raw data frames (chunk payload out of band, recv_into the
        # final segment bytes) dispatch inline on the reader thread by
        # construction — same ordering contract as the fast set above
        srv.register_data("push_chunk_data", self.push_chunk_data)
        srv.start()
        self.server = srv
        reply = self.gcs.call("register_node", node_id=self.node_id,
                              address=srv.address,
                              resources=self.resources, timeout=30.0)
        self.heartbeat_period_s = reply["heartbeat_period_ms"] / 1000.0
        nid = self.node_id[:8]
        self._threads.spawn(self._heartbeat_loop, f"raylet-hb-{nid}")
        self._threads.spawn(self._dereg_loop, f"raylet-dereg-{nid}")
        for i in range(max(2, int(self.resources.get("CPU", 2)))):
            self._threads.spawn(self._dispatch_loop,
                                f"raylet-dispatch-{nid}-{i}")
        return srv

    def ping(self) -> str:
        return "pong"

    def preempt_notice(self, notice_s: float, reason: str = "") -> dict:
        """Drain plane: the infrastructure (or the fault plane's seeded
        `preempt_node` storm kind) announces this node will be evicted
        in ``notice_s`` seconds. Record the deadline; the heartbeat
        loop reports the remaining window on its next beat and the GCS
        starts a graceful drain inside it. With the plane off the
        notice is acknowledged-but-ignored — eviction then lands as an
        abrupt kill, the pre-plane behavior."""
        if not Config.instance().drain_plane_enabled:
            return {"ok": False, "reason": "drain plane disabled"}
        from ray_tpu_torch.observability import metrics

        with self._drain_lock:
            self._preempt_deadline = time.monotonic() + max(
                0.0, float(notice_s))
        metrics.preemption_notices.inc(tags={"role": "raylet"})
        logger.warning("preemption notice: node %s evicted in %.1fs%s",
                       self.node_id[:8], notice_s,
                       f" ({reason})" if reason else "")
        return {"ok": True}

    def _preempt_remaining(self) -> Optional[float]:
        """Seconds left on a pending preemption notice (None if none).
        Keeps reporting 0.0 past the deadline: a drain the GCS missed
        (lost beats during the window) must still start."""
        with self._drain_lock:
            deadline = self._preempt_deadline
        if deadline is None:
            return None
        return max(0.0, deadline - time.monotonic())

    def shutdown(self) -> None:
        self._stop.set()
        with self._queue_cv:
            self._queue_cv.notify_all()
        self.pool.shutdown()
        if self.server is not None:
            self.server.stop()
        self.gcs.close()
        with self._peer_lock:
            peers = list(self._peer_clients.values())
        for c in peers:
            c.close()
        # join background threads BEFORE closing the store they touch;
        # a hung one is WARN-logged by name instead of leaking
        self._threads.join_all(timeout=2.0)
        self.push_manager.join_all(timeout=2.0)
        self.store.close()

    def _dereg_loop(self) -> None:
        """Deregister GCS locations of replicas the store evicted (the
        eviction callback only queues, so a full store never blocks on
        the GCS)."""
        while not self._stop.wait(0.2):
            while self._dropped_replicas:
                oid = self._dropped_replicas.popleft()
                try:
                    self.gcs.call("object_remove_location",
                                  object_id=oid, node_id=self.node_id,
                                  timeout=10.0)
                except Exception:
                    # GCS briefly unreachable: requeue, retry next sweep
                    self._dropped_replicas.appendleft(oid)
                    break

    def _heartbeat_loop(self) -> None:
        # Heartbeats ride their OWN connection: the shared self.gcs client
        # carries blocking calls (object_wait_location during dependency
        # pulls) and the RPC server handles one connection's requests
        # serially — sharing would starve liveness past the death
        # threshold while a pull waits.
        hb: Optional[RpcClient] = None
        gcs_instance: Optional[str] = None
        pending_reconcile = False
        while not self._stop.wait(self.heartbeat_period_s):
            self._expire_prepared_bundles()
            self._sweep_stale_inbound()
            try:
                if hb is None or hb.closed:
                    hb = RpcClient(self.gcs_address)
                with self._avail_lock:
                    avail = dict(self.available)
                    totals = dict(self.resources)
                t_send = time.monotonic()
                reply = hb.call("heartbeat", node_id=self.node_id,
                                available=avail, resources=totals,
                                overload=self._overload_stats(),
                                integrity=self._integrity_stats(),
                                serve=self._serve_stats(),
                                worker_pool=self._worker_pool_stats(),
                                preempt_notice_s=self._preempt_remaining(),
                                threads=self._threads.roots(),
                                timeout=10.0)
                rtt = time.monotonic() - t_send
                if reply.get("draining"):
                    # the GCS is draining this node (our notice, or an
                    # operator/scale-down drain): surfaced in node_stats
                    with self._drain_lock:
                        self._draining = True
                server_time = reply.get("server_time")
                if server_time is not None:
                    # Clock-offset estimate over the heartbeat RTT
                    # (NTP's symmetric-delay assumption): the GCS
                    # stamped server_time mid-flight, so GCS wall clock
                    # minus (our wall clock at receipt - rtt/2) is the
                    # skew. The flight recorder reports it per node and
                    # `cli.py timeline` shifts every node's spans onto
                    # the GCS clock before merging.
                    # raycheck: disable=RC02 — wall-clock sample for cross-node clock correlation, not deadline arithmetic
                    local_mid = time.time() - rtt / 2.0
                    from ray_tpu_torch.observability import flight_recorder
                    flight_recorder.global_recorder.set_clock_offset(
                        server_time - local_mid)
                instance = reply.get("gcs_instance")
                if not reply.get("registered", True):
                    # GCS declared us dead then saw us again — a healed
                    # partition — or has no record of us at all.
                    # UNLESS we know we're being drained out: then the
                    # deregistration was deliberate, and heartbeating on
                    # would resurrect the record (the handler flips
                    # alive back on) just for the GCS to drain it again
                    # — so fall silent and wait for the eviction
                    with self._drain_lock:
                        draining = self._draining
                    if draining:
                        logger.info("drained out of the cluster; "
                                    "heartbeats stop (awaiting "
                                    "eviction)")
                        break
                    pending_reconcile = True
                if (gcs_instance is not None and instance is not None
                        and instance != gcs_instance):
                    # GCS RESTARTED: its location directory started empty
                    pending_reconcile = True
                if pending_reconcile:
                    # Re-announce the node, re-publish resources, and
                    # re-report every resident object location
                    # (reference: raylets resend object locations on GCS
                    # failover). The flag clears only after the FULL
                    # reconcile lands: a connection drop mid-reconcile
                    # retries everything next beat.
                    self._reconcile_with_gcs(hb)
                    pending_reconcile = False
                if instance is not None:
                    gcs_instance = instance
            except (RpcConnectionError, TimeoutError):
                logger.warning("heartbeat to GCS failed; retrying")
                try:
                    if hb is not None:
                        hb.close()
                except Exception as e:
                    logger.debug("closing stale heartbeat connection "
                                 "failed: %r", e)
                hb = None

    def _reconcile_with_gcs(self, hb: RpcClient) -> None:
        """Resubscribe-and-reconcile after a partition heals or the GCS
        restarts: re-announce the node (scheduling resumes), re-publish
        its resource totals (PG shadow resources included), and re-pin
        every resident object's location in the directory — the GCS
        dropped them when it declared us dead (or restarted empty), and
        objects that only live here would otherwise be unfetchable
        forever. Batched into chunked RPCs so the re-report costs
        O(entries/4096) round trips inside the heartbeat loop, not one
        blocking call per object (which would stall liveness past the
        death threshold right after recovery)."""
        with self._avail_lock:
            totals = dict(self.resources)
        hb.call("register_node", node_id=self.node_id,
                address=self.server.address,
                resources=totals, timeout=10.0)
        entries = list(self.store.entries())
        for i in range(0, len(entries), 4096):
            hb.call("object_add_locations",
                    node_id=self.node_id,
                    entries=entries[i:i + 4096],
                    timeout=30.0)

    # -------------------------------------------------------------- objects
    def put_object(self, object_id: bytes, payload: bytes,
                   is_error: bool = False, register: bool = True,
                   primary: bool = True) -> dict:
        self.store.put(object_id, payload, is_error, primary=primary)
        if register:
            self._register_location(object_id, len(payload))
        return {"ok": True}

    def _register_location(self, object_id: bytes, size: int) -> None:
        try:
            self.gcs.call("object_add_location", object_id=object_id,
                          node_id=self.node_id, size=size, timeout=10.0)
        except (RpcConnectionError, TimeoutError):
            logger.warning("failed to register location for %s",
                           object_id.hex()[:8])

    def wait_object(self, object_id: bytes, timeout_s: float = 10.0) -> dict:
        return {"present": self.store.wait(object_id, timeout_s)}

    def delete_object(self, object_id: bytes) -> dict:
        # internal (not a registered RPC): the wire surface for
        # deletion is the batched free_objects
        self.store.delete(object_id)
        try:
            self.gcs.call("object_remove_location", object_id=object_id,
                          node_id=self.node_id, timeout=10.0)
        except (RpcConnectionError, TimeoutError) as e:
            # stale directory entry: readers fall back to the pull
            # retry loop, which re-resolves locations
            logger.debug("deregistering %s with GCS failed: %r",
                         object_id.hex()[:8], e)
        return {"ok": True}

    def free_objects(self, object_ids: List[bytes]) -> dict:
        for oid in object_ids:
            self.delete_object(oid)
        return {"ok": True}

    def get_object(self, object_id: bytes):
        """Stream handler: header dict then payload chunks (the chunked
        Push of object_manager.cc:463 SendObjectChunk, pull-initiated).
        Serving a spilled object restores it from disk first."""
        meta = self.store.info(object_id)
        entry = self.store.get(object_id)
        if entry is None:
            raise KeyError(f"object {object_id.hex()[:8]} not on node "
                           f"{self.node_id[:8]}")
        is_error, payload = entry
        # the header frame carries this holder's digest so the puller
        # verifies the reassembled payload at completion (integrity
        # plane; a store.get above already verified a spilled replica)
        yield {"size": len(payload), "is_error": is_error,
               "crc": (meta or {}).get("crc")}
        view = memoryview(payload)
        for off in range(0, len(payload), self.chunk_size):
            yield view[off:off + self.chunk_size]
        if not payload:
            yield b""

    def get_object_info(self, object_id: bytes) -> dict:
        """Transfer negotiation: tells a peer whether (and how) this
        node can serve the object. ``shm_path`` is set when the payload
        sits in this node's shared-memory segment — a peer ON THE SAME
        HOST attaches the segment and copies under the C store's
        process-shared mutex, skipping the TCP stream entirely (the
        plasma insight — src/ray/object_manager/plasma/: intra-host
        transport is shared memory, sockets are for metadata)."""
        meta = self.store.info(object_id)
        if meta is None:
            return {"present": False}
        info = {"present": True, "size": meta["size"],
                "is_error": meta["is_error"], "crc": meta.get("crc")}
        if meta["where"] == "shm" and meta.get("shm_path"):
            # per-entry path: an ADOPTED replica names the owner's
            # segment (where the bytes physically are), not ours
            info["shm_path"] = meta["shm_path"]
        return info

    # ------------------------------------------------------ object transfer
    def _peer(self, address: str) -> RpcClient:
        with self._peer_lock:
            c = self._peer_clients.get(address)
        if c is not None and not c.closed:
            return c
        # connect OUTSIDE the lock (RC01: the TCP dial blocks); on a
        # lost race the loser closes its own dial instead of leaking it
        fresh = RpcClient(address)
        with self._peer_lock:
            cur = self._peer_clients.get(address)
            if cur is not None and not cur.closed:
                c = cur
            else:
                self._peer_clients[address] = fresh
                c = fresh
        if c is not fresh:
            fresh.close()
        return c

    def _attach_peer_shm(self, path: str):
        from ray_tpu_torch.cluster.byte_store import attach_shm

        return attach_shm(path)

    def _pull_object(self, object_id: bytes, timeout: float = 60.0) -> bool:
        """Ensure object_id is in the local store, pulling from a peer if
        needed. Concurrent pulls of the same object dedup onto one fetch
        (reference: ObjectManager pull dedup + PullManager retry)."""
        if self.store.contains(object_id):
            return True
        with self._pull_lock:
            ev = self._inflight_pulls.get(object_id)
            if ev is None:
                ev = threading.Event()
                self._inflight_pulls[object_id] = ev
                leader = True
            else:
                leader = False
        if not leader:
            ev.wait(timeout)
            return self.store.contains(object_id)
        try:
            return self._pull_object_leader(object_id, timeout)
        finally:
            with self._pull_lock:
                self._inflight_pulls.pop(object_id, None)
            ev.set()

    def _pull_object_leader(self, object_id: bytes, timeout: float) -> bool:
        from ray_tpu_torch.scheduler.pull_manager import BundlePriority

        deadline = time.monotonic() + timeout
        # a sender is already pushing this object to us: wait for that
        # transfer instead of opening a duplicate pull stream
        with self._inbound_lock:
            st = self._inbound_pushes.get(object_id)
        if st is not None:
            # bounded: a sender that died mid-stream must not consume
            # the whole pull deadline (its slot is reclaimed by the
            # next push_begin after the staleness window)
            st["event"].wait(
                min(10.0, max(0.0, deadline - time.monotonic())))
            if self.store.contains(object_id):
                return True
        while time.monotonic() < deadline:
            try:
                wait_s = min(5.0, max(0.1, deadline - time.monotonic()))
                reply = self.gcs.call(
                    "object_wait_location", object_id=object_id,
                    timeout_s=wait_s, timeout=wait_s + 10.0,
                )
            except (RpcConnectionError, TimeoutError) as e:
                logger.warning("pull: location wait failed for %s: %r",
                               object_id.hex()[:8], e)
                return False
            locations = [loc for loc in reply["locations"]
                         if loc["node_id"] != self.node_id]
            # spread load across replicas: each completed fetch registers
            # a new location, so a fan-in (N nodes pulling one object)
            # organically becomes a fan-out tree — later pullers hit the
            # fresh replicas instead of all hammering the producer
            # (reference broadcast behavior; object_store.json baseline)
            self._pull_rng.shuffle(locations)
            if not locations:
                if self.store.contains(object_id):
                    return True
                time.sleep(0.05)
                continue
            size = reply.get("size", 0)
            pm = self.store.pull_manager
            bundle = pm.pull(BundlePriority.TASK_ARGS, [object_id],
                             [size])
            try:
                if not pm.wait_active(
                        bundle, max(0.0, deadline - time.monotonic())):
                    logger.warning("pull: admission wait timed out for %s",
                                   object_id.hex()[:8])
                    return False
                for loc in locations:
                    if self._fetch_from(loc["address"], object_id):
                        return True
                logger.warning("pull: every holder failed for %s (locations %s)",
                               object_id.hex()[:8],
                               [l["node_id"][:8] for l in locations])
            finally:
                pm.cancel(bundle)
            time.sleep(0.05)
        return self.store.contains(object_id)

    num_shm_fetches = 0
    num_stream_fetches = 0
    num_zero_copy_handoffs = 0
    # dispatch fast lane: task_batch pipe frames sent / rows they carried
    num_exec_batches = 0
    num_exec_batch_rows = 0
    # inbound push accounting: same-host segment adoption/memcpy vs
    # chunked TCP stream — the broadcast bench reads these to prove
    # which path its rate measured
    num_push_shm_in = 0
    num_push_stream_in = 0
    # data-plane pipeline: chunk-tree traffic through this node, torn
    # down half-receives, and the cut-through overlap aggregate (what
    # fraction of downstream forwarding happened inside our own
    # receive window — ~1.0 is true cut-through, ~0 store-and-forward)
    num_chunks_in = 0
    num_chunks_forwarded = 0
    num_push_teardowns = 0
    # chunk-tree failover: subtrees re-rooted here after their feeding
    # relay died mid-broadcast (chunk_tree_failover_enabled)
    num_tree_failovers = 0
    ct_overlap_sum = 0.0
    ct_overlap_n = 0

    def _fetch_from(self, address: str, object_id: bytes) -> bool:
        from ray_tpu_torch.cluster.rpc import fetch_object

        try:
            peer = self._peer(address)
        except (RpcConnectionError, OSError):
            return False
        # Same-host fast path: when the holder's copy sits in its shm
        # segment and that segment is reachable through the filesystem
        # (= same host), attach it and copy under the C store's
        # process-shared mutex — one memcpy instead of a framed TCP
        # stream. Falls back to the stream on any miss or race (holder
        # evicted/spilled the object between info and read).
        try:
            info = peer.call("get_object_info", object_id=object_id,
                             timeout=10.0)
        except (RpcConnectionError, TimeoutError) as e:
            logger.warning("pull: info rpc to holder failed for %s: %r",
                           object_id.hex()[:8], e)
            return False
        if not info.get("present"):
            logger.warning("pull: %s no longer resident at %s (stale location)",
                           object_id.hex()[:8], address)
            return False
        shm_path = info.get("shm_path")
        if shm_path and Config.instance().data_plane_stream_only:
            # bench/test knob: pretend the holder is on another host —
            # skip every same-host shm shortcut so the pull exercises
            # the framed stream path
            shm_path = None
        if shm_path:
            if Config.instance().data_plane_pipeline_enabled:
                # data plane ON: ADOPT the holder's sealed segment entry
                # — a shared mapping plus a cross-process pin, zero
                # payload bytes moved (plasma's one-copy-per-host
                # posture). Verification is the O(1) trailer/offer digest
                # compare inside adopt_remote_shm. Any failure falls
                # through to the copying fast path below.
                if self.store.adopt_remote_shm(
                        object_id, shm_path, info["size"],
                        info["is_error"], crc=info.get("crc"),
                        primary=False):
                    self._register_location(object_id, info["size"])
                    with self._stats_lock:
                        self.num_shm_fetches += 1
                    return True
            seg = self._attach_peer_shm(shm_path)
            if seg is not None:
                key = shm_key(object_id)
                try:
                    # segment-to-segment: pin the holder's entry (the C
                    # refcount lives in the shared segment, so the
                    # holder cannot free it mid-copy), then write the
                    # replica straight into our own segment — one
                    # memcpy, no heap bounce
                    buf = seg.get_buffer(key)
                except Exception:
                    buf = None
                if buf is not None:
                    try:
                        # trailer-aware slice: the holder's crc rides
                        # along into our entry; the copy itself is
                        # re-verified only under the
                        # integrity_verify_shm_reads knob (an
                        # intra-host memcpy — see config.py)
                        payload, t_crc = integrity.split_shm(
                            buf, info["size"])
                        if payload is not None:
                            crc = info.get("crc")
                            crc = crc if crc is not None else t_crc
                            try:
                                if integrity.verify_shm_reads():
                                    integrity.verify(payload, crc,
                                                     "shm_read",
                                                     object_id)
                            except ObjectCorruptedError:
                                payload = None  # stream fallback
                        if payload is not None:
                            self.store.put(object_id, payload,
                                           info["is_error"],
                                           primary=False, crc=crc)
                            self._register_location(object_id,
                                                    len(payload))
                            with self._stats_lock:
                                self.num_shm_fetches += 1
                            return True
                    finally:
                        seg.release(key)
        result = fetch_object(peer, object_id)
        if result is None:
            logger.warning("pull: chunked stream of %s from %s failed",
                           object_id.hex()[:8], address)
            return False
        is_error, payload = result
        self.store.put(object_id, payload, is_error, primary=False)
        self._register_location(object_id, len(payload))
        with self._stats_lock:
            self.num_stream_fetches += 1
        return True

    # ------------------------------------------------------------ push path
    # Reference: ObjectManager::Push / HandlePush / SendObjectChunk
    # (object_manager.cc:302,463,509) + PushManager throttling
    # (push_manager.h). A push is sender-initiated: offer (lets a
    # same-host receiver adopt the segment entry or take the shm copy
    # fast path), else a chunked stream. With the data-plane pipeline ON
    # the stream is raw wire frames recv_into'd straight into the
    # receiver's final segment bytes, per-chunk digests verify BEFORE
    # cut-through forwarding, and a ``downstream`` subtree plan turns
    # each receiver into an interior chunk-tree node that forwards chunk
    # k the moment it verified — tree depth costs latency per CHUNK, not
    # per object.
    def push_object(self, object_id: bytes, to_address: str,
                    downstream: Optional[list] = None) -> dict:
        """Ask this node to push a local object to a peer. Dedup +
        concurrency limits are the PushManager's. ``downstream`` is the
        receiver's subtree plan ([[address, subtree], ...])."""
        if not self.store.contains(object_id):
            return {"ok": False, "reason": "not local"}
        return {"ok": self.push_manager.push(object_id, to_address,
                                             downstream=downstream)}

    def pull_object(self, object_id: bytes,
                    from_address: Optional[str] = None) -> dict:
        """Wire surface of ``_pull_object``: the flat broadcast
        topology and the driver's re-pull convergence fallback ask a
        node to ensure a local replica. ``from_address`` short-circuits
        the directory lookup when the caller knows a holder."""
        if self.store.contains(object_id):
            return {"ok": True}
        if from_address:
            try:
                if self._fetch_from(from_address, object_id):
                    return {"ok": True}
            except Exception as e:
                logger.debug("pull_object: direct fetch of %s from %s "
                             "failed: %r", object_id.hex()[:8],
                             from_address, e)
        return {"ok": self._pull_object(object_id, timeout=60.0)}

    def _dp_chunk_bytes(self) -> int:
        cfg = Config.instance()
        return (cfg.data_plane_chunk_bytes
                if cfg.data_plane_chunk_bytes > 0
                else cfg.object_chunk_size)

    def _send_push(self, object_id: bytes, dest: str,
                   downstream: Optional[list] = None) -> None:
        # metadata first: when the receiver takes the shm fast path the
        # payload never needs materializing here (a spilled or
        # shm-resident multi-GiB object would otherwise be copied to
        # the heap just to measure its length)
        cfg = Config.instance()
        # lane breaker (cluster/overload.py): K consecutive pipelined
        # push failures degrade this sender to the legacy stream until
        # a half-open probe transfer survives; the Config master switch
        # itself is never written
        dp = (cfg.data_plane_pipeline_enabled
              and _overload.lane_enabled("data_plane"))
        reroot = self._pop_reroot(object_id, dest)
        meta = self.store.info(object_id)
        if meta is None:
            return
        peer = self._peer(dest)
        offer = {"object_id": object_id, "size": meta["size"],
                 "is_error": meta["is_error"], "crc": meta.get("crc")}
        if (meta["where"] == "shm" and meta.get("shm_path")
                and not (dp and cfg.data_plane_stream_only)):
            # per-entry path: an adopted replica offers the OWNER's
            # segment; stream_only (test/bench knob) withholds the path
            # so the chunk-tree stream is what gets exercised
            offer["shm_path"] = meta["shm_path"]
        if dp and downstream:
            offer["downstream"] = downstream
        if peer.call("push_offer", timeout=60.0, **offer).get("done"):
            if dp:
                _overload.lane_ok("data_plane")
            return
        if dp:
            try:
                self._send_push_pipelined(peer, object_id, dest, meta,
                                          downstream, reroot=reroot)
            except BaseException:
                _overload.lane_failed("data_plane")
                raise
            _overload.lane_ok("data_plane")
            return
        entry = self.store.get(object_id)  # stream fallback: need bytes
        if entry is None:
            return
        is_error, payload = entry
        if not peer.call("push_begin", object_id=object_id,
                         size=len(payload), is_error=is_error,
                         crc=meta.get("crc"),
                         timeout=30.0).get("accept"):
            return  # receiver already has it (or one is inbound)
        view = memoryview(payload)
        with_crc = integrity.enabled()
        # raycheck: disable=RC10 — bounded by the in-flight throttle directly below (len(pending) > 4 drains before the next chunk enqueues)
        pending: deque = deque()
        try:
            for off in range(0, len(payload), self.chunk_size):
                chunk = bytes(view[off:off + self.chunk_size])
                pending.append(peer.call_async(
                    "push_chunk", object_id=object_id, chunk=chunk,
                    crc=(integrity.checksum(chunk) if with_crc
                         else None)))
                while len(pending) > 4:  # chunks in flight, the throttle
                    pending.popleft().result(timeout=60.0)
            while pending:
                pending.popleft().result(timeout=60.0)
            peer.call("push_end", object_id=object_id, timeout=60.0)
        except BaseException:
            try:  # free the receiver's reassembly slot
                peer.call("push_abort", object_id=object_id, timeout=10.0)
            except Exception as e:
                # receiver unreachable: its push_begin staleness window
                # reclaims the slot
                logger.debug("push_abort of %s to %s failed: %r",
                             object_id.hex()[:8], dest, e)
            raise

    def _pop_reroot(self, object_id: bytes, dest: str) -> bool:
        """Consume a pending failover mark for (object, dest): True
        means this push is a re-root re-offer and its push_begin should
        carry ``reroot=True``."""
        with self._reroot_lock:
            try:
                self._reroot_pending.remove((object_id, dest))
                return True
            except KeyError:
                return False

    def _mark_reroot(self, object_id: bytes, dest: str) -> None:
        with self._reroot_lock:
            self._reroot_pending.add((object_id, dest))

    def _send_push_pipelined(self, peer: RpcClient, object_id: bytes,
                             dest: str, meta: dict,
                             downstream: Optional[list],
                             reroot: bool = False) -> None:
        """Data-plane ON stream: zero-copy source (chunks are slices of
        the pinned entry view, no heap bounce), raw wire frames (the
        payload travels out of band of the pickled header and lands via
        ``recv_into`` in the receiver's final segment bytes), a
        config-sized in-flight window, and the nested ``downstream``
        plan that makes the receiver an interior chunk-tree node."""
        cfg = Config.instance()
        pv = self.store.view_and_pin(object_id)
        if pv is None:
            return
        is_error, view, crc = pv
        try:
            size = len(view)
            chunk = self._dp_chunk_bytes()
            window = max(1, cfg.data_plane_window)
            if not peer.call("push_begin", object_id=object_id,
                             size=size, is_error=is_error, crc=crc,
                             downstream=downstream or None,
                             chunk_bytes=chunk, reroot=reroot,
                             timeout=30.0).get("accept"):
                return  # receiver already has it (or one is inbound)
            with_crc = integrity.enabled()
            # raycheck: disable=RC10 — bounded by the in-flight window drain directly below
            pending: deque = deque()
            try:
                for off in range(0, size, chunk):
                    piece = view[off:off + chunk]
                    pending.append(peer.call_data_async(
                        "push_chunk_data", piece, object_id=object_id,
                        offset=off,
                        crc=(integrity.checksum(piece) if with_crc
                             else None)))
                    while len(pending) >= window:
                        r = pending.popleft().result(timeout=60.0)
                        if not r.get("ok"):
                            raise RuntimeError(
                                f"receiver rejected chunk of "
                                f"{object_id.hex()[:8]}: {r}")
                while pending:
                    r = pending.popleft().result(timeout=60.0)
                    if not r.get("ok"):
                        raise RuntimeError(
                            f"receiver rejected chunk of "
                            f"{object_id.hex()[:8]}: {r}")
                end = peer.call("push_end", object_id=object_id,
                                timeout=120.0)
                if not end.get("ok"):
                    logger.info("pipelined push of %s to %s did not "
                                "seal: %s", object_id.hex()[:8], dest,
                                end)
            except BaseException:
                try:  # free the receiver's (and its subtree's) slots
                    peer.call("push_abort", object_id=object_id,
                              timeout=10.0)
                except Exception as e:
                    # receiver unreachable: the stale-inbound sweep
                    # reclaims the slot
                    logger.debug("push_abort of %s to %s failed: %r",
                                 object_id.hex()[:8], dest, e)
                raise
        finally:
            self.store.unpin(object_id)

    def _relay_downstream(self, object_id: bytes,
                          downstream: Optional[list]) -> None:
        """Feed a subtree plan from THIS node's copy: each child gets
        its own push (with its sub-subtree riding along) through the
        push manager — the adoption fast path's analogue of cut-through
        forwarding (there are no chunks to forward; the whole object is
        already servable here)."""
        for item in downstream or []:
            try:
                addr, subtree = item[0], item[1]
            except (TypeError, IndexError):
                continue
            self.push_manager.push(object_id, addr,
                                   downstream=subtree or None)

    def push_offer(self, object_id: bytes, size: int, is_error: bool,
                   shm_path: Optional[str] = None,
                   crc: Optional[int] = None,
                   downstream: Optional[list] = None) -> dict:
        """Receiver side of a push: adopts the sender's segment entry
        (data plane ON, same host — a shared mapping, zero bytes moved)
        or takes the copying shm fast path; ``done=False`` asks the
        sender to stream. A ``downstream`` subtree is relayed onward
        from this node's copy either way."""
        dp = Config.instance().data_plane_pipeline_enabled
        if self.store.contains(object_id):
            if dp:
                self._relay_downstream(object_id, downstream)
            return {"done": True}
        if shm_path and dp:
            if self.store.adopt_remote_shm(object_id, shm_path, size,
                                           is_error, crc=crc,
                                           primary=False):
                self._register_location(object_id, size)
                with self._stats_lock:
                    self.num_push_shm_in += 1
                self._relay_downstream(object_id, downstream)
                return {"done": True}
        if shm_path:
            seg = self._attach_peer_shm(shm_path)
            if seg is not None:
                key = shm_key(object_id)
                try:
                    # segment-to-segment single memcpy (same discipline
                    # as the pull fast path): pin the holder's entry and
                    # write the replica straight into our own store — a
                    # get_bytes() here would bounce GiB-scale payloads
                    # through the heap, doubling broadcast time
                    buf = seg.get_buffer(key)
                except Exception:
                    buf = None
                if buf is not None:
                    try:
                        # trailer-aware slice; the sender's digest is
                        # adopted with the replica, and the copy is
                        # re-verified under the verify-shm-reads knob
                        # — a mismatch asks the sender to stream
                        # instead (whose checksums always verify)
                        payload, t_crc = integrity.split_shm(buf, size)
                        if payload is not None:
                            eff = crc if crc is not None else t_crc
                            try:
                                if integrity.verify_shm_reads():
                                    integrity.verify(payload, eff,
                                                     "shm_read",
                                                     object_id)
                            except ObjectCorruptedError:
                                payload = None
                        if payload is not None:
                            self._accept_push(object_id, payload,
                                              is_error, crc=eff)
                            with self._stats_lock:
                                self.num_push_shm_in += 1
                            if dp:
                                self._relay_downstream(object_id,
                                                       downstream)
                            return {"done": True}
                    finally:
                        seg.release(key)
        return {"done": False}

    def push_begin(self, object_id: bytes, size: int, is_error: bool,
                   crc: Optional[int] = None,
                   downstream: Optional[list] = None,
                   chunk_bytes: Optional[int] = None,
                   reroot: bool = False) -> dict:
        reclaim = None
        with self._inbound_lock:
            st = self._inbound_pushes.get(object_id)
            if st is not None:
                h = st.get("h")
                t_last = h.t_last if h is not None else st["t0"]
                limit = (Config.instance().data_plane_inbound_stale_s
                         if h is not None else 120.0)
                if time.monotonic() - t_last > limit:
                    # the previous sender died mid-stream and never
                    # aborted: reclaim the slot so the object does not
                    # become permanently unpushable on this node
                    reclaim = self._inbound_pushes.pop(object_id)
                    st = None
                elif (reroot and h is not None and Config.instance()
                        .chunk_tree_failover_enabled):
                    # failover re-offer from a re-rooted parent: the
                    # half-open inbound we hold was fed by a relay that
                    # died mid-tree and will never complete — supersede
                    # it (the teardown cascades aborts down our own
                    # subtree, whose slots the fresh stream's downstream
                    # plan reopens) and accept the replacement. The
                    # whole-object CRC makes the spliced replica
                    # verifiably identical to the one the dead relay
                    # was sending.
                    reclaim = self._inbound_pushes.pop(object_id)
                    st = None
        if reclaim is not None:
            self._teardown_inbound(object_id, reclaim)
        if st is not None or self.store.contains(object_id):
            return {"accept": False}
        if chunk_bytes is None:
            # legacy stream: reassembly bytearray, admitted at push_end
            with self._inbound_lock:
                if object_id in self._inbound_pushes:
                    return {"accept": False}
                self._inbound_pushes[object_id] = {
                    "buf": bytearray(size), "off": 0,
                    "is_error": is_error,
                    "event": threading.Event(), "t0": time.monotonic(),
                    # integrity: whole-object digest + the running count
                    # of chunk-verified bytes (when every chunk carried
                    # a crc, the end-of-stream whole-buffer pass is
                    # redundant)
                    "crc": crc, "chunk_verified": 0}
            return {"accept": True}
        # ---- pipelined chunk-tree receive (data plane ON sender) ----
        # reserve the inbound slot FIRST (under the lock), then allocate
        # the final bytes and open the downstream children outside it —
        # child push_begins are blocking RPCs
        st = {"h": None, "event": threading.Event(),
              "t0": time.monotonic(), "crc": crc, "chunk_verified": 0,
              "children": [],
              "window": max(1, Config.instance().data_plane_window),
              "t_recv": [None, None], "t_fwd": [None, None]}
        with self._inbound_lock:
            if object_id in self._inbound_pushes:
                return {"accept": False}
            self._inbound_pushes[object_id] = st
        h = self.store.begin_receive(object_id, size, is_error, crc)
        if h is None:  # became resident in the window above
            with self._inbound_lock:
                self._inbound_pushes.pop(object_id, None)
            st["event"].set()
            return {"accept": False}
        st["h"] = h
        # open the subtree: each child gets its own push_begin with its
        # sub-subtree. A child that declines (already holds the object,
        # or has one inbound) orphans ITS subtree — adopt the
        # grandchildren as our own children so no leaf goes unfed.
        worklist = list(downstream or [])
        while worklist:
            item = worklist.pop(0)
            try:
                addr, subtree = item[0], item[1]
            except (TypeError, IndexError):
                continue
            try:
                c = self._peer(addr)
                r = c.call("push_begin", object_id=object_id,
                           size=size, is_error=is_error, crc=crc,
                           downstream=subtree or None,
                           chunk_bytes=chunk_bytes, timeout=30.0)
            except (RpcConnectionError, TimeoutError, OSError) as e:
                logger.info("chunk-tree child %s unreachable at begin "
                            "(%r); adopting its subtree", addr, e)
                worklist.extend(subtree or [])
                continue
            if r.get("accept"):
                # Bounded in practice: _forward_chunk drains each
                # child's pending below the in-flight window before
                # every enqueue (cut-through window backpressure).
                st["children"].append(
                    {"address": addr, "client": c,
                     "pending": deque(),  # raycheck: disable=RC10 — drained below the in-flight window before every enqueue
                     # the child's own subtree plan, kept so a child
                     # dying mid-stream can be failed over: this node
                     # re-roots the orphans at seal time
                     "subtree": subtree or [],
                     "dead": False})
            else:
                worklist.extend(subtree or [])
        return {"accept": True}

    def _teardown_inbound(self, object_id: bytes, st: dict) -> None:
        """Free a half-assembled inbound transfer (sender death, chunk
        digest failure, staleness): tear down the preallocated segment
        bytes and cascade aborts so the whole subtree's slots free too.
        The caller has already popped ``st`` from ``_inbound_pushes``."""
        if "h" in st:
            self.store.abort_receive(object_id)
            with self._stats_lock:
                self.num_push_teardowns += 1
            for ch in st.get("children", []):
                try:
                    ch["client"].call("push_abort", object_id=object_id,
                                      timeout=10.0)
                except Exception as e:
                    # unreachable child: its own stale sweep reclaims
                    logger.debug("cascading push_abort of %s to %s "
                                 "failed: %r", object_id.hex()[:8],
                                 ch["address"], e)
        st["event"].set()

    def _sweep_stale_inbound(self) -> None:
        """Heartbeat-driven staleness sweep: an inbound pipelined
        transfer whose sender stopped making progress (node died after
        push_begin) is torn down and counted — half-assembled segment
        bytes must not outlive their sender. The
        legacy 120 s begin-time reclaim stays as the backstop for
        legacy-mode streams."""
        cfg = Config.instance()
        now = time.monotonic()
        stale = []
        with self._inbound_lock:
            for oid, st in list(self._inbound_pushes.items()):
                h = st.get("h")
                t_last = h.t_last if h is not None else st["t0"]
                limit = (cfg.data_plane_inbound_stale_s
                         if h is not None else 120.0)
                if now - t_last >= limit:
                    self._inbound_pushes.pop(oid, None)
                    stale.append((oid, st))
        for oid, st in stale:
            logger.warning("inbound push of %s stalled past %.0fs; "
                           "torn down", oid.hex()[:8],
                           cfg.data_plane_inbound_stale_s)
            self._teardown_inbound(oid, st)
        # backstop: store-level receives orphaned of any inbound entry
        self.store.sweep_stale_receives(
            max(cfg.data_plane_inbound_stale_s * 4, 120.0))

    def push_abort(self, object_id: bytes) -> dict:
        """Sender-side cleanup of a failed chunked push: frees the
        reassembly state (including a pipelined receive's preallocated
        segment bytes), cascades down the chunk tree, and wakes pulls
        parked on the inbound event (reference: PushManager chunk
        failure handling)."""
        with self._inbound_lock:
            st = self._inbound_pushes.pop(object_id, None)
        if st is not None:
            self._teardown_inbound(object_id, st)
        return {"ok": st is not None}

    def push_chunk(self, object_id: bytes, chunk: bytes,
                   crc: Optional[int] = None) -> dict:
        with self._inbound_lock:
            st = self._inbound_pushes.get(object_id)
        if st is None:
            return {"ok": False}
        if crc is not None and integrity.enabled():
            try:
                integrity.verify(chunk, crc, "push_chunk", object_id)
                st["chunk_verified"] += len(chunk)
            except ObjectCorruptedError:
                # wire corruption caught at chunk granularity: tear
                # down the reassembly before the bad bytes can ever be
                # assembled into a replica — the sender's transfer
                # fails and the consumer re-pulls/re-pushes
                self.store.num_corrupt_dropped += 1
                with self._inbound_lock:
                    self._inbound_pushes.pop(object_id, None)
                st["event"].set()
                logger.warning("inbound push chunk of %s failed its "
                               "digest; transfer discarded",
                               object_id.hex()[:8])
                return {"ok": False, "corrupt": True}
        off = st["off"]
        st["buf"][off:off + len(chunk)] = chunk
        st["off"] = off + len(chunk)
        return {"ok": True}

    def push_chunk_data(self, payload_len: int, recv_payload,
                        object_id: bytes, offset: int = 0,
                        crc: Optional[int] = None) -> dict:
        """Raw-frame chunk receive (data plane ON): ``recv_payload``
        lands the wire bytes DIRECTLY in the object's final segment
        offset (one copy, socket -> sealed-entry bytes), the chunk
        digest is checked on the still-cache-hot slice, and only then
        is the chunk cut-through forwarded down the subtree — a corrupt
        chunk is caught at THIS node and never amplifies downstream."""
        with self._inbound_lock:
            st = self._inbound_pushes.get(object_id)
        h = st.get("h") if st is not None else None
        if h is None or offset < 0 or offset + payload_len > h.size:
            return {"ok": False}  # dispatcher drains the unread payload
        dst = h.view[offset:offset + payload_len]
        recv_payload(dst)
        now = time.monotonic()
        h.t_last = now
        if st["t_recv"][0] is None:
            st["t_recv"][0] = now
        if crc is not None and integrity.enabled():
            actual = integrity.checksum(dst)
            if actual != crc:
                # caught BEFORE any forward: teardown self + subtree
                integrity.record_corruption("push_chunk")
                self.store.num_corrupt_dropped += 1
                with self._inbound_lock:
                    self._inbound_pushes.pop(object_id, None)
                self._teardown_inbound(object_id, st)
                logger.warning("inbound chunk of %s at offset %d failed "
                               "its digest; transfer (and subtree) "
                               "discarded", object_id.hex()[:8], offset)
                return {"ok": False, "corrupt": True}
            st["chunk_verified"] += payload_len
        h.landed += payload_len
        with self._stats_lock:
            self.num_chunks_in += 1
        # cut-through: the verified chunk goes downstream NOW, while
        # later chunks are still in flight to us — tree depth costs one
        # chunk's latency per level, not one object's
        for ch in st["children"]:
            if ch["dead"]:
                continue
            try:
                ch["pending"].append(ch["client"].call_data_async(
                    "push_chunk_data", dst, object_id=object_id,
                    offset=offset, crc=crc))
                with self._stats_lock:
                    self.num_chunks_forwarded += 1
                if st["t_fwd"][0] is None:
                    st["t_fwd"][0] = time.monotonic()
                while len(ch["pending"]) >= st["window"]:
                    if not ch["pending"].popleft().result(
                            timeout=60.0).get("ok"):
                        ch["dead"] = True
                        break
            except Exception as e:
                ch["dead"] = True
                logger.info("cut-through forward of %s to %s failed: "
                            "%r", object_id.hex()[:8], ch["address"], e)
        if st["children"] and st["t_fwd"][0] is not None:
            st["t_fwd"][1] = time.monotonic()
        st["t_recv"][1] = time.monotonic()
        return {"ok": True}

    def push_end(self, object_id: bytes) -> dict:
        with self._inbound_lock:
            st = self._inbound_pushes.pop(object_id, None)
        if st is None:
            return {"ok": False}
        if "h" in st:
            return self._push_end_pipelined(object_id, st)
        ok = st["off"] == len(st["buf"])
        if ok and st.get("crc") is not None and integrity.enabled() \
                and st["chunk_verified"] < len(st["buf"]):
            # not every chunk carried its own digest: verify the whole
            # reassembled payload against the push_begin crc (one pass
            # either way — chunk-verified streams skip this)
            try:
                integrity.verify(st["buf"], st["crc"], "push_end",
                                 object_id)
            except ObjectCorruptedError:
                self.store.num_corrupt_dropped += 1
                st["event"].set()
                logger.warning("inbound push of %s failed its digest "
                               "at assembly; replica discarded",
                               object_id.hex()[:8])
                return {"ok": False, "corrupt": True}
        if ok:
            self._accept_push(object_id, bytes(st["buf"]),
                              st["is_error"], crc=st.get("crc"))
            with self._stats_lock:
                self.num_push_stream_in += 1
        st["event"].set()
        return {"ok": ok}

    def _push_end_pipelined(self, object_id: bytes, st: dict) -> dict:
        """Seal a pipelined receive (coverage + digest posture checks),
        then cascade push_end down the subtree — children already hold
        every chunk (cut-through forwarded), so the cascade costs one
        small RPC per level, not a re-send."""
        h = st["h"]
        ok = h is not None and h.landed >= h.size
        corrupt = False
        if (ok and h.crc is not None and integrity.enabled()
                and st["chunk_verified"] < h.size):
            # sender streamed without per-chunk digests: one
            # whole-buffer pass against the push_begin crc
            # (chunk-verified streams skip this — every byte was
            # already checked the moment it landed)
            try:
                integrity.verify(h.view, h.crc, "push_end", object_id)
            except ObjectCorruptedError:
                corrupt = True
                self.store.num_corrupt_dropped += 1
                logger.warning("inbound pipelined push of %s failed its "
                               "digest at assembly; replica discarded",
                               object_id.hex()[:8])
        if ok and not corrupt:
            try:
                self.store.seal_receive(h, primary=False)
                self._register_location(object_id, h.size)
                with self._stats_lock:
                    self.num_push_stream_in += 1
            except ObjectCorruptedError:
                corrupt = True  # seal's end-to-end check (defensive)
            except Exception as e:
                ok = False  # seal_receive discarded the rx on its way out
                logger.warning("sealing pipelined receive of %s failed: "
                               "%r", object_id.hex()[:8], e)
        else:
            self.store.abort_receive(object_id)
            with self._stats_lock:
                self.num_push_teardowns += 1
        # cut-through overlap accounting (bench: how much of the
        # downstream forwarding happened DURING our own receive)
        tr, tf = st["t_recv"], st["t_fwd"]
        if (st["children"] and None not in tr and None not in tf
                and tr[1] > tr[0]):
            overlap = max(0.0, min(tr[1], tf[1]) - max(tr[0], tf[0]))
            with self._stats_lock:
                self.ct_overlap_sum += overlap / (tr[1] - tr[0])
                self.ct_overlap_n += 1
        # cascade: live children seal (and cascade further); dead ones
        # get a best-effort abort so their subtree slots free
        for ch in st["children"]:
            try:
                if ch["dead"]:
                    ch["client"].call("push_abort", object_id=object_id,
                                      timeout=10.0)
                    continue
                while ch["pending"]:
                    ch["pending"].popleft().result(timeout=60.0)
                ch["client"].call("push_end", object_id=object_id,
                                  timeout=120.0)
            except Exception as e:
                ch["dead"] = True
                logger.info("cascading push_end of %s to %s failed: %r",
                            object_id.hex()[:8], ch["address"], e)
        failed_children = [ch for ch in st["children"] if ch["dead"]]
        # chunk-tree failover: a child that died mid-stream orphaned
        # its whole subtree. We hold a sealed, CRC-verified replica, so
        # re-root the orphans HERE: each grandchild gets a fresh push
        # whose push_begin carries reroot=True, superseding the
        # half-open inbound the dead relay left behind. Best-effort —
        # if the re-offer loses a race with the dead child's own abort
        # cascade, the driver's re-pull convergence still covers the
        # subtree (the pre-failover behavior).
        if (ok and not corrupt and failed_children
                and Config.instance().chunk_tree_failover_enabled):
            from ray_tpu_torch.observability.metrics import chunk_tree_failovers
            for ch in failed_children:
                kids = ch.get("subtree") or []
                if not kids:
                    continue
                with self._stats_lock:
                    self.num_tree_failovers += 1
                chunk_tree_failovers.inc()
                _overload.lane_failed("data_plane")
                logger.info("re-rooting %d orphaned subtree(s) of %s "
                            "after relay %s died mid-broadcast",
                            len(kids), object_id.hex()[:8],
                            ch["address"])
                for item in kids:
                    try:
                        addr, sub = item[0], item[1]
                    except (TypeError, IndexError):
                        continue
                    self._mark_reroot(object_id, addr)
                    self.push_manager.push(object_id, addr,
                                           downstream=sub or None)
        st["event"].set()
        out = {"ok": ok and not corrupt}
        if corrupt:
            out["corrupt"] = True
        return out

    def _accept_push(self, object_id: bytes, payload: bytes,
                     is_error: bool, crc: Optional[int] = None) -> None:
        self.store.put(object_id, payload, is_error, primary=False,
                       crc=crc)
        self._register_location(object_id, len(payload))

    # ---------------------------------------------------------------- tasks
    def submit_task(self, spec: dict) -> dict:
        """spec: task_id, func(bytes), args(list of ("v", bytes)|("ref",
        oid)), kwargs(dict name->same), resources, return_id, owner."""
        demand = spec.get("resources") or {}
        with self._avail_lock:
            feasible = all(self.resources.get(k, 0.0) >= v
                           for k, v in demand.items())
        if not feasible:
            return {"accepted": False, "reason": "infeasible"}
        cfg = Config.instance()
        with self._queue_cv:
            # Backpressure: the submit queue is bounded — beyond the
            # bound the caller gets a typed RetryLaterError (with a
            # queue-scaled hint) instead of the queue growing without
            # limit (reference: raylet task backpressure /
            # max_pending_lease_requests_per_scheduling_category).
            if (cfg.overload_enabled
                    and len(self._task_queue)
                    >= cfg.raylet_max_queued_tasks):
                with self._stats_lock:
                    self.num_tasks_shed += 1
                depth = len(self._task_queue)
                from ray_tpu_torch.observability.metrics import tasks_shed

                tasks_shed.inc()
                raise RetryLaterError(
                    f"node {self.node_id[:8]} task queue is full "
                    f"({depth} queued); slow down",
                    retry_after_s=min(2.0, 0.05 + 1e-4 * depth))
            self._task_queue.append(_QueuedTask(spec))
            self._queue_cv.notify()
        return {"accepted": True, "node_id": self.node_id}

    def submit_task_batch(self, specs: List[dict]) -> dict:
        """Batched ``submit_task`` (dispatch fast lane): N specs per
        wire frame, admitted under ONE condition hold. Admission is
        per row — feasibility and the bounded-queue shed are checked
        spec by spec, and backpressure rides the result row
        (``{accepted: False, reason: "backpressure", retry_after_s}``,
        the RetryLaterError hint in-band) instead of failing the
        frame, so an overload sheds only the overflow rows while their
        siblings land. Rows may carry a per-row ``token`` (stamped once
        at driver submit time, stable across retries): an accepted
        row's token caches its reply, so a RETRIED frame after a lost
        ack replays the ack instead of enqueueing the task twice.
        Tokens are popped before the spec reaches the queue — the
        executed spec is byte-identical to the untokened path."""
        cfg = Config.instance()
        from ray_tpu_torch.observability.metrics import (
            batch_rows_deduped,
            tasks_shed,
        )

        with self._avail_lock:
            totals = dict(self.resources)
        results: List[dict] = []
        accepted: List[_QueuedTask] = []
        replayed = 0
        with self._queue_cv:
            depth = len(self._task_queue)
            for spec in specs:
                tok = spec.pop("token", "") or ""
                cached = self._row_token_seen(tok)
                if cached is not None:
                    results.append(cached)
                    replayed += 1
                    continue
                demand = spec.get("resources") or {}
                if any(totals.get(k, 0.0) < v
                       for k, v in demand.items()):
                    results.append({"accepted": False,
                                    "reason": "infeasible"})
                    continue
                if (cfg.overload_enabled
                        and depth >= cfg.raylet_max_queued_tasks):
                    with self._stats_lock:
                        self.num_tasks_shed += 1
                    tasks_shed.inc()
                    results.append({
                        "accepted": False, "reason": "backpressure",
                        "retry_after_s": min(2.0,
                                             0.05 + 1e-4 * depth)})
                    continue
                accepted.append(_QueuedTask(spec))
                depth += 1
                row = {"accepted": True, "node_id": self.node_id}
                # only ACCEPTED rows cache: a shed/infeasible row is
                # not a mutation — the retry must be re-admitted fresh
                self._row_token_store(tok, row)
                results.append(row)
            if accepted:
                self._task_queue.extend(accepted)
                self._queue_cv.notify_all()
        if replayed:
            batch_rows_deduped.inc(
                replayed, tags={"method": "submit_task_batch"})
        return {"results": results, "node_id": self.node_id}

    # --------------------------------------------- per-row batch dedupe
    def _row_token_seen(self, token: str) -> Optional[dict]:
        """Cached reply row for a retried batch row (caller holds
        ``_queue_cv``); None admits the row."""
        if not token:
            return None
        return self._row_tokens.get(token)

    def _row_token_store(self, token: str, row: dict) -> None:
        """Cache an applied row's reply under its token (caller holds
        ``_queue_cv``); LRU-bounded like the GCS request-token cache."""
        if not token:
            return
        self._row_tokens[token] = row
        while len(self._row_tokens) > self._row_token_cap:
            self._row_tokens.popitem(last=False)

    def task_state(self, task_id: str) -> dict:
        with self._queue_cv:
            if task_id in self._done:
                return {"state": self._done[task_id]}
            if task_id in self._running:
                return {"state": "running"}
            if any(t.spec["task_id"] == task_id for t in self._task_queue):
                return {"state": "queued"}
        return {"state": "unknown"}

    def wait_task(self, task_id: str, timeout_s: float = 10.0) -> dict:
        deadline = time.monotonic() + timeout_s
        with self._queue_cv:
            while task_id not in self._done:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    break
                self._queue_cv.wait(remaining)
        return self.task_state(task_id)

    def _try_allocate(self, demand: Dict[str, float]) -> bool:
        with self._avail_lock:
            if all(self.available.get(k, 0.0) >= v - 1e-9
                   for k, v in demand.items()):
                for k, v in demand.items():
                    self.available[k] = self.available.get(k, 0.0) - v
                return True
            return False

    def _free(self, demand: Dict[str, float]) -> None:
        with self._avail_lock:
            for k, v in demand.items():
                self.available[k] = self.available.get(k, 0.0) + v

    def _dispatch_loop(self) -> None:
        while not self._stop.is_set():
            task: Optional[_QueuedTask] = None
            batch: List[_QueuedTask] = []
            with self._queue_cv:
                while not self._task_queue and not self._stop.is_set():
                    self._queue_cv.wait(0.5)
                if self._stop.is_set():
                    return
                for i, cand in enumerate(self._task_queue):
                    if self._try_allocate(cand.spec.get("resources") or {}):
                        task = cand
                        del self._task_queue[i]
                        break
                if task is None:
                    self._queue_cv.wait(0.05)
                    continue
                self._running[task.spec["task_id"]] = task.spec
                batch.append(task)
                cfg = Config.instance()
                if cfg.dispatch_fastlane_enabled:
                    # Deep-backlog coalescing only: extra tasks ride
                    # this worker's ONE task_batch pipe frame (they run
                    # serially on it), so grab them only while the
                    # queue is deeper than the pool could drain in
                    # parallel anyway — a shallow queue keeps the exact
                    # one-task-per-lease concurrency.
                    extra = min(cfg.dispatch_batch_max - 1,
                                len(self._task_queue)
                                - 2 * self.pool.size)
                    while extra > 0 and self._task_queue:
                        cand = self._task_queue[0]
                        if not self._try_allocate(
                                cand.spec.get("resources") or {}):
                            break
                        self._task_queue.popleft()
                        self._running[cand.spec["task_id"]] = cand.spec
                        batch.append(cand)
                        extra -= 1
            try:
                if len(batch) == 1:
                    self._execute(task.spec)
                else:
                    with self._stats_lock:
                        self.num_exec_batches += 1
                        self.num_exec_batch_rows += len(batch)
                    self._execute_batch(batch)
            finally:
                for t in batch:
                    self._free(t.spec.get("resources") or {})
                with self._queue_cv:
                    for t in batch:
                        self._running.pop(t.spec["task_id"], None)
                    self._queue_cv.notify_all()

    def _same_host_handoff(self, object_id: bytes):
        """Zero-copy consumption of a same-host peer's object: pin it in
        the HOLDER's segment (C-store refcount, process-shared; deletes
        defer while pinned) and return (seg, key, path) for a
        StoredObjectArg — no replica, no copy; the worker reads the
        holder's pages in place. This is plasma's one-store-per-host
        model recovered for colocated raylet processes; cross-host
        objects still go through the chunked pull. Returns None when no
        same-host shm holder exists."""
        try:
            reply = self.gcs.call("object_locations",
                                  object_id=object_id, timeout=10.0)
        except (RpcConnectionError, TimeoutError):
            return None
        for loc in reply["locations"]:
            if loc["node_id"] == self.node_id:
                continue
            try:
                info = self._peer(loc["address"]).call(
                    "get_object_info", object_id=object_id, timeout=10.0)
            except (RpcConnectionError, TimeoutError, OSError):
                continue
            if not info.get("present") or info.get("is_error"):
                continue  # error payloads raise in the raylet: pull path
            path = info.get("shm_path")
            if not path:
                continue
            seg = self._attach_peer_shm(path)
            if seg is None:
                continue
            key = shm_key(object_id)
            try:
                region = seg.pin_region(key)  # the pin
            except Exception:
                region = None
            if region is None:
                continue
            off, size = region
            # a trailer-bearing entry (integrity plane) is 8 bytes
            # longer than the logical object; the worker reads only
            # the logical bytes either way
            if size not in (info["size"],
                            info["size"] + integrity.TRAILER_SIZE):
                seg.release(key)
                continue
            with self._stats_lock:
                self.num_zero_copy_handoffs += 1
            return seg, key, path, off, info["size"]
        return None

    def _resolve_args(self, packed, pinned: Optional[list] = None) -> Any:
        """("v", bytes) -> loads; ("ref", oid) -> pull + pin + loads.
        Stored errors propagate to the task as the reference does when a
        dependency failed (task fails with the dependency's error).
        Resolved refs are PINNED in the store (appended to ``pinned``;
        the caller unpins after the task finishes) so a concurrent
        put's reclaim cannot evict an argument between its pull and its
        use — the DependencyManager/plasma-pin contract."""
        kind, payload = packed
        if kind == "v":
            return protocol.loads(payload)
        if (pinned is not None and self.pool.shm_path
                and not self.store.contains(payload)
                and Config.instance().same_host_zero_copy_reads):
            handoff = self._same_host_handoff(payload)
            if handoff is not None:
                seg, key, path, off, size = handoff
                pinned.append(("peer", seg, key))
                return protocol.StoredObjectArg(key, path, off, size)
        corrupt_seen = False
        for attempt in range(4):
            # a replica eviction, a transient peer failure, or a
            # DISCARDED CORRUPT REPLICA can race the pull; each retry
            # re-resolves locations from the directory
            if not self._pull_object(payload):
                time.sleep(0.05 * attempt)
                continue
            meta = self.store.pin(payload)
            if meta is None:
                time.sleep(0.05 * attempt)
                continue
            keep_pin = False
            try:
                if (pinned is not None and not meta["is_error"]
                        and meta["where"] == "shm"
                        and self.pool.shm_path):
                    # zero-copy handoff: the worker reads the pinned
                    # segment entry itself; only the 20-byte key
                    # crosses the pipe. The pin (held until the task
                    # ends) blocks eviction and spill for the read
                    # window.
                    spath = meta.get("shm_path")
                    if spath and spath != self.store.shm_path:
                        # ADOPTED replica: the bytes sit in the OWNER's
                        # segment — hand the worker that segment's
                        # (path, offset, size) like a peer handoff; our
                        # store pin (which rides the owner's refcount)
                        # keeps the block alive for the read window
                        from ray_tpu_torch.cluster.byte_store import attach_shm
                        seg = attach_shm(spath)
                        region = None
                        if seg is not None:
                            try:
                                # pin_region returns (offset, size)
                                # metadata, not a handle: the pin itself
                                # is keyed and recorded in `pinned`
                                # below, released by run_task's unwind
                                # raycheck: disable=RC12 — pin keyed in `pinned`, released at task end
                                region = seg.pin_region(shm_key(payload))
                            except Exception:
                                region = None
                        if region is not None:
                            off, rsize = region
                            keep_pin = True
                            pinned.append(("own", payload))
                            pinned.append(("peer", seg,
                                           shm_key(payload)))
                            return protocol.StoredObjectArg(
                                shm_key(payload), spath, off,
                                meta["size"])
                        # fall through to the copy path below
                    else:
                        keep_pin = True
                        pinned.append(("own", payload))
                        return protocol.StoredObjectArg(shm_key(payload))
                try:
                    entry = self.store.get(payload)
                except ObjectCorruptedError as e:
                    # the local replica failed its spill digest and
                    # discarded itself: re-pull from another holder
                    corrupt_seen = True
                    logger.warning(
                        "dependency %s corrupt locally (%s); "
                        "re-pulling", payload.hex()[:8], e.seam)
                    continue
                if entry is None:  # explicitly deleted under us
                    raise WorkerCrashedError(
                        f"dependency {payload.hex()[:8]} unavailable")
                is_error, data = entry
                value = protocol.loads_flat(data)
                if is_error:
                    raise value if isinstance(value, BaseException) \
                        else RuntimeError(str(value))
                if pinned is not None:
                    keep_pin = True
                    pinned.append(("own", payload))
                return value
            finally:
                if not keep_pin:
                    self.store.unpin(payload)
        raise WorkerCrashedError(
            f"dependency {payload.hex()[:8]} unavailable"
            + (" (corrupt replicas discarded)" if corrupt_seen else ""))

    def _stage_py_modules(self, runtime_env) -> None:
        """Pre-stage pymod:// archives into the host cache THROUGH THE
        RAYLET'S GCS KV before dispatch: worker processes have no GCS
        client, so the node-level agent does the fetch (reference: the
        per-node runtime-env agent downloads packages, workers only
        read the cache)."""
        entries = []
        if runtime_env is not None:
            try:
                entries = list(runtime_env.get("py_modules") or [])
            except AttributeError:
                return
        uris = [e for e in entries
                if isinstance(e, str) and e.startswith("pymod://")]
        if not uris:
            return
        from ray_tpu_torch._private.runtime_env_packaging import (
            KV_NAMESPACE,
            default_py_modules_manager,
        )

        def fetch(key: bytes):
            return self.gcs.call("kv_get", ns=KV_NAMESPACE, key=key,
                                 timeout=30.0)

        manager = default_py_modules_manager()
        for uri in uris:
            try:
                manager.ensure_local(uri, fetch=fetch)
            except Exception:  # noqa: BLE001 — surface at import time
                logger.warning("py_modules stage failed for %s", uri,
                               exc_info=True)

    def _execute(self, spec: dict) -> None:
        task_id = spec["task_id"]
        return_id = spec["return_id"]
        # Sampled traces carry their context inside the spec (stamped by
        # ClusterClient.submit), so the execution span parents to the
        # driver's submit span across two process hops.
        wire_trace = spec.get("trace_context")
        if wire_trace is not None:
            # raycheck: disable=RC02 — wall-clock span timestamp for cross-process trace correlation, not deadline arithmetic
            exec_wall = time.time()
        exec_t0 = time.monotonic()
        pinned: list = []
        try:
            func = protocol.loads(spec["func"])
            args = [self._resolve_args(a, pinned)
                    for a in spec.get("args", [])]
            kwargs = {k: self._resolve_args(v, pinned)
                      for k, v in (spec.get("kwargs") or {}).items()}
            self._stage_py_modules(spec.get("runtime_env"))
            result = self.pool.run(
                func, tuple(args), kwargs,
                runtime_env=spec.get("runtime_env"),
                result_key=shm_key(return_id),
                spare=not spec.get("resources"))
            if isinstance(result, protocol.StoredResult):
                # worker wrote the payload into the segment: adopt it —
                # the result never crossed the pipe
                if not self.store.adopt_shm(return_id, result.nbytes):
                    raise WorkerCrashedError(
                        "stored task result vanished from the segment")
                self._register_location(return_id, result.nbytes)
            elif isinstance(result, protocol.FlatPayload):
                # already in stored-object format: store verbatim (the
                # result is serialized exactly once, worker-side)
                self.store.put(return_id, result.body, is_error=False)
                self._register_location(return_id, len(result.body))
            else:
                payload = protocol.dumps_flat(result)
                self.store.put(return_id, payload, is_error=False)
                self._register_location(return_id, len(payload))
            state = "done"
        except BaseException as e:  # noqa: BLE001 — becomes a stored error
            payload = protocol.dumps_flat(protocol.restore_exception(
                *protocol.format_exception(e)))
            self.store.put(return_id, payload, is_error=True)
            self._register_location(return_id, len(payload))
            state = "failed"
            logger.info("task %s failed: %r", task_id[:8], e)
        finally:
            for entry in pinned:
                if entry[0] == "own":
                    self.store.unpin(entry[1])
                else:  # ("peer", seg, key): drop the peer-segment pin
                    try:
                        entry[1].release(entry[2])
                    except Exception as e:
                        # holder process may have died mid-task; its
                        # segment (and refcount) died with it
                        logger.debug("peer-segment unpin of %s failed: "
                                     "%r", entry[2].hex()[:8], e)
        if wire_trace is not None:
            try:
                from ray_tpu_torch.util import tracing
                tracing.record_remote_span(
                    "task.execute", wire_trace, exec_wall,
                    exec_wall + (time.monotonic() - exec_t0),
                    attributes={"task_id": str(task_id)[:16],
                                "dst_kind": "raylet"},
                    status="OK" if state == "done" else "ERROR")
            except Exception as e:
                logger.debug("task execution span failed: %r", e)
        with self._queue_cv:
            self._done[task_id] = state
            while len(self._done) > self._done_cap:
                self._done.popitem(last=False)
            self._queue_cv.notify_all()

    def _adopt_result(self, return_id: bytes, result: Any) -> None:
        """Land one worker-produced result in the local store (the
        three transports ``_execute`` handles: shm adoption, verbatim
        flat payload, inline value)."""
        if isinstance(result, protocol.StoredResult):
            if not self.store.adopt_shm(return_id, result.nbytes):
                raise WorkerCrashedError(
                    "stored task result vanished from the segment")
            self._register_location(return_id, result.nbytes)
        elif isinstance(result, protocol.FlatPayload):
            self.store.put(return_id, result.body, is_error=False)
            self._register_location(return_id, len(result.body))
        else:
            payload = protocol.dumps_flat(result)
            self.store.put(return_id, payload, is_error=False)
            self._register_location(return_id, len(payload))

    def _finish_batch_row(self, spec: dict, exc: Optional[BaseException],
                          pinned: list, exec_wall: Optional[float],
                          exec_t0: float) -> None:
        """Terminal bookkeeping for one fast-lane batch row — the
        stored-error path, pin release, execution span, and the _done
        transition ``_execute`` performs for a serial task."""
        task_id = spec["task_id"]
        if exc is None:
            state = "done"
        else:
            return_id = spec["return_id"]
            payload = protocol.dumps_flat(protocol.restore_exception(
                *protocol.format_exception(exc)))
            self.store.put(return_id, payload, is_error=True)
            self._register_location(return_id, len(payload))
            state = "failed"
            logger.info("task %s failed: %r", task_id[:8], exc)
        for entry in pinned:
            if entry[0] == "own":
                self.store.unpin(entry[1])
            else:  # ("peer", seg, key)
                try:
                    entry[1].release(entry[2])
                except Exception as e:
                    logger.debug("peer-segment unpin of %s failed: %r",
                                 entry[2].hex()[:8], e)
        wire_trace = spec.get("trace_context")
        if wire_trace is not None and exec_wall is not None:
            try:
                from ray_tpu_torch.util import tracing
                tracing.record_remote_span(
                    "task.execute", wire_trace, exec_wall,
                    exec_wall + (time.monotonic() - exec_t0),
                    attributes={"task_id": str(task_id)[:16],
                                "dst_kind": "raylet",
                                "batched": "1"},
                    status="OK" if state == "done" else "ERROR")
            except Exception as e:
                logger.debug("task execution span failed: %r", e)
        with self._queue_cv:
            self._done[task_id] = state
            while len(self._done) > self._done_cap:
                self._done.popitem(last=False)
            self._queue_cv.notify_all()

    def _execute_batch(self, tasks: List[_QueuedTask]) -> None:
        """Fast-lane execution of N dispatched tasks as ONE
        ``task_batch`` pipe frame on ONE leased worker: args resolve
        raylet-side per row (pins held for the batch's duration, same
        contract as ``_execute``), the worker runs the rows serially,
        and all N results return in one reply frame. Per-row failures
        (arg resolution, user exceptions) become that row's stored
        error; only a worker death fails every remaining row."""
        # raycheck: disable=RC02 — wall-clock span timestamp for cross-process trace correlation, not deadline arithmetic
        exec_wall = time.time() if any(
            t.spec.get("trace_context") is not None for t in tasks) \
            else None
        exec_t0 = time.monotonic()
        rows: List[Tuple[dict, list, dict]] = []  # (spec, pinned, item)
        for t in tasks:
            spec = t.spec
            pinned: list = []
            try:
                func = protocol.loads(spec["func"])
                args = [self._resolve_args(a, pinned)
                        for a in spec.get("args", [])]
                kwargs = {k: self._resolve_args(v, pinned)
                          for k, v in (spec.get("kwargs") or {}).items()}
                self._stage_py_modules(spec.get("runtime_env"))
                rows.append((spec, pinned, {
                    "func": func, "args": tuple(args), "kwargs": kwargs,
                    "runtime_env": spec.get("runtime_env"),
                    "result_key": shm_key(spec["return_id"])}))
            except BaseException as e:  # noqa: BLE001 — stored error
                self._finish_batch_row(spec, e, pinned, exec_wall,
                                       exec_t0)
        if not rows:
            return
        try:
            results = self.pool.run_batch([item for _, _, item in rows])
        except BaseException as e:  # noqa: BLE001 — worker death
            for spec, pinned, _ in rows:
                self._finish_batch_row(spec, e, pinned, exec_wall,
                                       exec_t0)
            return
        for (spec, pinned, _), (status, body) in zip(rows, results):
            exc: Optional[BaseException] = None
            if status == "ok":
                try:
                    self._adopt_result(spec["return_id"], body)
                except BaseException as e:  # noqa: BLE001
                    exc = e
            else:
                exc = body
            self._finish_batch_row(spec, exc, pinned, exec_wall,
                                   exec_t0)

    # ---------------------------------------------------------------- actors
    def create_actor(self, actor_id: str, cls_bytes: bytes,
                     args_bytes: bytes, resources: Dict[str, float],
                     incarnation: int = 0) -> dict:
        from ray_tpu_torch.observability.metrics import actor_create_latency_ms

        t0 = time.monotonic()
        try:
            cls = protocol.loads(cls_bytes)
        except Exception as e:  # noqa: BLE001 — deterministic: bad class
            raise ActorInitError(
                f"actor {actor_id[:8]} class failed to deserialize: "
                f"{e!r}") from e
        args, kwargs = protocol.loads(args_bytes)
        args = [self._resolve_args(a) if isinstance(a, tuple)
                and len(a) == 2 and a[0] in ("v", "ref") else a
                for a in args]
        if not self._try_allocate(resources or {}):
            raise RuntimeError(
                f"node {self.node_id[:8]} lacks resources for actor")
        try:
            proxy = self.pool.create_actor_process(cls, tuple(args), kwargs)
        except WorkerCrashedError:
            # infra death (OOM kill, fork crash): the GCS may retry on
            # another node
            self._free(resources or {})
            raise
        except BaseException as e:
            self._free(resources or {})
            if isinstance(e, ActorInitError):
                raise
            # the worker ran user __init__ and it raised: DETERMINISTIC
            # — typed so the GCS marks the actor DEAD with the error
            # instead of burning placement retries on other nodes
            raise ActorInitError(
                f"actor {actor_id[:8]} __init__ failed: {e!r}") from e
        with self._actor_lock:
            self._actors[actor_id] = {
                "proxy": proxy, "incarnation": incarnation,
                "resources": dict(resources or {}),
            }
        actor_create_latency_ms.observe((time.monotonic() - t0) * 1e3)
        return {"ok": True, "incarnation": incarnation}

    def actor_call(self, actor_id: str, method_name: str,
                   args_bytes: bytes) -> bytes:
        with self._actor_lock:
            rec = self._actors.get(actor_id)
        if rec is None:
            raise KeyError(f"actor {actor_id[:8]} not on node "
                           f"{self.node_id[:8]}")
        args, kwargs = protocol.loads(args_bytes)
        args = [self._resolve_args(a) if isinstance(a, tuple)
                and len(a) == 2 and a[0] in ("v", "ref") else a
                for a in args]
        try:
            result = getattr(rec["proxy"], method_name)(*args, **kwargs)
        except WorkerCrashedError:
            # actor process died (not the node): report so the GCS can
            # restart it, then surface the death to the caller
            with self._actor_lock:
                self._actors.pop(actor_id, None)
            self._free(rec["resources"])
            try:
                # token: one restart per OBSERVED death — a duplicated
                # or retried report must not burn two restarts
                self.gcs.call("report_actor_failure", actor_id=actor_id,
                              token=os.urandom(8).hex(), timeout=10.0)
            except (RpcConnectionError, TimeoutError) as e:
                # GCS unreachable: node-death detection (or the next
                # caller's report) restarts the actor instead
                logger.debug("actor-failure report for %s failed: %r",
                             actor_id[:8], e)
            raise
        return protocol.dumps(result)

    def kill_actor(self, actor_id: str) -> dict:
        with self._actor_lock:
            rec = self._actors.pop(actor_id, None)
        if rec is None:
            return {"ok": False}
        try:
            rec["proxy"].__ray_on_kill__()
        except Exception as e:
            # kill is best-effort; terminate() escalates to SIGKILL
            logger.debug("actor %s kill hook failed: %r",
                         actor_id[:8], e)
        self._free(rec["resources"])
        return {"ok": True}

    # raycheck: disable=RC11 — kill rows are idempotent: killing an already-dead actor is a no-op (each kill re-checks the live-actor map), so a replayed frame changes nothing; the GCS-side actor_kill_batch holds the row tokens
    def kill_actor_batch(self, actor_ids: List[str]) -> dict:
        """One frame kills a node's whole share of an actor_kill_batch
        (GCS fan-out). Each kill is independent but NOT free — a clean
        warm-pool return is an actor_reset pipe round trip (worker-side
        gc.collect()), a dirty one a terminate wait — so the loop fans
        out over a bounded work-stealing thread set instead of paying
        those round trips serially (2000 kills must land in seconds)."""
        ok: Dict[str, bool] = {}
        ok_lock = threading.Lock()
        idx = itertools.count()

        def drain():
            while True:
                i = next(idx)
                if i >= len(actor_ids):
                    return
                aid = actor_ids[i]
                good = bool(self.kill_actor(aid).get("ok"))
                with ok_lock:
                    ok[aid] = good

        width = min(16, len(actor_ids))
        if width <= 1:
            drain()
        else:
            workers = [self._threads.spawn(
                drain, f"raylet-kill-batch-{t}") for t in range(width)]
            # budgeted join (RC17): a worker wedged on one actor's
            # terminate must not hang the whole batch RPC forever
            deadline = (time.monotonic()
                        + Config.instance().batch_fanout_join_timeout_s)
            for t in workers:
                t.join(max(0.0, deadline - time.monotonic()))
                if t.is_alive():
                    logger.warning("kill_actor_batch: worker %s still "
                                   "busy past join budget", t.name)
        return {"results": [{"actor_id": aid, "ok": ok.get(aid, False)}
                            for aid in actor_ids]}

    # ------------------------------------------------------------- PG 2PC
    # All three phases are IDEMPOTENT keyed by (pg_id, bundle_index)
    # (reference: placement_group_resource_manager.h's bundle state
    # table): a duplicated frame or a GCS retry after a lost ack must
    # not double-reserve, double-apply shadow resources, or double-free.
    def prepare_bundle(self, pg_id: str, bundle_index: int,
                       bundle: Dict[str, float]) -> bool:
        key = (pg_id, bundle_index)
        with self._avail_lock:
            if key in self._committed_bundles:
                return True  # retried prepare after the commit landed
            if key in self._prepared_bundles:
                # duplicated/retried prepare: reservation exists —
                # refresh its lease instead of allocating again
                self._prepared_at[key] = time.monotonic()
                return True
            if not self._try_allocate(bundle):
                return False
            self._prepared_bundles[key] = dict(bundle)
            self._prepared_at[key] = time.monotonic()
            return True

    def commit_bundle(self, pg_id: str, bundle_index: int,
                      bundle: Dict[str, float]) -> dict:
        from ray_tpu_torch.scheduler.placement_group import (
            shadow_resources_for_bundle,
        )

        key = (pg_id, bundle_index)
        with self._avail_lock:
            if key in self._committed_bundles:
                return {"ok": True, "duplicate": True}
            if key not in self._prepared_bundles:
                # prepare never landed here (or its lease expired and
                # the reservation was returned): applying shadow
                # capacity with no base reservation would oversubscribe
                # the node — tell the GCS to re-prepare
                return {"ok": False, "reason": "not prepared"}
            shadow = shadow_resources_for_bundle(bundle, pg_id,
                                                 bundle_index)
            for name, amount in shadow.items():
                self.resources[name] = self.resources.get(name, 0.0) + amount
                self.available[name] = self.available.get(name, 0.0) + amount
            self._committed_bundles.add(key)
            self._prepared_at.pop(key, None)  # lease is for the gap only
        return {"ok": True}

    def return_bundle(self, pg_id: str, bundle_index: int,
                      bundle: Dict[str, float],
                      committed: bool = False) -> dict:
        from ray_tpu_torch.scheduler.placement_group import (
            shadow_resources_for_bundle,
        )

        key = (pg_id, bundle_index)
        with self._avail_lock:
            if committed and key in self._committed_bundles:
                shadow = shadow_resources_for_bundle(bundle, pg_id,
                                                     bundle_index)
                for name in shadow:
                    self.resources.pop(name, None)
                    self.available.pop(name, None)
            self._committed_bundles.discard(key)
            self._prepared_at.pop(key, None)
            if self._prepared_bundles.pop(key, None) is not None:
                self._free(bundle)
        return {"ok": True}

    def _expire_prepared_bundles(self) -> None:
        """Reclaim prepared-but-uncommitted bundles whose GCS vanished
        mid-2PC (reference: ReleaseUnusedBundles on GCS restart) — the
        lease keeps a dead coordinator from leaking node capacity
        forever. Runs on the heartbeat cadence."""
        lease = Config.instance().pg_prepare_lease_s
        if lease <= 0:
            return
        now = time.monotonic()
        with self._avail_lock:
            for key, t0 in list(self._prepared_at.items()):
                if key in self._committed_bundles:
                    self._prepared_at.pop(key, None)
                    continue
                if now - t0 < lease:
                    continue
                bundle = self._prepared_bundles.pop(key, None)
                self._prepared_at.pop(key, None)
                if bundle is not None:
                    self._free(bundle)
                    logger.warning(
                        "prepared bundle %s expired uncommitted after "
                        "%.0fs; reservation returned", key, lease)

    # ------------------------------------------------------------ stats
    def node_stats(self) -> dict:
        with self._avail_lock:
            avail = dict(self.available)
            totals = dict(self.resources)
        with self._stats_lock:
            dispatch = {"exec_batches": self.num_exec_batches,
                        "exec_batch_rows": self.num_exec_batch_rows}
            fetches = {"shm": self.num_shm_fetches,
                       "stream": self.num_stream_fetches,
                       "zero_copy": self.num_zero_copy_handoffs,
                       "push_shm_in": self.num_push_shm_in,
                       "push_stream_in": self.num_push_stream_in,
                       "chunks_in": self.num_chunks_in,
                       "chunks_forwarded": self.num_chunks_forwarded,
                       "push_teardowns": self.num_push_teardowns,
                       "tree_failovers": self.num_tree_failovers,
                       "cut_through_overlap_pct": (
                           100.0 * self.ct_overlap_sum
                           / self.ct_overlap_n
                           if self.ct_overlap_n else None)}
        with self._actor_lock:
            num_actors = len(self._actors)
        with self._drain_lock:
            draining = self._draining
        with self._queue_cv:
            queued = len(self._task_queue)
            running = len(self._running)
            # per-demand queue introspection for the autoscaler
            # (reference: raylets report resource_load_by_shape in
            # their resource reports; gcs_resource_report_poller.cc
            # relays it into LoadMetrics) — capped so a deep queue
            # doesn't bloat the stats RPC
            queued_demands = [dict(t.spec.get("resources") or {})
                              for t in list(self._task_queue)[:256]]
        return {
            "node_id": self.node_id,
            "resources": totals,
            "available": avail,
            "queued": queued,
            "queued_demands": queued_demands,
            "running": running,
            "dispatch": dispatch,
            "store": self.store.stats(),
            "fetches": fetches,
            "push": self.push_manager.stats(),
            "pool": self.pool.stats(),
            "actors": num_actors,
            "agent": _process_stats(),
            "overload": self._overload_stats(),
            "integrity": self._integrity_stats(),
            "serve": self._serve_stats(),
            # live background threads by root-function label (the
            # naming raycheck RC16/RC17 reports share) for cli status
            "threads": self._threads.roots(),
            # drain plane: GCS-confirmed draining state + seconds left
            # on a pending preemption notice (None if none)
            "draining": draining,
            "preempt_notice_s": self._preempt_remaining(),
        }

    def perf_dump(self) -> dict:
        """Observability plane: this node's flight-recorder snapshot —
        recent spans/events from the bounded ring, the drop count, and
        the heartbeat-measured clock offset — for the GCS's
        collect_timeline fan-out (`cli.py timeline`)."""
        from ray_tpu_torch.observability import flight_recorder

        snap = flight_recorder.global_recorder.snapshot()
        snap["node_id"] = self.node_id
        # live background threads by root-function label — the same
        # naming raycheck RC16/RC17 reports use (threads.root_label),
        # so a timeline lane and a data-race report line up by name
        snap["thread_roots"] = self._threads.roots()
        return snap

    def _integrity_stats(self) -> dict:
        """This node's integrity-plane counters: detected corruptions,
        discarded replicas, verified bytes (process-wide metric sums)
        plus the store's own drop/adopt counts. Rides heartbeats so
        `cli.py status` shows them cluster-wide."""
        out = integrity.snapshot()
        out["corrupt_dropped"] = self.store.num_corrupt_dropped
        out["orphans_adopted"] = self.store.num_orphans_adopted
        return out

    def _serve_stats(self) -> dict:
        """This process's serve-resilience counters (unhealthy
        replicas, completed drains, router exclusions, backpressured
        requests) — process-wide metric sums, riding heartbeats so
        `cli.py status` shows the serving layer's health cluster-wide
        next to the overload/integrity planes."""
        from ray_tpu_torch.observability.metrics import get_metric

        out = {}
        for short, name in (
                ("replicas_unhealthy", "ray_tpu_serve_replicas_unhealthy"),
                ("drains_completed", "ray_tpu_serve_drains_completed"),
                ("router_excluded", "ray_tpu_serve_router_excluded"),
                ("requests_backpressured",
                 "ray_tpu_serve_requests_backpressured")):
            m = get_metric(name)
            out[short] = sum(m.series().values()) if m is not None else 0
        return out

    def _worker_pool_stats(self) -> dict:
        """This node's warm-pool counters (hits/misses/returns/reaps,
        idle depth) plus the local actor-create latency p50. Rides the
        heartbeat so `cli.py status` shows the actor fast path
        cluster-wide next to the overload/integrity/serve planes."""
        from ray_tpu_torch.observability.metrics import actor_create_latency_ms

        out = {k: v for k, v in self.pool.stats().items()
               if k.startswith("warm_")}
        p50 = actor_create_latency_ms.percentile(50)
        if p50 is not None:
            out["create_ms_p50"] = p50
        return out

    def _overload_stats(self) -> dict:
        """This node's overload-plane counters: RPC admission sheds,
        task-queue backpressure, outbound-push sheds, and the states of
        the process's per-destination retry budgets / breakers (the
        raylet's own clients, e.g. its GCS channel). Rides the
        heartbeat so `cli.py status` can show it cluster-wide."""
        from ray_tpu_torch.cluster import overload

        with self._stats_lock:
            shed = self.num_tasks_shed
        out = {"tasks_shed": shed,
               "push_shed": self.push_manager.stats().get("num_shed", 0)}
        if self.server is not None:
            out["rpc"] = self.server.overload_stats()
        out.update(overload.snapshot())
        return out


def _process_stats() -> dict:
    """Per-node agent stats (reference: dashboard/agent.py's reporter
    module) from stdlib sources — rss from /proc, 1-min load, uptime."""
    import os
    import resource

    stats = {
        "pid": os.getpid(),
        "rss_kb": resource.getrusage(resource.RUSAGE_SELF).ru_maxrss,
        "uptime_s": round(time.monotonic() - _PROC_START, 1),
    }
    try:
        stats["load_1m"] = os.getloadavg()[0]
    except OSError:  # pragma: no cover
        stats["load_1m"] = None
    try:
        with open("/proc/self/statm") as f:
            pages = int(f.read().split()[1])
        stats["rss_kb"] = pages * (os.sysconf("SC_PAGE_SIZE") // 1024)
    except (OSError, ValueError, IndexError) as e:
        # non-Linux: keep getrusage peak rss
        logger.debug("/proc/self/statm unavailable: %r", e)
    return stats


_PROC_START = time.monotonic()


def main(argv: Optional[List[str]] = None) -> None:
    import argparse
    import json

    parser = argparse.ArgumentParser()
    parser.add_argument("--gcs", required=True)
    parser.add_argument("--host", default="127.0.0.1")
    parser.add_argument("--port", type=int, default=0)
    parser.add_argument("--resources", default='{"CPU": 2}')
    parser.add_argument("--num-workers", type=int, default=2)
    parser.add_argument("--node-id", default=None)
    parser.add_argument("--object-store-memory", type=int, default=None)
    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    # arm the crash-dump hooks (SIGUSR2 / uncaught exception → JSONL)
    from ray_tpu_torch.observability import flight_recorder
    flight_recorder.install()
    server = RayletServer(
        args.gcs, resources=json.loads(args.resources),
        num_workers=args.num_workers, node_id=args.node_id,
        object_store_memory=args.object_store_memory)
    srv = server.serve(args.host, args.port)
    print(f"RAYLET_ADDRESS {srv.address} NODE_ID {server.node_id}",
          flush=True)
    try:
        threading.Event().wait()
    except KeyboardInterrupt:
        server.shutdown()


if __name__ == "__main__":
    main()
