"""Global flag system.

Mirrors the reference's single X-macro flag file
(src/ray/common/ray_config_def.h, RayConfig singleton in ray_config.h):
every tunable lives here with a default, can be overridden per-process by
the environment (``RAY_TPU_<name>``) or at ``init(_system_config={...})``
time, and is read through the process-wide singleton ``Config.instance()``.
"""

from __future__ import annotations

import json
import os
import threading
from dataclasses import dataclass, fields


@dataclass
class Config:
    # ---- scheduling ------------------------------------------------------
    # Below this fraction of critical-resource utilization the hybrid
    # policy packs onto low node ids; above it, it spreads.
    # (reference: scheduler_spread_threshold, scheduling_policy.h:31-54)
    scheduler_spread_threshold: float = 0.5
    # Hard cap on tasks of one SchedulingClass dispatched concurrently,
    # as a fraction of the class's resource demand vs node total.
    # raycheck: disable=RC14 — reference-compat knob (worker_cap_enabled); cap path not yet ported
    scheduler_cap_per_class: bool = True
    # How often the raylet runs its scheduling tick (ms).
    # raycheck: disable=RC14 — reference-compat; scheduling here is event-driven, no periodic tick loop
    scheduler_tick_period_ms: int = 10
    # Batch size for the vectorized policy: pending tasks scored per tick.
    scheduler_max_tasks_per_tick: int = 16384
    # Same-class pending tasks at or above this count go through the
    # batched water-filling solve instead of the per-task scan.
    scheduler_batch_threshold: int = 16
    # Use the JAX batched policy when a device is present.
    scheduler_use_vectorized_policy: bool = True
    # Live-path device solve threshold: when a scheduling tick covers at
    # least this many (nodes x batched-classes) cells, the raylet routes
    # the whole tick through the fused jit solve + exact int64 repair
    # instead of the numpy water-filling (reference seam:
    # scheduling_policy.cc:150 behind cluster_resource_scheduler.h:167).
    # Below it, the device dispatch round-trip costs more than it saves.
    # <0 disables the device path entirely.
    scheduler_device_solve_min_cells: int = 8192
    # Master switch for the pipelined scheduler tick (raylet.py
    # _schedule_tick_pipelined): double-buffered device solves (solve
    # batch N+1 while committing batch N), the device-resident resource
    # matrix mirror with dirty-row delta uploads, and the vectorized
    # commit/spillback fan-out. Off restores the exact single-buffered
    # tick — one batch per call, solve pulled synchronously, per-task
    # commit — bit-for-bit (same placements for the same seed).
    scheduler_pipeline_enabled: bool = True
    # Every this-many delta refreshes the DeviceMatrixMirror re-uploads
    # the full matrix anyway, so f32 fold drift cannot accumulate.
    scheduler_matrix_sync_period: int = 64
    # Debug guard: after every mirror refresh, compare the device
    # availability against the host matrix elementwise and raise on the
    # first divergence. Costs a device sync per refresh — development
    # and the scheduler_pipeline test marker only.
    scheduler_pipeline_debug_check: bool = False
    # Workers each node may fork beyond its CPU count (soft limit).
    # raycheck: disable=RC14 — reference-compat (worker_pool.cc); pool forks on demand
    maximum_startup_concurrency: int = 8
    # Milliseconds a leased worker stays bound to a SchedulingKey with no
    # queued work before the lease is returned.
    # raycheck: disable=RC14 — reference-compat; idle reaping rides the autoscaler drain path
    idle_worker_lease_timeout_ms: int = 1000

    # ---- failure detection ----------------------------------------------
    raylet_heartbeat_period_ms: int = 100
    # consecutive missed heartbeats before a node is declared dead
    # (reference: num_heartbeats_timeout=30, ray_config_def.h:51-56)
    num_heartbeats_timeout: int = 30
    # gRPC-equivalent socket timeouts for our TCP control channel.
    rpc_connect_timeout_s: float = 10.0
    task_retry_delay_ms: int = 0
    # ResilientRpcClient retry policy: capped exponential backoff with
    # full jitter inside a bounded window (reference: gcs_rpc_client.h
    # retryable channels; AWS full-jitter so post-partition reconnects
    # don't stampede in lockstep).
    rpc_retry_window_s: float = 30.0
    rpc_retry_base_ms: int = 50
    rpc_retry_max_backoff_ms: int = 2000
    # ---- overload robustness ---------------------------------------------
    # Master switch for the overload plane (admission control, retry
    # budgets, circuit breakers, raylet submit backpressure). Off
    # restores the pre-overload-plane behavior: unbounded dispatch
    # threads and window-only retry limits — the configuration the
    # seeded retry-storm regression test proves is metastable.
    overload_enabled: bool = True
    # RpcServer admission control: bounded dispatch pool + queue
    # (reference: gRPC server thread caps / num_server_call_thread).
    # Requests beyond the queue depth are shed with RetryLaterError.
    rpc_server_max_dispatch_threads: int = 128
    rpc_server_queue_depth: int = 1024
    # Client-side retry budget (token bucket per destination): each
    # retry spends one token; each success earns `fraction` tokens, so
    # aggregate retry traffic is capped at ~fraction x goodput
    # (the SRE retry-budget discipline against metastable retry storms).
    # The bucket starts at `initial` and is capped at `cap`.
    rpc_retry_budget_fraction: float = 0.2
    rpc_retry_budget_initial: float = 10.0
    rpc_retry_budget_cap: float = 50.0
    # Circuit breaker per destination: open after this many consecutive
    # failures, half-open probe after `reset_s` (or the server's
    # RetryLaterError hint, whichever is larger), close on success.
    # 0 disables the breaker.
    rpc_breaker_failure_threshold: int = 8
    rpc_breaker_reset_s: float = 1.0
    # Bound on each raylet's submit queue (both tiers); submits beyond
    # it are pushed back with RetryLaterError so callers slow down
    # instead of queuing unboundedly (reference: raylet task
    # backpressure / max_pending_lease_requests).
    raylet_max_queued_tasks: int = 100_000
    # How long Runtime.submit retries a backpressured raylet before
    # surfacing RetryLaterError to the caller.
    submit_backpressure_timeout_s: float = 60.0
    # PushManager outbound queue bound; pushes beyond it are shed (and
    # counted) rather than queued forever against a slow receiver.
    push_manager_max_queued: int = 512

    # ---- serve resilience plane ------------------------------------------
    # Master switch for the serve resilience plane: controller health
    # probing + unhealthy-replica replacement, overload-aware
    # power-of-two-choices routing (breaker/shed-penalty exclusion,
    # typed BackpressureError), graceful drains, and the replica-side
    # checksummed response seam. Off restores the pre-plane behavior:
    # blind round-robin routing, no probes, immediate kills — the
    # configuration the seeded storm demo proves drops requests and
    # returns wrong answers.
    serve_resilience_enabled: bool = True
    # Controller health-probe defaults (per-deployment overrides in
    # serve.config.DeploymentConfig): probe period, per-probe timeout,
    # and consecutive failures before a replica is declared unhealthy,
    # drained from routing, and replaced (reference: Ray Serve
    # deployment_state.py health_check_period_s/_timeout_s).
    serve_health_check_period_s: float = 0.25
    serve_health_check_timeout_s: float = 2.0
    serve_health_check_failure_threshold: int = 3
    # How long handle.remote() keeps re-polling for an assignable
    # replica before surfacing BackpressureError to the caller.
    serve_router_backpressure_timeout_s: float = 2.0
    # A draining replica keeps ACCEPTING requests for this long after
    # drain() before it starts shedding: covers the router-assignment
    # race (a request routed on the pre-drain membership lands just
    # after the drain began) so a calm rolling update drops nothing.
    serve_drain_grace_s: float = 0.25

    # ---- integrity plane -------------------------------------------------
    # Master switch for end-to-end object checksums (cluster/
    # integrity.py): one crc32 per object computed at creation and
    # verified at every data-movement seam — push assembly, pull
    # completion, spill restore, shm adoption, orphan reclaim. Off
    # restores the pre-plane behavior: a flipped bit flows through
    # unverified (the configuration the seeded corruption demo proves
    # delivers wrong bytes).
    integrity_enabled: bool = True
    # Paranoid end-to-end re-check at ray.get deserialization (every
    # transfer seam already verified the bytes it moved; this catches
    # in-place mutation of buffer values between put and get).
    integrity_verify_on_get: bool = False
    # Re-verify same-host SHARED-MEMORY reads (the shm fast-path
    # replica copies). Back ON by default since the data-plane
    # pipeline: the dominant same-host path is now segment ADOPTION
    # (adopt_remote_shm), where verification is an O(1) integer
    # compare of the offer digest against the segment trailer — the
    # fused put-time digest already vouches for the bytes — and the
    # remaining copying paths use the hardware crc32c backend fused
    # into the copy pass, so the ~90%-of-bracket cost that forced
    # this off in the zlib era (bench: per-byte crc rivaling the
    # memcpy itself) is gone. bench.py prices the residual as
    # broadcast_shm_verify_overhead_pct (bar: <= 5%).
    integrity_verify_shm_reads: bool = True

    # Raylet-side lease on prepared-but-uncommitted PG bundles: if the
    # GCS dies (or is partitioned away) between prepare and commit, the
    # reservation is returned after this long instead of leaking
    # (reference: ReleaseUnusedBundles on GCS restart).
    pg_prepare_lease_s: float = 30.0
    # Deterministic fault-injection plan (inline JSON or a file path);
    # also honored as RAY_TPU_FAULT_PLAN. See cluster/fault_plane.py.
    fault_plan: str = ""
    # sweep_stale_segments only reclaims dead-owner shm segments /
    # spill dirs older than this (mtime age): legacy pid-less names and
    # recycled pids cannot cost a live process its spill data.
    byte_store_sweep_min_age_s: float = 300.0

    # ---- objects ---------------------------------------------------------
    # Objects at or below this size are passed inline / kept in the owner's
    # in-process store (reference: max_direct_call_object_size=100KiB).
    max_direct_call_object_size: int = 100 * 1024
    # Chunk size for node-to-node object transfer.
    object_chunk_size: int = 5 * 1024 * 1024
    # Default per-node shared-memory object store capacity.
    object_store_memory: int = 2 * 1024**3
    # Fraction of the store that pull bundles may pin at once
    # (reference: PullManager admission control).
    pull_manager_admission_fraction: float = 0.8
    # raycheck: disable=RC14 — reference-compat (get_timeout_milliseconds); waits are cv-driven
    object_timeout_ms: int = 100
    # Same-host zero-copy reads: a task argument held by a colocated
    # raylet is pinned and read in place (plasma one-store-per-host)
    # instead of copied into a local replica.
    same_host_zero_copy_reads: bool = True
    # Automatic spill threshold (fraction full) and spill directory.
    object_spilling_threshold: float = 0.8
    spill_directory: str = ""
    # Max retries when the store is full before erroring a create
    # (reference: create_request_queue.cc backpressure).
    # raycheck: disable=RC14 — reference-compat; the store spills instead of retrying puts
    object_store_full_max_retries: int = 5

    # ---- actors ----------------------------------------------------------
    # raycheck: disable=RC14 — reference-compat; restarts governed by max_restarts alone
    actor_creation_min_retries: int = 0
    # raycheck: disable=RC14 — reference-compat (actor backpressure); unbounded in this tier
    max_pending_calls_default: int = -1
    # raycheck: disable=RC14 — reference-compat; restart path retries immediately by design
    actor_restart_backoff_ms: int = 0

    # ---- worker pool & batched actor lifecycle ---------------------------
    # Master switch for the warm-worker-pool actor fast path: each
    # raylet pre-forks idle worker processes and LEASES one on
    # create_actor instead of forking (reference: worker_pool.cc
    # prestart + num_initial_python_workers), the client coalesces
    # concurrent creates/kills into actor_create_batch /
    # actor_kill_batch GCS frames, and the GCS fans a batch's
    # placement out across raylets in parallel. Off restores the
    # pre-pool behavior end to end: one fresh fork + one serial GCS
    # RPC per actor create and kill (the configuration SCALE_r05
    # measured at 1.6 actors/s).
    worker_pool_enabled: bool = True
    # Idle warm workers each raylet keeps pre-forked. A background
    # replenisher refills the pool after every lease; an empty pool
    # falls back to a cold fork (counted as a warm miss).
    worker_pool_warm_size: int = 4
    # Modules a warm worker imports at boot, before it is ever leased,
    # so lease-time specialization is just unpickling the class and
    # running __init__ (comma-separated; import failures are ignored).
    worker_pool_preimport: str = "numpy,cloudpickle"
    # Max creates/kills coalesced into one batch frame by the
    # client-side submit coalescer and accepted per batch RPC.
    actor_batch_max: int = 512
    # How long the coalescing drainer lingers (seconds) for concurrent
    # submitters to pile onto the frame before flushing. 0 flushes
    # immediately with whatever queued while the previous flush ran.
    actor_batch_linger_s: float = 0.002
    # Threads the GCS uses to fan one batch's placement (create) and
    # kill RPCs out across raylets concurrently.
    actor_batch_fanout: int = 16

    # ---- dispatch fast lane ----------------------------------------------
    # Master switch for the submit→exec fast lane (reference:
    # CoreWorkerDirectTaskSubmitter / task-by-value inlining). On, the
    # hot loop runs through (a) preserialized task-spec templates —
    # options, resources, scheduling class, and the wire-frame skeleton
    # frozen at @remote decoration time so each call only re-encodes
    # args and IDs; (b) batched submit/ack/dispatch frames — driver
    # submits coalesce into submit_task_batch wire frames
    # (leader/follower with a short linger) and the raylet ships N task
    # frames per worker pipe write; (c) bulk per-class dispatch — one
    # resource-request decode and one allocation per dispatch-queue
    # class instead of one per task. Off restores the exact pre-lane
    # paths end to end (same placements for the same seed).
    dispatch_fastlane_enabled: bool = True
    # Max task specs coalesced into one submit_task_batch frame (and
    # one raylet→worker pipe write).
    dispatch_batch_max: int = 512
    # How long the driver-side submit coalescer lingers (seconds) for
    # concurrent submitters to pile onto a frame before flushing. 0
    # flushes immediately with whatever queued while the previous
    # flush ran.
    dispatch_batch_linger_s: float = 0.0005
    # Args whose serialized form is at or under this size ride the spec
    # frame inline (no ObjectRef round trip); larger args are stored
    # once and passed by reference over the shm fast path. <=0 falls
    # back to max_direct_call_object_size.
    dispatch_inline_arg_max: int = 64 * 1024

    # ---- data plane pipeline ---------------------------------------------
    # Master switch for the pipelined object data plane (reference:
    # ObjectManager chunked push + receive/forward overlap). On, (a)
    # broadcast plans a chunk TREE instead of driver-coordinated
    # store-and-forward rounds — an interior node starts forwarding
    # chunk k downstream as soon as it is received and verified
    # (cut-through), so tree depth costs latency per chunk, not per
    # object; (b) streamed chunks ride raw wire frames straight into
    # the receiver's preallocated shm segment (one copy: socket →
    # final offset) with the crc32c fused into that landing pass; (c)
    # a same-host offer ADOPTS the sender's sealed segment (maps it,
    # plasma one-store-per-host posture) instead of copying it. Off
    # restores the exact pre-pipeline paths end to end — whole-object
    # store-and-forward rounds, pickled chunk frames, copy-based shm
    # offers — pinned by the data_plane parity tests.
    data_plane_pipeline_enabled: bool = True
    # Chunk size for the pipelined stream path. Small enough that a
    # landed chunk is still cache-hot when the fused crc and the
    # cut-through forward read it back; large enough to amortize the
    # per-frame header + ack. <=0 falls back to object_chunk_size.
    data_plane_chunk_bytes: int = 1024 * 1024
    # In-flight (unacked) chunk frames per transfer leg — the window
    # that keeps the pipe full across the ack RTT. Also bounds how far
    # an interior node's forward leg may lag its receive leg.
    data_plane_window: int = 8
    # Broadcast tree topology: "binomial" (lg N depth, classic
    # bandwidth-optimal for whole objects, still good pipelined),
    # "chain" (depth N, maximal per-link overlap for huge payloads on
    # few nodes), "flat" (depth 1, source fans out to every target —
    # right answer when targets adopt same-host segments or fan-out is
    # small), or "auto" (flat for same-host/small fan-out, binomial
    # otherwise).
    data_plane_topology: str = "auto"
    # Testing/bench: force the streamed chunk path even where the
    # same-host shm adopt/copy fast path would win, so the chunk-tree
    # machinery is exercisable on one box.
    data_plane_stream_only: bool = False
    # A half-assembled inbound stream with no progress for this long is
    # torn down (its preallocated segment released and the teardown
    # counted) — the sender died mid-stream; the driver's re-pull
    # fallback converges the subtree. The legacy 120 s begin-time
    # reclaim stays as the backstop.
    data_plane_inbound_stale_s: float = 30.0

    # ---- fast-lane fault hardening ---------------------------------------
    # Per-lane degraded mode: after `threshold` consecutive lane-specific
    # failures (a batch frame that errored, a chunk-tree push that had to
    # fail over, a fenced-and-retried tick), the lane's breaker opens and
    # reads of its master switch report OFF — traffic falls back to the
    # safe pre-lane path — until a half-open probe after `reset_s`
    # succeeds. Transitions are counted (fastlane_breaker_transitions).
    # Reuses the overload plane's CircuitBreaker; threshold 0 disables.
    fastlane_breaker_enabled: bool = True
    fastlane_breaker_threshold: int = 5
    fastlane_breaker_reset_s: float = 2.0
    # Chunk-tree failover: when a relay node dies or stalls mid-broadcast,
    # its parent re-offers the dead child's subtree from its own sealed
    # replica (begin_receive supersede + CRC make the splice seamless)
    # instead of abandoning those targets to the driver's re-pull
    # fallback. Off restores the PR 13 behavior (subtree converges only
    # through the driver's confirm/re-pull rounds).
    chunk_tree_failover_enabled: bool = True
    # Pipelined-tick epoch fencing: the double-buffered device solve
    # captures the cluster topology epoch at launch; if a node died (or
    # was marked dead) before the solve commits, the in-flight device
    # batch is discarded and re-solved against the repaired matrix so the
    # scheduler never commits placements onto a dead node. Off restores
    # the PR 10 commit path unchanged.
    tick_epoch_fencing: bool = True

    # ---- node drain / preemption plane -----------------------------------
    # Master switch for graceful node drain + preemption handling
    # (reference: DrainNode RPC in gcs_service.proto + the autoscaler
    # monitor's drain-before-terminate path). On, `drain_node` moves the
    # node to DRAINING — placement solves exclude it, its actors are
    # killed-then-restarted elsewhere via the restart path, sole-copy
    # objects are re-replicated off-node over the chunk-tree data plane
    # before deregistration, and a raylet-reported preemption notice
    # triggers the same drain inside the notice window. Off restores
    # the pre-plane behavior bit-for-bit: drain_node == immediate
    # hard-kill recovery (mark dead, restart actors, locations dropped),
    # pinned by the drain parity test.
    drain_plane_enabled: bool = True
    # Wall-clock budget for one graceful drain (actor migration +
    # sole-copy re-replication). Past it the drain falls back to the
    # hard-kill recovery path so a wedged drain never strands the
    # cluster. Keep below ProcessCluster.remove_node's 15 s RPC timeout.
    drain_deadline_s: float = 10.0
    # Default preemption-notice lead time (seconds between the notice
    # landing on the raylet and the simulated eviction) used by the
    # fault plane's `preempt_node` storm kind and the preemption bench.
    preempt_notice_s: float = 2.0
    # Join budget for the bounded worker fleets behind one batch RPC
    # (GCS drain fan-out, raylet kill_actor_batch). Generous — each
    # worker's RPCs carry their own timeouts, so this only catches a
    # wedged worker — but bounded, so a hung peer can never wedge the
    # handler thread forever (raycheck RC17).
    batch_fanout_join_timeout_s: float = 120.0
    # Periodic wake for the per-actor executor's idle wait. The loop
    # re-checks dead/runnable on every wake, so this is a liveness
    # backstop against a lost notify, not a poll interval hot path.
    actor_executor_wake_s: float = 1.0
    # ---- autoscaler loop --------------------------------------------------
    # A worker with no task/actor/object activity for this long is a
    # scale-down candidate; the monitor drains it gracefully instead of
    # killing it (reference: idle_timeout_minutes, default 5 min —
    # shortened here to match process-tier test/bench timescales).
    autoscaler_idle_timeout_s: float = 30.0
    # Pending demand (queued tasks + pending placements + overload shed
    # deltas, from load_metrics) at or above this count makes the
    # monitor request scale-up even when per-node resources look free.
    autoscaler_demand_threshold: int = 1
    # Monitor loop period.
    autoscaler_update_interval_s: float = 1.0

    # ---- lineage / GC ----------------------------------------------------
    max_lineage_bytes: int = 1024**3
    # bound on cached task specs for reconstruction (LRU beyond this)
    max_lineage_entries: int = 10_000
    enable_object_reconstruction: bool = True

    # ---- GCS -------------------------------------------------------------
    # raycheck: disable=RC14 — reference-compat; resources push on heartbeat, no pull loop
    gcs_pull_resource_period_ms: int = 100
    # raycheck: disable=RC14 — selected via storage URI at gcs startup, not read from Config
    gcs_storage_backend: str = "memory"  # "memory" | "file"

    # ---- observability ---------------------------------------------------
    # raycheck: disable=RC14 — reference-compat (RAY_event_stats); stats plane is always-on here
    event_stats: bool = True
    # raycheck: disable=RC14 — reference-compat; metrics serve on scrape, no push reporter
    metrics_report_interval_ms: int = 1000
    enable_timeline: bool = True
    # Master switch for the performance observability plane: wire-level
    # `_trace` propagation on every RPC frame, per-handler spans split
    # into queue-wait vs handler time, per-method latency/size
    # histograms, scheduler tick phase anatomy, and the per-process
    # flight recorder + `cli.py timeline` merged chrome trace. Off
    # restores the pre-plane behavior: spans stop at process boundaries
    # and a slow ray.get cannot be attributed to submit vs lease vs
    # exec vs pull (reference: python/ray/util/tracing + `ray
    # timeline`).
    observability_plane_enabled: bool = True
    # Head-based trace sampling probability: the decision is made once
    # at the trace root (seeded, RC03-replayable) and rides the wire
    # with the context, so a trace is recorded everywhere or nowhere.
    # Tracing itself is opt-in (tracing.setup_tracing), so the default
    # samples every trace the app asks for; dial down for always-on
    # tracing of high-throughput drivers. The plane's cost is bounded
    # either way: bench.py tracing_overhead_pct holds the scheduler and
    # submit-micro rows to <= 2%.
    tracing_sample_rate: float = 1.0
    # Per-process flight-recorder ring capacity (recent spans + events
    # kept for the crash/SIGUSR2 JSONL dump and `cli.py timeline`).
    flight_recorder_capacity: int = 4096

    # ---- collectives -----------------------------------------------------
    # Store-backend collective ops raise after this long waiting for
    # peers (reference analog: NCCL_TIMEOUT; keeps a dead rank from
    # leaving the others polling forever — the failure mode behind the
    # r05 dryrun hang). Generous: a healthy straggler may be JIT-
    # compiling its first step for minutes on a loaded host.
    collective_op_timeout_s: float = 600.0

    # ---- misc ------------------------------------------------------------
    # raycheck: disable=RC14 — reference-compat; 0 (off) until the memory monitor is ported
    memory_monitor_interval_ms: int = 0

    _instance = None
    _lock = threading.Lock()

    @classmethod
    def instance(cls) -> "Config":
        if cls._instance is None:
            with cls._lock:
                if cls._instance is None:
                    cls._instance = cls._from_env()
        return cls._instance

    @classmethod
    def _from_env(cls) -> "Config":
        cfg = cls()
        for f in fields(cls):
            if f.name.startswith("_"):
                continue
            env = os.environ.get(f"RAY_TPU_{f.name}")
            if env is not None:
                cfg._set(f.name, env)
        return cfg

    def _set(self, name: str, value):
        current = getattr(self, name)
        if isinstance(current, bool):
            if isinstance(value, str):
                value = value.lower() in ("1", "true", "yes")
            else:
                value = bool(value)
        elif isinstance(current, int):
            value = int(value)
        elif isinstance(current, float):
            value = float(value)
        setattr(self, name, value)

    def apply_system_config(self, system_config: dict | str | None):
        if not system_config:
            return
        if isinstance(system_config, str):
            system_config = json.loads(system_config)
        for name, value in system_config.items():
            if not hasattr(self, name):
                raise ValueError(f"unknown system config entry: {name!r}")
            self._set(name, value)

    def to_dict(self) -> dict:
        return {
            f.name: getattr(self, f.name)
            for f in fields(self)
            if not f.name.startswith("_")
        }

    @classmethod
    def reset(cls):
        with cls._lock:
            cls._instance = None
