"""Metric registry: Counter/Gauge/Histogram + Prometheus text exporter.

Reference: src/ray/stats/metric.h:101 (C++ registry over OpenCensus,
definitions in metric_defs.cc) exported through the per-node
MetricsAgent (python/ray/_private/metrics_agent.py:65) to Prometheus
(:79). Here the registry is process-global and the exporter renders the
Prometheus text format directly; serve it with `start_metrics_server`.
"""

from __future__ import annotations

import bisect
import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple

_registry_lock = threading.Lock()
_registry: Dict[str, "Metric"] = {}

DEFAULT_BUCKETS = (0.001, 0.005, 0.01, 0.05, 0.1, 0.5, 1, 5, 10, 60)


class Metric:
    TYPE = "untyped"

    def __init__(self, name: str, description: str = "",
                 tag_keys: Sequence[str] = ()):
        self.name = name
        self.description = description
        self.tag_keys = tuple(tag_keys)
        self._nil_key = tuple("" for _ in self.tag_keys)
        self._lock = threading.Lock()
        self._series: Dict[Tuple[str, ...], float] = {}
        with _registry_lock:
            existing = _registry.get(name)
            if existing is not None:
                # re-registration returns the same series storage
                self._series = existing._series
                self._lock = existing._lock
            _registry[name] = self

    def _key(self, tags: Optional[Dict[str, str]]) -> Tuple[str, ...]:
        if not tags:  # hot path: untagged series
            return self._nil_key
        return tuple(str(tags.get(k, "")) for k in self.tag_keys)

    def series(self) -> Dict[Tuple[str, ...], float]:
        with self._lock:
            return dict(self._series)


class Counter(Metric):
    TYPE = "counter"

    def inc(self, value: float = 1.0,
            tags: Optional[Dict[str, str]] = None) -> None:
        key = self._key(tags)
        with self._lock:
            self._series[key] = self._series.get(key, 0.0) + value


class Gauge(Metric):
    TYPE = "gauge"

    def set(self, value: float,
            tags: Optional[Dict[str, str]] = None) -> None:
        with self._lock:
            self._series[self._key(tags)] = float(value)

    def record(self, value: float,
               tags: Optional[Dict[str, str]] = None) -> None:
        self.set(value, tags)


class Histogram(Metric):
    TYPE = "histogram"

    def __init__(self, name: str, description: str = "",
                 boundaries: Sequence[float] = DEFAULT_BUCKETS,
                 tag_keys: Sequence[str] = ()):
        super().__init__(name, description, tag_keys)
        self.boundaries = tuple(sorted(boundaries))
        self._buckets: Dict[Tuple[str, ...], List[int]] = {}
        self._sum: Dict[Tuple[str, ...], float] = {}
        self._count: Dict[Tuple[str, ...], int] = {}

    def observe(self, value: float,
                tags: Optional[Dict[str, str]] = None) -> None:
        key = self._key(tags)
        idx = bisect.bisect_left(self.boundaries, value)
        with self._lock:
            if key not in self._buckets:
                self._buckets[key] = [0] * (len(self.boundaries) + 1)
            self._buckets[key][idx] += 1
            self._sum[key] = self._sum.get(key, 0.0) + value
            self._count[key] = self._count.get(key, 0) + 1

    record = observe

    def sum_value(self, tags: Optional[Dict[str, str]] = None) -> float:
        """Sum of all observed values for one tag series."""
        with self._lock:
            return self._sum.get(self._key(tags), 0.0)

    def count_value(self, tags: Optional[Dict[str, str]] = None) -> int:
        """Number of observations for one tag series."""
        with self._lock:
            return self._count.get(self._key(tags), 0)

    def percentile(self, q: float,
                   tags: Optional[Dict[str, str]] = None) -> Optional[float]:
        """Bucket-bound quantile estimate.

        Returns the *upper bound* of the first bucket whose cumulative
        count reaches ``q`` percent of observations — not an
        interpolated sample value. Consequences callers must expect:

        - A single-sample series returns that sample's bucket upper
          bound for every q (even q=50), which can exceed the sample.
        - Values above the last boundary land in the overflow bucket,
          so the estimate is ``float("inf")`` — there is no finite
          upper bound to report.
        - An empty series returns ``None``.

        This is the standard Prometheus-histogram trade-off: accuracy
        is limited to bucket resolution (``cli.py status`` p99 readouts
        are bucket bounds, not exact order statistics).
        """
        key = self._key(tags)
        with self._lock:
            buckets = self._buckets.get(key)
            count = self._count.get(key, 0)
        if not buckets or not count:
            return None
        target = q / 100.0 * count
        seen = 0
        for i, c in enumerate(buckets):
            seen += c
            if seen >= target:
                return (self.boundaries[i] if i < len(self.boundaries)
                        else float("inf"))
        return float("inf")


def get_metric(name: str) -> Optional[Metric]:
    with _registry_lock:
        return _registry.get(name)


def clear_registry() -> None:
    with _registry_lock:
        _registry.clear()


def _escape_tag_value(value: str) -> str:
    """Escape a tag value per the Prometheus text exposition format:
    backslash, double-quote, and line-feed must be escaped or a value
    containing them corrupts the whole scrape."""
    return (str(value).replace("\\", "\\\\").replace('"', '\\"')
            .replace("\n", "\\n"))


def _fmt_le(bound: float) -> str:
    """Render a histogram ``le`` bound per the exposition spec: a float
    literal ("0.005", "1.0") or "+Inf" — never Python repr of an int."""
    if bound == float("inf"):
        return "+Inf"
    return repr(float(bound))


def _fmt_tags(keys: Sequence[str], values: Tuple[str, ...]) -> str:
    if not keys:
        return ""
    pairs = ",".join(f'{k}="{_escape_tag_value(v)}"'
                     for k, v in zip(keys, values))
    return "{" + pairs + "}"


def prometheus_text() -> str:
    """Render every registered metric in Prometheus exposition format."""
    with _registry_lock:
        metrics = list(_registry.values())
    lines: List[str] = []
    for m in metrics:
        lines.append(f"# HELP {m.name} {m.description}")
        lines.append(f"# TYPE {m.name} {m.TYPE}")
        if isinstance(m, Histogram):
            with m._lock:
                for key, buckets in m._buckets.items():
                    cum = 0
                    for b, c in zip(m.boundaries, buckets):
                        cum += c
                        tags = dict(zip(m.tag_keys, key))
                        tags["le"] = _fmt_le(b)
                        tag_str = ",".join(
                            f'{k}="{_escape_tag_value(v)}"'
                            if k != "le" else f'{k}="{v}"'
                            for k, v in tags.items())
                        lines.append(
                            f"{m.name}_bucket{{{tag_str}}} {cum}")
                    tags = dict(zip(m.tag_keys, key))
                    tags["le"] = "+Inf"
                    tag_str = ",".join(
                        f'{k}="{_escape_tag_value(v)}"'
                        if k != "le" else f'{k}="{v}"'
                        for k, v in tags.items())
                    lines.append(
                        f"{m.name}_bucket{{{tag_str}}} "
                        f"{m._count.get(key, 0)}")
                    base = _fmt_tags(m.tag_keys, key)
                    lines.append(
                        f"{m.name}_sum{base} {m._sum.get(key, 0.0)}")
                    lines.append(
                        f"{m.name}_count{base} {m._count.get(key, 0)}")
        else:
            for key, value in m.series().items():
                lines.append(
                    f"{m.name}{_fmt_tags(m.tag_keys, key)} {value}")
    return "\n".join(lines) + "\n"


def start_metrics_server(host: str = "127.0.0.1", port: int = 0):
    """Serve /metrics like the reference's per-node agent exporter."""
    import threading as _threading
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):
            pass

        def do_GET(self):
            if self.path.rstrip("/") in ("", "/metrics"):
                body = prometheus_text().encode()
                self.send_response(200)
                self.send_header("Content-Type",
                                 "text/plain; version=0.0.4")
                self.end_headers()
                self.wfile.write(body)
            else:
                self.send_response(404)
                self.end_headers()

    server = ThreadingHTTPServer((host, port), Handler)
    thread = _threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    return server, server.server_address[1]


# ----------------------------------------------------- core named metrics
# (reference: src/ray/stats/metric_defs.cc — the system-level series)
tasks_submitted = Counter("ray_tpu_tasks_submitted",
                          "Tasks submitted to the scheduler")
tasks_finished = Counter("ray_tpu_tasks_finished", "Tasks finished")
scheduler_ticks = Counter("ray_tpu_scheduler_ticks",
                          "Batched scheduling ticks")
scheduling_latency = Histogram(
    "ray_tpu_scheduling_latency_s",
    "Submit-to-dispatch latency",
    boundaries=(1e-4, 5e-4, 1e-3, 5e-3, 1e-2, 5e-2, 0.1, 0.5, 1.0))
object_store_bytes = Gauge("ray_tpu_object_store_bytes",
                           "Bytes resident in the object store")
actors_alive = Gauge("ray_tpu_actors_alive", "Alive actors")

# ---- overload plane (cluster/overload.py + rpc.py admission control) ----
rpc_requests_shed = Counter(
    "ray_tpu_rpc_requests_shed",
    "RPC requests shed by server admission control "
    "(reason: queue_full | queue_deadline)",
    tag_keys=("reason",))
rpc_dispatch_queue_depth = Gauge(
    "ray_tpu_rpc_dispatch_queue_depth",
    "Requests waiting in the bounded RPC dispatch queue")
rpc_replies_dropped = Counter(
    "ray_tpu_rpc_replies_dropped",
    "Replies dropped because the client disconnected first")
rpc_retries_spent = Counter(
    "ray_tpu_rpc_retries_spent",
    "Client retries admitted by the per-destination retry budget")
rpc_retry_budget_exhausted = Counter(
    "ray_tpu_rpc_retry_budget_exhausted",
    "Client retries refused because the retry budget was empty")
rpc_breaker_transitions = Counter(
    "ray_tpu_rpc_breaker_transitions",
    "Circuit breaker state transitions", tag_keys=("to",))
tasks_shed = Counter(
    "ray_tpu_tasks_shed",
    "Task submissions pushed back by the bounded raylet queue")

# ---- fast-lane fault hardening (cluster/overload.py lane breakers) ------
fastlane_breaker_transitions = Counter(
    "ray_tpu_fastlane_breaker_transitions",
    "Per-lane degraded-mode breaker transitions: a lane flipping to "
    "its safe path (to=open) or probing back (to=closed)",
    tag_keys=("lane", "to"))
batch_rows_deduped = Counter(
    "ray_tpu_batch_rows_deduped",
    "Batch-frame rows answered from the per-row dedupe cache instead "
    "of re-applied (a retried frame after a lost ack or GCS restart)",
    tag_keys=("method",))
chunk_tree_failovers = Counter(
    "ray_tpu_chunk_tree_failovers",
    "Broadcast subtrees re-rooted around a dead or stalled relay node "
    "(parent re-offered the subtree from its sealed replica)")
tick_epoch_fences = Counter(
    "ray_tpu_tick_epoch_fences",
    "In-flight pipelined device solve batches discarded because the "
    "cluster topology epoch moved between launch and commit")
warm_specialize_crash_fallbacks = Counter(
    "ray_tpu_warm_specialize_crash_fallbacks",
    "Warm-lease actor creations whose leased worker died mid-"
    "specialization and were transparently retried as a cold fork")

# ---- serve resilience plane (serve/{controller,handle,replica}.py) ------
serve_replicas_unhealthy = Counter(
    "ray_tpu_serve_replicas_unhealthy",
    "Replicas that failed the controller's health probe "
    "health_check_failure_threshold consecutive times and were "
    "drained from routing and replaced")
serve_drains_completed = Counter(
    "ray_tpu_serve_drains_completed",
    "Graceful replica drains that reached zero in-flight requests "
    "before the graceful_shutdown_timeout_s kill")
serve_router_excluded = Counter(
    "ray_tpu_serve_router_excluded",
    "Replica candidates the serve router excluded from an assignment "
    "(reason: breaker_open | shed_penalty | saturated)",
    tag_keys=("reason",))
serve_requests_backpressured = Counter(
    "ray_tpu_serve_requests_backpressured",
    "Requests refused with BackpressureError because every replica "
    "was shedding, breaker-open, or saturated")

# ---- worker pool & actor lifecycle (cluster/process_pool.py + GCS) ------
worker_pool_warm_hits = Counter(
    "ray_tpu_worker_pool_warm_hits",
    "Actor creations served by leasing a pre-forked warm worker")
worker_pool_warm_misses = Counter(
    "ray_tpu_worker_pool_warm_misses",
    "Actor creations that cold-forked a fresh worker process "
    "(pool empty, stale lease, or warm pool disabled)")
worker_pool_size = Gauge(
    "ray_tpu_worker_pool_size",
    "Idle warm workers currently pre-forked in this node's pool")
actor_creates_batched = Counter(
    "ray_tpu_actor_creates_batched",
    "Actor creations that arrived coalesced in actor_create_batch "
    "frames (GCS-side)")
actor_kills_batched = Counter(
    "ray_tpu_actor_kills_batched",
    "Actor kills that arrived coalesced in actor_kill_batch frames "
    "(GCS-side)")
actor_create_latency_ms = Histogram(
    "ray_tpu_actor_create_latency_ms",
    "Raylet-side actor creation latency: lease/fork + class unpickle "
    "+ __init__, in milliseconds",
    boundaries=(1, 5, 10, 25, 50, 100, 250, 500, 1000, 2500, 5000,
                15000, 60000))

# ---- integrity plane (cluster/integrity.py checksum seams) --------------
objects_corruption_detected = Counter(
    "ray_tpu_objects_corruption_detected",
    "Object payloads that failed checksum verification at a "
    "data-movement seam (push_end | push_chunk | pull_stream | "
    "shm_read | spill_restore | adopt_shm | orphan_reclaim | get)",
    tag_keys=("seam",))
corrupt_replicas_discarded = Counter(
    "ray_tpu_corrupt_replicas_discarded",
    "Corrupt object replicas discarded by the detecting holder "
    "(recovery re-pulls from another holder or reconstructs)")
integrity_bytes_verified = Counter(
    "ray_tpu_integrity_bytes_verified",
    "Payload bytes that passed checksum verification at a seam")

# ---- node drain / preemption plane (cluster/gcs_server.py drains) -------
nodes_draining = Gauge(
    "ray_tpu_nodes_draining",
    "Nodes currently in the DRAINING lifecycle state (graceful drain "
    "in progress: placements steered away, actors migrating, "
    "sole-copy objects re-replicating off-node)")
drains_completed = Counter(
    "ray_tpu_drains_completed",
    "Graceful node drains finished (outcome: graceful — migration and "
    "re-replication completed inside drain_deadline_s — or deadline — "
    "the drain fell back to the hard-kill recovery path)",
    tag_keys=("outcome",))
preemption_notices = Counter(
    "ray_tpu_preemption_notices",
    "Preemption notices received (raylet-side delivery and GCS-side "
    "heartbeat reports each count once, tagged by role)",
    tag_keys=("role",))
objects_rereplicated = Counter(
    "ray_tpu_objects_rereplicated",
    "Sole-copy objects successfully re-replicated off a draining node "
    "before its deregistration")

# ---- performance observability plane (util/tracing.py + rpc.py) ---------
# dst_kind is the serving process's role (gcs | raylet | worker |
# driver, cluster/fault_plane.py process_role) so the same method name
# is attributable per tier.
rpc_server_latency_ms = Histogram(
    "ray_tpu_rpc_server_latency_ms",
    "Server-side RPC handler time (dispatch to reply-ready), ms",
    boundaries=(0.05, 0.1, 0.5, 1, 5, 10, 50, 100, 500, 1000, 5000),
    tag_keys=("method", "dst_kind"))
rpc_server_queue_ms = Histogram(
    "ray_tpu_rpc_server_queue_ms",
    "Time an RPC waited in the bounded dispatch queue before its "
    "handler ran, ms (inline fast-path methods observe 0)",
    boundaries=(0.05, 0.1, 0.5, 1, 5, 10, 50, 100, 500, 1000, 5000),
    tag_keys=("method", "dst_kind"))
rpc_request_bytes = Histogram(
    "ray_tpu_rpc_request_bytes",
    "Serialized request frame size per method, bytes",
    boundaries=(64, 256, 1024, 4096, 16384, 65536, 262144,
                1 << 20, 4 << 20, 32 << 20),
    tag_keys=("method", "dst_kind"))
scheduler_phase_ms = Histogram(
    "ray_tpu_scheduler_phase_ms",
    "Per-phase wall time inside one batched scheduling tick "
    "(phase: collect | refresh | solve | commit | spillback | "
    "dispatch), ms",
    boundaries=(0.01, 0.05, 0.1, 0.5, 1, 5, 10, 50, 100, 500, 1000),
    tag_keys=("phase",))
flight_recorder_dumps = Counter(
    "ray_tpu_flight_recorder_dumps",
    "Flight-recorder JSONL dumps written (reason: SIGUSR2 | "
    "uncaught | fatal_event | manual)",
    tag_keys=("reason",))
