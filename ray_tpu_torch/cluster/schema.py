"""Typed message schemas for the wire (reference: src/ray/protobuf/ —
20 .proto files give every cross-process message a schema; processes
reject what they cannot parse instead of guessing).

This build's wire bodies are pickled, so the schema layer is
dataclass-generated rather than IDL-compiled: each message type declares
its fields and types once, `validate()` checks an incoming kwargs dict
against them at dispatch — missing required fields and type mismatches
are rejected, unknown fields are dropped (proto3 posture), without
adding a codegen step to a pickle transport.

## Evolution rules (documented contract)

- **Adding an optional field (with a default) is backward-compatible in
  BOTH directions**: old senders omit it and `validate` fills the
  default; new senders include it and an old receiver DROPS the unknown
  field (proto3's unknown-field tolerance) — without the drop, a
  rolling upgrade inside one PROTOCOL_VERSION would wedge new->old
  calls. Dropped fields are counted in `validate.num_dropped` for
  observability.
- Removing a field, changing a field's type, or adding a REQUIRED field
  is breaking: bump `rpc.PROTOCOL_VERSION` so old peers are refused at
  the handshake instead of failing mid-call.

### Worked example (a real evolution in this repo)

`put_object` originally carried (object_id, payload, is_error,
register). The push/replica work added `primary: bool = True` — an
optional field with a default, so older senders that omit it
still validate and get the old semantics. Had `primary` been required,
the change would have needed a PROTOCOL_VERSION bump. The test suite
pins this example (tests/test_wire_protocol.py).
"""

from __future__ import annotations

from dataclasses import MISSING, dataclass, fields
from typing import Dict, Optional, Type


class SchemaError(TypeError):
    """An incoming message does not match its declared schema."""


_REGISTRY: Dict[str, Type] = {}


def message(method: str):
    """Class decorator registering a dataclass as METHOD's schema."""
    def wrap(cls):
        cls = dataclass(cls)
        _REGISTRY[method] = cls
        return cls
    return wrap


def schema_for(method: str) -> Optional[Type]:
    return _REGISTRY.get(method)


def validate(method: str, kwargs: dict) -> dict:
    """Check ``kwargs`` against METHOD's schema: unknown fields are
    DROPPED (proto3 unknown-field tolerance — a newer same-version peer
    may send optional fields this build predates), missing optional
    fields get their defaults, missing required fields and wrong types
    raise SchemaError. Methods without a registered schema pass through
    unchanged — a posture kept for test fixtures and plugins; every
    method the servers actually register declares a schema here, and
    raycheck RC07 fails the tree when one is missing."""
    cls = _REGISTRY.get(method)
    if cls is None:
        return kwargs
    declared = {f.name: f for f in fields(cls)}
    unknown = set(kwargs) - set(declared)
    out = {k: v for k, v in kwargs.items() if k in declared}
    if unknown:
        validate.num_dropped += len(unknown)
    for name, f in declared.items():
        if name not in out:
            if f.default is not MISSING:
                out[name] = f.default
            elif f.default_factory is not MISSING:  # type: ignore[misc]
                out[name] = f.default_factory()  # type: ignore[misc]
            else:
                raise SchemaError(f"{method}: missing required "
                                  f"field {name!r}")
            continue
        expected = _runtime_type(f.type)
        if expected is not None and out[name] is not None \
                and not isinstance(out[name], expected):
            raise SchemaError(
                f"{method}: field {name!r} expects "
                f"{f.type}, got {type(out[name]).__name__}")
    return out


validate.num_dropped = 0  # dropped unknown fields (rolling upgrades)


def _runtime_type(annotation):
    """Best-effort annotation -> isinstance() target. Returns None for
    annotations we can't check structurally (Any, unions, generics'
    parameters are not enforced beyond the origin type)."""
    mapping = {
        # any buffer type is wire-equivalent to bytes (dumps_flat
        # returns bytearray; chunked reads hand out memoryviews)
        "bytes": (bytes, bytearray, memoryview),
        "str": str, "bool": bool, "float": (int, float),
        "int": int, "dict": dict, "list": list, "tuple": tuple,
    }
    if isinstance(annotation, str):
        base = annotation.split("[")[0].strip()
        if base.startswith("Optional"):
            inner = annotation[annotation.index("[") + 1:-1]
            return _runtime_type(inner.split("[")[0].strip())
        if base in ("Dict", "dict"):
            return dict
        if base in ("List", "list"):
            return list
        return mapping.get(base)
    return None


# ----------------------------------------------------------------------
# Core data-plane message schemas (the highest-traffic, most
# version-sensitive messages; control-plane methods join incrementally).
# ----------------------------------------------------------------------

@message("put_object")
class PutObject:
    object_id: bytes
    payload: bytes
    is_error: bool = False
    register: bool = True
    # EVOLUTION EXAMPLE: added after v0 as optional-with-default (see
    # module docstring) — replica pushes mark copies non-primary
    primary: bool = True


@message("get_object_info")
class GetObjectInfo:
    object_id: bytes


@message("push_begin")
class PushBegin:
    object_id: bytes
    size: int
    is_error: bool = False
    # integrity plane: whole-object crc32 the receiver verifies at
    # assembly (optional-with-default per the evolution rules — an
    # integrity-disabled sender omits it and the receiver skips the
    # check)
    crc: "Optional[int]" = None
    # data-plane pipeline (optional-with-default, evolution rules): the
    # receiver's subtree of the broadcast chunk tree — a list of
    # [address, subtree] pairs it cut-through forwards each verified
    # chunk to. Pre-pipeline receivers drop the field and the tree
    # degrades to a direct push (driver re-pull covers the subtree).
    downstream: "Optional[list]" = None
    # Sender's chunk size for this transfer, so the receiver can size
    # coverage accounting and forward frames identically down the tree.
    chunk_bytes: "Optional[int]" = None
    # Chunk-tree failover (optional-with-default, evolution rules): set
    # by a re-rooted parent re-offering the stream after the receiver's
    # previous feeder died mid-tree. A receiver with
    # chunk_tree_failover_enabled supersedes its half-open inbound of
    # the same object instead of declining; pre-failover receivers drop
    # the field and keep the old decline-until-stale behavior.
    reroot: bool = False


@message("push_chunk")
class PushChunk:
    object_id: bytes
    chunk: bytes
    # integrity plane: per-chunk crc32 — wire corruption is caught at
    # chunk granularity, before the bad bytes enter the reassembly
    crc: "Optional[int]" = None


@message("push_end")
class PushEnd:
    object_id: bytes


@message("push_abort")
class PushAbort:
    object_id: bytes


@message("push_offer")
class PushOffer:
    object_id: bytes
    size: int
    is_error: bool = False
    shm_path: "Optional[str]" = None
    # integrity plane: crc of the offered payload — the same-host shm
    # fast path verifies the segment bytes it copies
    crc: "Optional[int]" = None
    # data-plane pipeline: the accepting node's subtree (see
    # PushBegin.downstream) — after adopting/copying the offered
    # segment it relays the object to these children.
    downstream: "Optional[list]" = None


@message("push_object")
class PushObject:
    object_id: bytes
    to_address: str
    # data-plane pipeline: subtree the destination should relay to
    # after receiving (see PushBegin.downstream).
    downstream: "Optional[list]" = None


# Handler is registered through RpcServer.register_data (raw-frame
# dispatch path), not the pickled-message registry the checker scans.
@message("push_chunk_data")  # raycheck: disable=RC06 — registered via register_data, not the pickled-message registry
class PushChunkData:
    # Header of the raw-data-frame chunk (wire v4): the chunk bytes
    # themselves travel out of band as the frame's unpickled payload,
    # landed by recv_into at OFFSET in the receiver's preallocated
    # segment. crc is the chunk digest, verified on the landed slice
    # while it is cache-hot — before any cut-through forward.
    object_id: bytes
    offset: int
    crc: "Optional[int]" = None


@message("pull_object")
class PullObject:
    # Ask a raylet to pull OBJECT_ID from the cluster (directory
    # lookup + holder fetch, deduped with any in-flight pull). The
    # flat broadcast topology and the driver's re-pull convergence
    # fallback both ride this; returns {"ok": bool} once the local
    # replica is sealed (or the pull failed).
    object_id: bytes
    # Optional hint: try this holder address first (the broadcast
    # planner knows who has it; skips a directory round trip).
    from_address: "Optional[str]" = None


@message("heartbeat")
class Heartbeat:
    node_id: str
    available: dict
    resources: dict
    # optional-with-default (schema evolution rules above): the node's
    # overload-plane counters — sheds, backpressure, breaker states
    overload: "Optional[dict]" = None
    # integrity-plane counters (corruption detections, discarded
    # replicas, bytes verified) — same evolution posture
    integrity: "Optional[dict]" = None
    # serve-resilience counters (unhealthy replicas, completed drains,
    # router exclusions, backpressured requests) — same evolution
    # posture: an old sender omits it, the GCS keeps {}
    serve: "Optional[dict]" = None
    # warm worker-pool counters (idle size, warm hits/misses, returns,
    # reaps, create-latency p50) — same evolution posture
    worker_pool: "Optional[dict]" = None
    # seconds left on a pending preemption notice this raylet received
    # (drain plane): the GCS starts a graceful drain inside the window.
    # Same evolution posture — an old sender omits it, no drain starts.
    preempt_notice_s: "Optional[float]" = None
    # live daemon-thread roots on the node ({thread name -> root
    # function label}, the ThreadRegistry's view) — `cli.py status`
    # shows them and raycheck RC16 names the same labels, so a report
    # maps straight to a running thread. Same evolution posture.
    threads: "Optional[dict]" = None


@message("object_add_location")
class ObjectAddLocation:
    object_id: bytes
    node_id: str
    size: int = 0


@message("object_add_locations")
class ObjectAddLocations:
    node_id: str
    entries: list


@message("object_remove_location")
class ObjectRemoveLocation:
    object_id: bytes
    node_id: str


@message("object_locations")
class ObjectLocations:
    object_id: bytes


@message("object_wait_location")
class ObjectWaitLocation:
    object_id: bytes
    timeout_s: float = 30.0


@message("get_object")
class GetObject:
    object_id: bytes


# ----------------------------------------------------------------------
# Control-plane schemas — every method registered by gcs_server.serve()
# and raylet_server.serve() declares its fields here; raycheck RC06/RC07
# joins these against the registrations and every call site, so a
# drifted kwarg or renamed method fails the tier-1 static gate instead
# of a runtime path a test may never exercise. Mutation methods carry
# the reserved optional ``token`` consumed by @token_deduped.
# ----------------------------------------------------------------------

# -- GCS: node table / failure detection


@message("register_node")
class RegisterNode:
    node_id: str
    address: str
    resources: dict


@message("drain_node")
class DrainNode:
    node_id: str
    # optional-with-default (schema evolution rules above): why the
    # drain was requested ("preempted" | "scale_down" | operator text)
    reason: str = ""
    # per-call override of Config.drain_deadline_s; None uses the knob
    deadline_s: "Optional[float]" = None
    # drain_node is a mutation (@token_deduped): a retried frame after
    # a lost ack must not double-run the migration fan-out
    token: str = ""


@message("cluster_view")
class ClusterView:
    pass


# -- GCS: internal KV


@message("kv_put")
class KvPut:
    ns: str
    key: bytes
    value: bytes


@message("kv_get")
class KvGet:
    ns: str
    key: bytes


@message("kv_del")
class KvDel:
    ns: str
    key: bytes


@message("kv_keys")
class KvKeys:
    ns: str
    prefix: bytes = b""


# -- GCS: actor management


@message("actor_create")
class ActorCreate:
    actor_id: str
    cls_bytes: bytes
    args_bytes: bytes
    resources: dict
    max_restarts: int = 0
    name: str = ""
    owner: str = ""
    token: str = ""


@message("actor_create_batch")
class ActorCreateBatch:
    # rows: {actor_id, cls_bytes, args_bytes, resources, max_restarts,
    # name, owner} — the client coalescer drains queued creates into
    # one frame; the reply carries one typed result row per actor
    # (state + error), so partial failure never loses a row. One token
    # dedupes the WHOLE batch.
    creates: list
    token: str = ""


@message("actor_kill_batch")
class ActorKillBatch:
    # rows: {actor_id, no_restart} — same coalescing contract as
    # actor_create_batch, kills fanned out per hosting node
    kills: list
    token: str = ""


@message("actor_get")
class ActorGet:
    actor_id: str


@message("actor_wait")
class ActorWait:
    # long-poll: blocks server-side until the actor leaves the
    # PENDING/RESTARTING limbo (reaches ALIVE with an address, or
    # DEAD) or timeout_s lapses — replaces the client's actor_get
    # hot-poll loop (wait_object-style blocking pattern)
    actor_id: str
    timeout_s: float = 30.0


@message("actor_by_name")
class ActorByName:
    name: str


@message("actor_kill")
class ActorKill:
    actor_id: str
    no_restart: bool = True
    token: str = ""


@message("actor_list")
class ActorList:
    pass


@message("report_actor_failure")
class ReportActorFailure:
    actor_id: str
    token: str = ""


# -- GCS: placement groups


@message("pg_create")
class PgCreate:
    pg_id: str
    bundles: list
    strategy: str = "PACK"
    token: str = ""


@message("pg_get")
class PgGet:
    pg_id: str


@message("pg_remove")
class PgRemove:
    pg_id: str
    token: str = ""


@message("pg_pending")
class PgPending:
    pass


# -- GCS: jobs / liveness


@message("job_view")
class JobView:
    pass


@message("ping")
class Ping:
    pass


# -- GCS: pubsub (long-poll channels)


@message("pubsub_subscribe")
class PubsubSubscribe:
    subscriber_id: str
    channel: str
    key: "Optional[str]" = None


@message("pubsub_unsubscribe")
class PubsubUnsubscribe:
    subscriber_id: str
    channel: "Optional[str]" = None
    key: "Optional[str]" = None


@message("pubsub_publish")
class PubsubPublish:
    channel: str
    key: str
    message: object


@message("pubsub_poll")
class PubsubPoll:
    subscriber_id: str
    timeout_s: float = 30.0


# -- raylet: task plane


@message("submit_task")
class SubmitTask:
    spec: dict


@message("submit_task_batch")
class SubmitTaskBatch:
    # specs: list of the same spec dicts submit_task carries, coalesced
    # by the client-side submit batcher (dispatch fast lane). The reply
    # carries one result row per spec — {accepted, reason?,
    # retry_after_s?} — so backpressure is PER ROW: one frame can
    # partially succeed, and only the shed rows retry at the hinted
    # pace (RetryLaterError semantics carried in-band instead of
    # failing the whole frame).
    specs: list


@message("task_state")
class TaskState:
    task_id: str


@message("wait_task")
class WaitTask:
    task_id: str
    timeout_s: float = 10.0


# -- raylet: object plane (unary surface; push_*/get_object above)


@message("wait_object")
class WaitObject:
    object_id: bytes
    timeout_s: float = 10.0


@message("free_objects")
class FreeObjects:
    object_ids: list


# -- raylet: actor execution


@message("create_actor")
class CreateActor:
    actor_id: str
    cls_bytes: bytes
    args_bytes: bytes
    resources: dict
    incarnation: int = 0


@message("actor_call")
class ActorCall:
    actor_id: str
    method_name: str
    args_bytes: bytes


@message("kill_actor")
class KillActor:
    actor_id: str


@message("kill_actor_batch")
class KillActorBatch:
    # ids of actors hosted on this node, one frame per node per
    # actor_kill_batch (GCS fan-out); reply carries per-actor rows
    actor_ids: list


# -- raylet: placement-group 2PC


@message("prepare_bundle")
class PrepareBundle:
    pg_id: str
    bundle_index: int
    bundle: dict


@message("commit_bundle")
class CommitBundle:
    pg_id: str
    bundle_index: int
    bundle: dict


@message("return_bundle")
class ReturnBundle:
    pg_id: str
    bundle_index: int
    bundle: dict
    committed: bool = False


# -- raylet: preemption notices (drain plane)


@message("preempt_notice")
class PreemptNotice:
    """Raylet: the infrastructure (or the fault plane's seeded
    `preempt_node` storm kind) announces this node will be evicted in
    ``notice_s`` seconds. The raylet records the deadline and reports
    the remaining window on its next heartbeat so the GCS can start a
    graceful drain inside it."""
    notice_s: float
    # optional provenance for logs/metrics ("storm" | "spot" | ...)
    reason: str = ""


# -- raylet: stats


@message("node_stats")
class NodeStats:
    pass


# -- observability plane: flight-recorder collection


@message("perf_dump")
class PerfDump:
    """Raylet: return this node's flight-recorder snapshot (recent
    spans/events, drop count, heartbeat-measured clock offset)."""
    pass


@message("collect_timeline")
class CollectTimeline:
    """GCS: fan perf_dump out to every alive raylet and return all
    snapshots plus the GCS's own, for `cli.py timeline`."""
    # per-node collection timeout; a dead/slow node is reported as an
    # error entry instead of stalling the merge
    per_node_timeout_s: float = 5.0
