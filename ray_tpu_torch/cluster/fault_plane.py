"""FaultPlane — deterministic, scenario-driven fault injection for the
framed-TCP RPC substrate (cluster/rpc.py).

The reference's fault-tolerance machinery (heartbeat death detection,
GCS client retry on failover, PG 2PC rollback, lineage reconstruction)
is only trustworthy under failure modes a SIGKILL cannot produce:
delayed frames, duplicated deliveries, truncated writes, half-open
connections, one-way partitions. This module injects exactly those at
the RPC seams, from a single integer seed, so any failing schedule
replays bit-for-bit (the FoundationDB simulation-testing / Jepsen-nemesis
posture, scoped to this repo's process tier).

## Activation

Per process, via the environment::

    RAY_TPU_FAULT_PLAN='{"seed": 7, "rules": [...]}'   # inline JSON
    RAY_TPU_FAULT_PLAN=/path/to/plan.json              # or a file

(also honored: the ``fault_plan`` Config flag / ``RAY_TPU_fault_plan``),
or programmatically with ``install_plane(FaultPlane(plan))`` for
in-process (driver-side) injection. ``ProcessCluster`` forwards
per-node/per-GCS plans into child environments (process_cluster.py).

## Plan format

``{"seed": <int>, "rules": [<rule>, ...]}`` where each rule is::

    {
      "src_role":  "*",         # fnmatch vs this process's role
                                # (gcs | raylet | driver | worker | *)
      "dst":       "*",         # fnmatch vs "host:port" of the peer
                                # (direction "spill": the store tier,
                                # "byte_store" | "memory_store")
      "method":    "*",         # fnmatch vs the RPC method name
                                # (direction "spill": the object hex)
      "direction": "request",   # request | reply | connect | handler
                                # | spill
      "action":    "drop",      # drop | partition | refuse | delay |
                                # duplicate | truncate | stall |
                                # corrupt
      "prob":      1.0,         # per-event firing probability (seeded)
      "after":     0,           # skip the first N matching events
      "count":     null,        # fire at most N times (null = forever)
      "delay_ms":  [lo, hi],    # seeded jitter range for "delay"
      "phase":     "connect",   # connect faults: connect | post-hello
      "start_s":   0.0,         # wall-clock window (plane birth = 0);
      "stop_s":    null         # healing partitions use stop_s
    }

Actions by direction:
  connect  — refuse (connection refused), drop (phase "post-hello":
             handshake completes, then the socket dies — a half-open
             peer), delay (slow accept).
  request  — drop/partition (frame silently lost: the caller times out,
             exactly like a one-way partition), delay (seeded jitter
             before the write), duplicate (the frame is written twice —
             the server executes the method twice, exercising handler
             idempotency), truncate (a prefix of the frame is written
             and the socket is cut mid-frame).
  reply    — same menu, applied to the server's reply frames (the other
             one-way partition: requests arrive, acks vanish).
  handler  — stall (seeded ``delay_ms`` jitter INSIDE the server's
             dispatch, after admission but before the handler body):
             the request occupies a bounded dispatch-pool slot for the
             stall's duration, so a stalled GCS/raylet builds a real
             admission queue and sheds — the deterministic overload
             scenario behind the retry-storm regression tests
             (tests/test_overload.py).
  request/reply also carry ``corrupt``: ONE seeded byte of the frame
             body is XOR-flipped (tail-biased, so on large chunk frames
             the flip lands in the payload bytes, not the pickle
             structure) — the silent-data-corruption scenario the
             integrity plane (cluster/integrity.py) detects at its
             checksum seams.
  spill    — corrupt (the only action for this direction): a seeded
             byte of the payload WRITTEN to a spill file is flipped
             after the header digest was computed, modeling at-rest
             corruption / a torn write; ``dst`` is the store tier
             ("byte_store" | "memory_store") and ``method`` the object
             id hex, so one object's flip replays per-stream.

## Determinism contract

Every probabilistic decision (prob draws, delay jitter) comes from a
per-(rule, dst, method) RNG seeded as blake2(seed, rule_index, dst,
method): a stream's Kth matching event always gets the same decision
regardless of how other streams interleave. ``after``/``count`` windows
count per stream, so they are deterministic in event space too.
``start_s``/``stop_s`` windows are wall-clock (needed for
partition-heals-after-T scenarios) and therefore only approximately
replayable — schedules that must replay exactly use event-count windows.
Reply-direction raw stream chunks (the "R" frames of ``get_object``
transfers) are not faulted; the control frames around them are.
Request-direction raw data frames (the data plane's ``push_chunk_data``)
ARE faulted — ``corrupt`` flips a seeded payload byte on a COPY of the
outgoing chunk (the sender's pinned shm source is never mutated), which
is how the chunk-level crc seam is exercised (tests/test_data_plane.py).

Failing scenarios print ``describe()`` — seed + plan — so the schedule
can be re-run verbatim (tests/test_fault_injection.py wires this into
its assert path).
"""

from __future__ import annotations

import hashlib
import json
import logging
import os
import random
import threading
import time
from collections import deque
from fnmatch import fnmatchcase
from typing import Any, Dict, List, Optional, Tuple

logger = logging.getLogger(__name__)

ACTIONS = ("drop", "partition", "refuse", "delay", "duplicate",
           "truncate", "stall", "corrupt")
DIRECTIONS = ("request", "reply", "connect", "handler", "spill")


class FaultRule:
    __slots__ = ("index", "src_role", "dst", "method", "direction",
                 "action", "prob", "after", "count", "delay_ms", "phase",
                 "start_s", "stop_s", "truncate_bytes")

    def __init__(self, index: int, spec: Dict[str, Any]):
        self.index = index
        self.src_role = spec.get("src_role", "*")
        self.dst = spec.get("dst", "*")
        self.method = spec.get("method", "*")
        self.direction = spec.get("direction", "request")
        self.action = spec["action"]
        self.prob = float(spec.get("prob", 1.0))
        self.after = int(spec.get("after", 0))
        self.count = spec.get("count")
        self.delay_ms = spec.get("delay_ms", [0, 0])
        self.phase = spec.get("phase", "connect")
        self.start_s = float(spec.get("start_s", 0.0))
        self.stop_s = spec.get("stop_s")
        # how much of the frame still reaches the wire before the cut;
        # None = half the frame (header always lands, so the peer's
        # reader is mid-frame when the connection dies)
        self.truncate_bytes = spec.get("truncate_bytes")
        if self.action not in ACTIONS:
            raise ValueError(f"unknown fault action {self.action!r}")
        if self.direction not in DIRECTIONS:
            raise ValueError(
                f"unknown fault direction {self.direction!r}")
        if (self.action == "stall") != (self.direction == "handler"):
            raise ValueError(
                "stall faults pair with direction 'handler' (and "
                "'handler' only carries stalls): the slowdown happens "
                "inside the server's dispatch, not on the wire")
        if self.direction == "spill" and self.action != "corrupt":
            raise ValueError(
                "direction 'spill' only carries 'corrupt': spill files "
                "are written locally — there is nothing to drop or "
                "delay on a wire")
        if self.action == "corrupt" and self.direction not in (
                "request", "reply", "spill"):
            raise ValueError(
                "corrupt faults flip payload bytes: pair with "
                "direction 'request', 'reply', or 'spill'")

    def matches(self, role: str, dst: str, method: str) -> bool:
        return (fnmatchcase(role, self.src_role)
                and fnmatchcase(dst, self.dst)
                and fnmatchcase(method, self.method))


class _Stream:
    """Per-(rule, dst, method) decision stream: its own RNG + counters,
    so one stream's schedule is independent of every other stream's
    interleaving."""

    __slots__ = ("rng", "seen", "fired")

    def __init__(self, seed: int):
        self.rng = random.Random(seed)
        self.seen = 0
        self.fired = 0


def _stream_seed(seed: int, rule_index: int, dst: str,
                 method: str) -> int:
    h = hashlib.blake2b(
        f"{seed}|{rule_index}|{dst}|{method}".encode(), digest_size=8)
    return int.from_bytes(h.digest(), "big")


class FaultPlane:
    """One process's active fault schedule. Thread-safe; all decisions
    funnel through :meth:`decide` under one lock (RPC-frame granularity
    — the injection cost is dwarfed by the frame's own pickling)."""

    def __init__(self, plan: Dict[str, Any]):
        self.seed = int(plan.get("seed", 0))
        self.plan = plan
        self.rules: List[FaultRule] = [
            FaultRule(i, spec)
            for i, spec in enumerate(plan.get("rules", []))]
        self._streams: Dict[Tuple[int, str, str], _Stream] = {}
        self._lock = threading.Lock()
        self._birth = time.monotonic()
        # fired-event journal: (rule_index, direction, dst, method,
        # event_index_in_stream, action, param) — the replay fingerprint
        self.events: deque = deque(maxlen=10_000)

    # ------------------------------------------------------------ decisions
    def decide(self, direction: str, dst: str,
               method: str = "") -> Optional[Dict[str, Any]]:
        """First firing rule wins; None = no fault. The returned dict is
        ``{"action": ..., "rule": idx}`` plus action params
        (``seconds`` for delay, ``phase`` for connect faults,
        ``truncate_bytes`` for truncate)."""
        role = process_role()
        now = time.monotonic() - self._birth
        with self._lock:
            for rule in self.rules:
                if rule.direction != direction:
                    continue
                if not rule.matches(role, dst, method):
                    continue
                if now < rule.start_s:
                    continue
                if rule.stop_s is not None and now >= rule.stop_s:
                    continue
                key = (rule.index, dst, method)
                stream = self._streams.get(key)
                if stream is None:
                    stream = _Stream(
                        _stream_seed(self.seed, rule.index, dst, method))
                    self._streams[key] = stream
                stream.seen += 1
                if stream.seen <= rule.after:
                    continue
                if rule.count is not None and stream.fired >= rule.count:
                    continue
                if stream.rng.random() > rule.prob:
                    continue
                stream.fired += 1
                out: Dict[str, Any] = {"action": rule.action,
                                       "rule": rule.index}
                param: Any = None
                if rule.action in ("delay", "stall"):
                    lo, hi = rule.delay_ms
                    param = (lo + stream.rng.random() * (hi - lo)) / 1000.0
                    out["seconds"] = param
                elif rule.action == "truncate":
                    param = rule.truncate_bytes
                    out["truncate_bytes"] = param
                elif rule.action == "corrupt":
                    # seeded flip: position fraction + a nonzero XOR
                    # mask, both per-stream deterministic
                    out["frac"] = stream.rng.random()
                    out["xor"] = 1 + int(stream.rng.random() * 254)
                    param = (round(out["frac"], 6), out["xor"])
                elif direction == "connect":
                    out["phase"] = rule.phase
                self.events.append((rule.index, direction, dst, method,
                                    stream.seen, rule.action, param))
                return out
        return None

    # --------------------------------------------------------------- stats
    def fired(self, rule_index: Optional[int] = None) -> int:
        with self._lock:
            return sum(
                s.fired for (idx, _, _), s in self._streams.items()
                if rule_index is None or idx == rule_index)

    def schedule(self) -> List[tuple]:
        """The fired-event journal as a list — two planes driven through
        the same event sequence with the same seed produce identical
        schedules (the replay contract)."""
        with self._lock:
            return list(self.events)

    def describe(self) -> str:
        """Replay recipe: printed by failing fault scenarios."""
        return (f"replay: seed={self.seed} "
                f"RAY_TPU_FAULT_PLAN='{json.dumps(self.plan)}'")


# --------------------------------------------------------------------------
# process-wide plane + role
# --------------------------------------------------------------------------

_plane: Optional[FaultPlane] = None
_env_checked = False
_install_lock = threading.Lock()
_role: Optional[str] = None


def process_role() -> str:
    """This process's role for src_role matching (gcs | raylet | driver
    | worker). Settable by the server mains; defaults from
    RAY_TPU_PROCESS_ROLE, else 'driver'."""
    global _role
    if _role is None:
        _role = os.environ.get("RAY_TPU_PROCESS_ROLE", "driver")
    return _role


def set_process_role(role: str) -> None:
    global _role
    _role = role


def load_plan(raw: str) -> Dict[str, Any]:
    """Parse a plan from inline JSON or a file path."""
    raw = raw.strip()
    if not raw.startswith("{"):
        with open(raw) as f:
            raw = f.read()
    return json.loads(raw)


def get_plane() -> Optional[FaultPlane]:
    """The process's active plane, lazily loaded from the environment on
    first use. Returns None (the overwhelmingly common case) when no
    plan is configured — callers gate all injection on this."""
    global _plane, _env_checked
    if _plane is not None or _env_checked:
        return _plane
    with _install_lock:
        if _env_checked:
            return _plane
        raw = os.environ.get("RAY_TPU_FAULT_PLAN", "")
        if not raw:
            try:
                from ray_tpu_torch._private.config import Config

                raw = Config.instance().fault_plan
            except Exception:  # config import cycles at interpreter exit
                raw = ""
        if raw:
            try:
                _plane = FaultPlane(load_plan(raw))
                logger.warning("fault plane ACTIVE: %s",
                               _plane.describe())
            except Exception:
                logger.exception("invalid RAY_TPU_FAULT_PLAN; ignoring")
        _env_checked = True
    return _plane


def install_plane(plane: Optional[FaultPlane]) -> Optional[FaultPlane]:
    """Programmatic (driver/in-process) activation. Returns the plane."""
    global _plane, _env_checked
    with _install_lock:
        _plane = plane
        _env_checked = True
    return plane


def clear_plane() -> None:
    """Deactivate and forget the cached env decision (tests)."""
    global _plane, _env_checked
    with _install_lock:
        _plane = None
        _env_checked = False


def derive_rng(namespace: str) -> random.Random:
    """Explicit RNG stream for a runtime subsystem (raycheck RC03: no
    module-level ``random.*`` draws in cluster/scheduler code). When a
    fault plane is active the stream is derived from the plan's single
    integer seed + the namespace — backoff jitter and replica-shuffle
    decisions then replay bit-for-bit with the fault schedule itself;
    with no plane it is entropy-seeded like any fresh ``Random()``.

    Namespace convention: ``"<subsystem>|<instance>"``, e.g.
    ``"rpc-backoff|127.0.0.1:6379"`` — two instances never share a
    stream, so one consumer's draw count cannot perturb another's."""
    plane = get_plane()
    if plane is None:
        return random.Random()
    h = hashlib.blake2b(f"{plane.seed}|{namespace}".encode(),
                        digest_size=8)
    return random.Random(int.from_bytes(h.digest(), "big"))


def apply_corruption(data, fault: Dict[str, Any],
                     tail_bias: bool = False) -> bytearray:
    """XOR-flip ONE seeded byte of ``data`` per a fired ``corrupt``
    decision. ``tail_bias=True`` confines the flip to the second half
    of the buffer — on a pickled chunk frame the header/pickle
    structure sits up front, so a tail flip corrupts the payload bytes
    (silent wrongness, the case checksums exist for) rather than the
    framing (which would fail loudly on its own)."""
    buf = bytearray(data)
    if not buf:
        return buf
    lo = len(buf) // 2 if tail_bias else 0
    span = max(1, len(buf) - lo)
    off = lo + min(span - 1, int(fault["frac"] * span))
    buf[off] ^= fault["xor"]
    return buf


def plan_env(plan: Dict[str, Any]) -> Dict[str, str]:
    """Environment fragment activating ``plan`` in a child process
    (ProcessCluster's add_node/gcs_env take this directly)."""
    return {"RAY_TPU_FAULT_PLAN": json.dumps(plan)}


# --------------------------------------------------------------------------
# StormPlan — seeded composite fault/overload storms
# --------------------------------------------------------------------------

# Order matters: _derive draws in declaration order, so new kinds must
# APPEND (and derive after the existing ones) to keep the draw
# sequence — and therefore existing storms' timelines — stable.
STORM_KINDS = ("stall_burst", "drop_burst", "corrupt_burst",
               "partition_burst", "kill_replica", "kill_raylet",
               "kill_mid_frame", "partition_mid_tree", "preempt_node")


class StormPlan:
    """A seeded storm TIMELINE over a serve cluster: bursts of the
    existing rule kinds (handler stalls against the GCS and the serve
    replicas, request drops, reply-path corruption against the serve
    response seam, a one-way partition window) PLUS process-kill
    events against serve replicas / raylets — all derived from ONE
    integer seed, so a failing storm replays bit-for-bit like any
    other fault plan (the Jepsen-nemesis posture, composed).

    The wire-rule half feeds :class:`FaultPlane` directly
    (``FaultPlane(storm.plan())``); the kill half is a sorted event
    list the storm driver (bench.py's serve row, the
    ``serve_resilience`` tests) applies against live replica handles /
    raylet processes at the scheduled offsets. Two plans built from
    the same (seed, duration, intensity, kinds) are identical —
    :meth:`timeline` is the canonical fingerprint the determinism test
    pins.
    """

    def __init__(self, seed: int, duration_s: float = 6.0,
                 intensity: float = 1.0,
                 kinds: Optional[Tuple[str, ...]] = None):
        self.seed = int(seed)
        self.duration_s = float(duration_s)
        self.intensity = float(intensity)
        self.kinds = tuple(kinds) if kinds is not None else STORM_KINDS
        unknown = set(self.kinds) - set(STORM_KINDS)
        if unknown:
            raise ValueError(f"unknown storm kinds {sorted(unknown)}; "
                             f"choose from {STORM_KINDS}")
        rng = random.Random(_stream_seed(self.seed, -1, "storm", ""))
        self.rules: List[Dict[str, Any]] = []
        self.kills: List[Dict[str, Any]] = []
        self._derive(rng)

    def _window(self, rng: random.Random) -> Tuple[float, float]:
        """A burst window inside the storm, never butting the end (the
        tail must show recovery)."""
        span = max(0.2, self.duration_s * (0.15 + 0.25 * rng.random()))
        start = rng.random() * max(0.05, self.duration_s - span - 0.2)
        return round(start, 3), round(start + span, 3)

    def _n_bursts(self, rng: random.Random) -> int:
        return max(1, round(self.intensity * (1 + rng.randrange(2))))

    def _derive(self, rng: random.Random) -> None:
        # Derivation order is FIXED (kind declaration order): the draw
        # sequence, and therefore the whole timeline, is a pure
        # function of the constructor arguments.
        for kind in STORM_KINDS:
            if kind not in self.kinds:
                continue
            if kind == "stall_burst":
                for _ in range(self._n_bursts(rng)):
                    start, stop = self._window(rng)
                    # one burst against the control plane (GCS/raylet
                    # handlers), one against the serve replicas' own
                    # request slots
                    dst = "serve::*" if rng.random() < 0.5 else "*"
                    self.rules.append({
                        "action": "stall", "direction": "handler",
                        "dst": dst, "method": "*",
                        "prob": round(0.4 + 0.5 * rng.random(), 3),
                        "delay_ms": [20, int(60 + 140 * self.intensity)],
                        "start_s": start, "stop_s": stop})
            elif kind == "drop_burst":
                for _ in range(self._n_bursts(rng)):
                    start, stop = self._window(rng)
                    self.rules.append({
                        "action": "drop", "direction": "request",
                        "dst": "*", "method": "*",
                        "prob": round(0.15 + 0.25 * rng.random(), 3),
                        "start_s": start, "stop_s": stop})
            elif kind == "corrupt_burst":
                for _ in range(self._n_bursts(rng)):
                    start, stop = self._window(rng)
                    # the serve response seam (replica._respond) — the
                    # silent-wrong-answer ingredient the resilience
                    # plane's reply digest catches
                    self.rules.append({
                        "action": "corrupt", "direction": "reply",
                        "dst": "serve::*", "method": "*",
                        "prob": round(0.3 + 0.5 * rng.random(), 3),
                        "start_s": start, "stop_s": stop})
            elif kind == "partition_burst":
                start, stop = self._window(rng)
                self.rules.append({
                    "action": "partition", "direction": "request",
                    "dst": "*", "method": "*", "prob": 1.0,
                    "start_s": start, "stop_s": stop})
            elif kind in ("kill_replica", "kill_raylet"):
                n = self._n_bursts(rng)
                for _ in range(n):
                    t = 0.1 + rng.random() * max(
                        0.1, self.duration_s * 0.7)
                    self.kills.append({
                        "t": round(t, 3),
                        "target": ("replica" if kind == "kill_replica"
                                   else "raylet"),
                        # driver resolves ordinal mod the live set size
                        "ordinal": rng.randrange(64)})
            elif kind == "kill_mid_frame":
                # Batch-boundary storm: a reply-drop window over the
                # coalesced batch wire surface — frames APPLY on the
                # server, acks vanish, clients retry the whole frame —
                # with a raylet kill scheduled INSIDE the window. The
                # per-row tokens (exactly-once batch frames) must make
                # the replay idempotent; without them the same seed
                # observably double-places tasks / double-creates
                # actors.
                for _ in range(self._n_bursts(rng)):
                    start, stop = self._window(rng)
                    self.rules.append({
                        "action": "drop", "direction": "reply",
                        "dst": "*", "method": "*_batch",
                        "prob": round(0.4 + 0.4 * rng.random(), 3),
                        "start_s": start, "stop_s": stop})
                    t = start + (stop - start) * (0.2
                                                  + 0.6 * rng.random())
                    self.kills.append({
                        "t": round(t, 3), "target": "raylet",
                        "ordinal": rng.randrange(64),
                        "phase": "mid_frame"})
            elif kind == "partition_mid_tree":
                # Batch-boundary storm: sever the chunk-tree push
                # plane mid-relay for a window — interior relays go
                # unreachable with transfers in flight, exercising
                # subtree re-rooting (chunk_tree_failover_enabled) and
                # clean cut-through teardown.
                for _ in range(self._n_bursts(rng)):
                    start, stop = self._window(rng)
                    self.rules.append({
                        "action": "partition", "direction": "request",
                        "dst": "*", "method": "push_*", "prob": 1.0,
                        "start_s": start, "stop_s": stop})
            elif kind == "preempt_node":
                # Spot/preemptible eviction with a NOTICE window
                # (reference: the cloud's preemption warning -> the
                # DrainNode path). The driver delivers preempt_notice
                # to the victim raylet at t, then SIGKILLs it at
                # t + notice_s — the drain plane must migrate actors
                # and re-replicate sole-copy objects INSIDE the
                # window. Appended LAST (declaration-order contract
                # above), so pre-existing storm timelines are
                # unchanged.
                from ray_tpu_torch._private.config import Config as _Cfg

                base_notice = _Cfg.instance().preempt_notice_s
                for _ in range(self._n_bursts(rng)):
                    t = 0.1 + rng.random() * max(
                        0.1, self.duration_s * 0.5)
                    notice = round(
                        base_notice * (0.75 + 0.5 * rng.random()), 3)
                    self.kills.append({
                        "t": round(t, 3), "target": "raylet",
                        "ordinal": rng.randrange(64),
                        "phase": "preempt", "notice_s": notice})
        self.kills.sort(key=lambda k: (k["t"], k["target"], k["ordinal"]))
        # validate every generated rule against the FaultRule contract
        # NOW: a malformed storm must fail at derivation, not mid-run
        for i, spec in enumerate(self.rules):
            FaultRule(i, spec)

    # ---------------------------------------------------------------- views
    def plan(self) -> Dict[str, Any]:
        """The wire half, directly consumable by :class:`FaultPlane`
        (and by RAY_TPU_FAULT_PLAN / plan_env for child processes)."""
        return {"seed": self.seed, "rules": [dict(r) for r in self.rules]}

    def kill_events(self) -> List[Dict[str, Any]]:
        return [dict(k) for k in self.kills]

    def timeline(self) -> List[tuple]:
        """Canonical fingerprint: every burst window and kill event as
        sorted tuples — two plans from the same seed are identical
        here (the determinism contract the tests pin)."""
        out: List[tuple] = []
        for r in self.rules:
            out.append(("rule", r["start_s"], r.get("stop_s"),
                        r["action"], r["direction"], r["dst"],
                        r["prob"]))
        for k in self.kills:
            out.append(("kill", k["t"], None, k["target"], "", "",
                        k["ordinal"]))
        out.sort(key=lambda e: (e[1], e[0], str(e[3:])))
        return out

    def describe(self) -> str:
        """Replay recipe: printed by failing storm scenarios."""
        return (f"storm replay: RAY_TPU_FAULT_PLAN='{self.seed}' "
                f"(StormPlan(seed={self.seed}, "
                f"duration_s={self.duration_s}, "
                f"intensity={self.intensity}, kinds={self.kinds!r}))")


def storm_seed_from_env(default: int = 0) -> int:
    """The one-seed activation path: RAY_TPU_FAULT_PLAN may carry a
    bare integer (storm seed) or a full JSON plan (its ``seed`` field
    is reused), so one environment variable replays either kind of
    schedule."""
    raw = os.environ.get("RAY_TPU_FAULT_PLAN", "").strip()
    if not raw:
        return int(default)
    try:
        return int(raw)
    except ValueError:  # raycheck: disable=RC05 — not-an-int means "try the JSON-plan form next"; the fallthrough IS the handling
        pass
    try:
        return int(load_plan(raw).get("seed", default))
    except Exception:
        logger.debug("RAY_TPU_FAULT_PLAN is neither an integer seed "
                     "nor a plan; storm uses default seed %s", default)
        return int(default)
