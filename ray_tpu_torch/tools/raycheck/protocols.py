"""Wire-protocol state machines for RC13 (raycheck v3).

The reference stack compiles its multi-step conversations out of
protobuf IDL + gRPC service definitions, so protocol drift is a build
error. This repo's wire layer is pickled dict messages over
length-prefixed frames — nothing structural stops a handler from
driving an edge the conversation never declared, or a state from
losing its timeout path in a refactor. RC13 closes that gap by making
each conversation an explicit, importable state machine; phase-1 facts
already know every registered handler and schema, so phase 2 can check
the declarations against the live tree.

Each :class:`Protocol` declares:

* ``states`` / ``initial`` / ``terminal`` — the conversation's shape.
* ``transitions`` — :class:`T` edges, each naming its ``driver``: for
  ``kind="wire"`` the schema op whose handler drives the edge, for
  ``kind="internal"`` the function (sweeper, deadline loop, breaker
  method) that drives it locally. ``escape=True`` marks the
  timeout/abort/expiry edge that guarantees the source state cannot
  wedge — RC13 requires at least one leaving every non-initial,
  non-terminal state (and flags terminal states with outgoing edges,
  unreachable states, and drivers that resolve to nothing).
* ``covers`` — wire ops that BELONG to this conversation: every
  covered op must drive at least one edge, so adding a message to the
  family without placing it in the machine is a finding.

The declarations are plain literals: RC13 re-extracts them from this
file's AST (not by importing it), so a machine built dynamically is
itself a finding ("not statically analyzable").
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Tuple

__all__ = ["T", "Protocol", "PROTOCOLS"]


@dataclass(frozen=True)
class T:
    """One legal transition. ``driver`` is a wire op (kind="wire") or a
    function name defined somewhere in the scanned tree
    (kind="internal"). ``escape`` marks the timeout/abort/expiry edge
    for the source state."""
    src: str
    dst: str
    driver: str
    kind: str = "wire"
    escape: bool = False


@dataclass(frozen=True)
class Protocol:
    name: str
    states: Tuple[str, ...]
    initial: str
    terminal: Tuple[str, ...]
    transitions: Tuple[T, ...]
    covers: Tuple[str, ...] = field(default=())


# --------------------------------------------------------------------------
# Object push: offer → begin → chunk* → end, abort/sweep everywhere.
# Receiver-side state lives in RayletServer._push_in; the RECEIVING
# escape is the stale-inbound sweeper, which reaps trees
# whose sender died mid-stream.
# --------------------------------------------------------------------------

PUSH = Protocol(
    name="push",
    states=("IDLE", "OFFERED", "RECEIVING", "SEALED", "ABORTED"),
    initial="IDLE",
    terminal=("SEALED", "ABORTED"),
    transitions=(
        T("IDLE", "OFFERED", "push_offer"),
        # small objects arrive whole in one frame: offer, stream, and
        # seal collapse into a single message
        T("IDLE", "SEALED", "push_object"),
        # mid-size objects skip the offer and open the stream directly
        T("IDLE", "RECEIVING", "push_begin"),
        T("OFFERED", "RECEIVING", "push_begin"),
        T("RECEIVING", "RECEIVING", "push_chunk"),
        T("RECEIVING", "RECEIVING", "push_chunk_data"),
        T("RECEIVING", "SEALED", "push_end"),
        T("OFFERED", "ABORTED", "push_abort", escape=True),
        T("RECEIVING", "ABORTED", "push_abort", escape=True),
        # sender died mid-stream: the sweeper reaps the inbound tree
        T("OFFERED", "ABORTED", "_sweep_stale_inbound",
          kind="internal", escape=True),
        T("RECEIVING", "ABORTED", "_sweep_stale_inbound",
          kind="internal", escape=True),
    ),
    covers=("push_offer", "push_object", "push_begin", "push_chunk",
            "push_chunk_data", "push_end", "push_abort"),
)


# --------------------------------------------------------------------------
# Node drain: ALIVE → DRAINING → DEAD. Wire entry points are
# drain_node (operator) and preempt_notice (spot eviction); the GCS
# drives migration internally and the deadline fallback guarantees
# DRAINING always terminates.
# --------------------------------------------------------------------------

DRAIN = Protocol(
    name="drain",
    states=("ALIVE", "DRAINING", "DEAD"),
    initial="ALIVE",
    terminal=("DEAD",),
    transitions=(
        T("ALIVE", "DRAINING", "drain_node"),
        T("ALIVE", "DRAINING", "preempt_notice"),
        T("ALIVE", "DRAINING", "_drain_for_preemption", kind="internal"),
        T("DRAINING", "DEAD", "_drain_node_graceful", kind="internal"),
        # deadline fallback: a drain that cannot migrate in time is
        # forced dead rather than wedged
        T("DRAINING", "DEAD", "_mark_node_dead", kind="internal",
          escape=True),
        # an unresponsive node skips DRAINING entirely
        T("ALIVE", "DEAD", "_mark_node_dead", kind="internal",
          escape=True),
    ),
    covers=("drain_node", "preempt_notice"),
)


# --------------------------------------------------------------------------
# Placement-group two-phase commit: prepare leases resources,
# commit pins them, return releases. PENDING's escape is pg_remove
# (caller gave up before placement); PREPARED's is the lease expiry
# sweep; COMMITTED returns bundles on group removal or node death.
# --------------------------------------------------------------------------

PG_2PC = Protocol(
    name="pg_2pc",
    states=("PENDING", "PREPARED", "COMMITTED", "RETURNED"),
    initial="PENDING",
    terminal=("RETURNED",),
    transitions=(
        T("PENDING", "PREPARED", "prepare_bundle"),
        T("PREPARED", "COMMITTED", "commit_bundle"),
        T("COMMITTED", "RETURNED", "return_bundle", escape=True),
        T("PREPARED", "RETURNED", "return_bundle", escape=True),
        T("PENDING", "RETURNED", "pg_remove", escape=True),
    ),
    covers=("prepare_bundle", "commit_bundle", "return_bundle",
            "pg_remove"),
)


# --------------------------------------------------------------------------
# Circuit breaker (overload plane, PRs 11/14): purely node-local, so
# every driver is internal. No terminal state — the machine cycles for
# the process lifetime; OPEN's escape is the allow() probe timer,
# HALF_OPEN's is record_failure snapping back to OPEN.
# --------------------------------------------------------------------------

BREAKER = Protocol(
    name="breaker",
    states=("closed", "open", "half_open"),
    initial="closed",
    terminal=(),
    transitions=(
        T("closed", "open", "record_failure", kind="internal"),
        T("open", "half_open", "allow", kind="internal", escape=True),
        T("half_open", "closed", "record_success", kind="internal"),
        T("half_open", "open", "record_failure", kind="internal",
          escape=True),
    ),
)


PROTOCOLS = (PUSH, DRAIN, PG_2PC, BREAKER)
