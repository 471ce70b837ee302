"""RC16/RC17 — whole-program data-race and unbounded-blocking rules.

RacerD-style guarded-by inference over the phase-1 concurrency facts
(:mod:`.facts`): thread roots (ThreadRegistry spawns, raw
``threading.Thread`` targets, registered RPC handlers), the functions
each root transitively reaches through the module-local call graph,
and every instance-field / declared-global access annotated with the
lockset held at the site (locally acquired locks plus the entry
lockset flowed through the intra-class call closure).

**RC16** infers each field's candidate guard — the most common lock
over its write sites — and fires when the field is accessed from ≥ 2
distinct thread roots, at least one access is a write, and some
conflicting pair of accesses shares no lock. Precision escapes, each
a deliberate under-approximation:

* init-before-spawn: ``__init__`` writes (and any access in code no
  thread root reaches — main-thread setup) don't participate;
* immutable-after-publish: fields never written outside ``__init__``
  can't race;
* handoff objects: fields holding a Queue/Event/Condition/Lock are
  internally synchronized, and lock-named fields are the guards
  themselves;
* single-rooted fields: all accesses reached by one root are
  serialized by construction (same-root self-races are out of scope —
  the report names a root *pair*).

**RC17** fires on any potentially-forever wait reachable from a thread
root — ``Condition.wait()``/``wait_for()``, ``Event.wait()``,
``Queue.get()``, a zero-arg ``.join()``, raw socket ``recv`` outside
the rpc framing layer — that passes no timeout argument. A hung peer
must cost a bounded wait plus a retry decision, never a wedged daemon
thread (the reference's timeout-everywhere RPC discipline).
"""

from __future__ import annotations

from collections import Counter
from typing import Dict, Iterator, List, Tuple

from ray_tpu_torch.tools.raycheck import Finding
from ray_tpu_torch.tools.raycheck.facts import (FieldAccess, SYNC_CTORS,
                                          _LOCK_NAME_RE)

__all__ = ["check_rc16", "check_rc17"]


def _fmt_roots(labels) -> str:
    labels = sorted(labels)
    if len(labels) > 3:
        labels = labels[:3] + [f"+{len(labels) - 3} more"]
    return ", ".join(labels)


def check_rc16(program) -> Iterator[Finding]:
    reach = program.root_reach
    by_field: Dict[Tuple[str, str, str], List[FieldAccess]] = {}
    for a in program.field_accesses:
        by_field.setdefault((a.path, a.cls, a.attr), []).append(a)
    for key in sorted(by_field):
        path, cls, attr = key
        # the guard itself, or a synchronized handoff object, is not
        # raceable shared state
        if _LOCK_NAME_RE.search(attr.lower()):
            continue
        if program.field_types.get(key) in SYNC_CTORS:
            continue
        accs = by_field[key]
        post = [a for a in accs if not a.fid.endswith(".__init__")]
        if not any(a.write for a in post):
            continue  # immutable after publish
        # only accesses some thread root actually reaches participate;
        # main-thread setup (serve() before its spawns) drops out here
        rooted = [(a, frozenset(reach.get(a.fid, ()))) for a in post
                  if reach.get(a.fid)]
        all_roots = frozenset().union(*(r for _, r in rooted)) \
            if rooted else frozenset()
        if len(all_roots) < 2:
            continue  # single-rooted: serialized by construction
        writes = [(a, r) for a, r in rooted if a.write]
        if not writes:
            continue
        # candidate guard: majority lock over rooted write sites
        tally: Counter = Counter()
        for a, _ in writes:
            tally.update(a.locks)
        candidate = min((lock for lock, n in tally.items()
                         if n == max(tally.values())), default=None) \
            if tally else None
        # conflict: a write and another access, from provably-distinct
        # roots, with disjoint locksets
        conflict = None
        for a, ra in sorted(writes, key=lambda p: (p[0].line,
                                                   p[0].fid)):
            for b, rb in rooted:
                if a is b:
                    continue
                if ra == rb and len(ra) == 1:
                    continue  # same single root: serialized
                if a.locks & b.locks:
                    continue  # a common lock orders the pair
                conflict = (a, ra, b, rb)
                break
            if conflict:
                break
        if conflict is None:
            continue
        a, ra, b, rb = conflict
        # report at the access MISSING the candidate guard: when the
        # write is correctly locked the defect is the bare access on
        # the other side, and the finding should point there
        if (candidate is not None and candidate in a.locks
                and candidate not in b.locks):
            a, ra, b, rb = b, rb, a, ra
        field = f"{cls}.{attr}" if cls else f"global {attr}"
        other = (f"{b.path}:{b.line}"
                 if b.path != a.path else f"line {b.line}")
        guard_hint = (
            f"hold '{candidate}' at every access"
            if candidate is not None else
            "no write site holds any lock — introduce one")
        verb_a = "written" if a.write else "read"
        verb_b = "written" if b.write else "accessed"
        yield Finding(
            "RC16", a.path, a.line,
            f"data race on '{field}': {verb_a} here from thread "
            f"root(s) [{_fmt_roots(ra)}] and {verb_b} at {other} "
            f"from [{_fmt_roots(rb - ra or rb)}] with no common "
            f"lock (candidate guard: {guard_hint}), or move the "
            f"write before the first spawn, or hand the value off "
            f"through a Queue/Event")


def check_rc17(program) -> Iterator[Finding]:
    reach = program.root_reach
    for w in program.wait_sites:
        if w.bounded:
            continue
        roots = reach.get(w.fid)
        if not roots:
            continue  # not reachable from any server/loop root
        yield Finding(
            "RC17", w.path, w.line,
            f"unbounded blocking: {w.desc} on '{w.receiver}' can "
            f"wait forever on thread root(s) "
            f"[{_fmt_roots(roots)}] — pass a timeout= (a Config "
            f"knob, not a magic number) and handle expiry, or use "
            f"the _nowait/poll form")
