"""raycheck — repo-specific static analysis for the runtime's
concurrency & determinism invariants.

The fault-injection and recovery work made several properties
load-bearing: every probabilistic fault-plane decision comes from a
seeded per-stream RNG (single-seed replay), deadlines survive wall-clock
steps because they are monotonic, GCS mutations dedupe retries through
request tokens, and nothing blocks while holding a state lock. Nothing
checked those mechanically — the next refactor could silently break
replayability or reintroduce the fixed-sleep/lock-held-blocking patterns
that were just removed. raycheck is the mechanical check (reference: Ray
gates merges on exactly this kind of tooling — the ASAN/TSAN suites and
custom lint under ``ci/``).

Rules (see :mod:`ray_tpu_torch.tools.raycheck.rules`):

=====  ==================================================================
RC01   lock-held-blocking — no ``time.sleep``, socket send/recv, RPC
       ``call()``/``call_stream()``, or ``open()`` inside a
       ``with <lock>:`` body (cluster/, core/). Locks that serialize the
       I/O itself (``send_lock``-style names) are exempt.
RC02   wall-clock-deadline — no ``time.time()`` in runtime code;
       deadline/backoff/lease arithmetic must use ``time.monotonic()``.
       Genuinely wall-clock sites (filesystem mtimes, user-facing
       timestamps) carry a justified suppression.
RC03   unseeded-randomness — no module-level ``random.*`` /
       ``np.random.*`` draws in cluster/ or scheduler/; an explicit
       ``random.Random`` stream must be threaded in (see
       ``fault_plane.derive_rng``), preserving single-seed replay.
RC04   mutation-token — every GCS mutation RPC handler registered in
       ``gcs_server.py`` must be wrapped by the ``@token_deduped``
       request-token dedupe decorator.
RC05   swallowed-exception — no log-less ``except ...: pass`` in
       cluster/ or core/; swallows get a ``logger.debug`` with enough
       context to attribute them during fault-injection runs.
RC06   wire-method-resolution (whole-program) — every
       ``client.call("name", ...)`` site resolves to a handler
       registered with the RPC server (and with the right unary/stream
       kind); registered handlers and @message schemas nothing calls
       are dead wire surface and flagged too.
RC07   wire-schema-conformance (whole-program) — every registered
       handler has a ``@message`` schema, schema fields match the
       handler's signature, and every literal call site satisfies the
       schema (required fields present, no silently-dropped unknown
       fields, literal types the validator accepts).
RC08   lock-order-cycle (whole-program) — cycle detection on the
       inter-procedural lock-acquisition graph over cluster/ + core/;
       opposite-order lock pairs are potential deadlocks, reported
       with both stacks.
RC09   unmanaged-thread — ``threading.Thread(...)`` in cluster/ or
       core/ outside cluster/threads.py must go through a
       ``ThreadRegistry`` (teardown joins threads by name instead of
       leaking them).
RC10   unbounded-queue — no ``deque()`` / ``queue.Queue()`` /
       ``SimpleQueue()`` without an explicit bound (``maxlen=`` /
       ``maxsize=``) in cluster/ or core/; queues bounded by an
       admission check (shed with RetryLaterError on submit) carry a
       suppression naming the check. Unbounded queues are the raw
       material of metastable overload collapse.
RC11   batch-handler-dedupe — every public ``*_batch`` wire handler in
       the server modules must resolve rows through the per-row
       idempotence-token path before applying them (retried/replayed
       frames re-answer cached rows instead of re-applying them).
RC12   resource-lifecycle (whole-program, flow-sensitive) — per-function
       CFGs with exception edges + a may-hold dataflow over acquired
       resources (shm segments/pins, worker-pool leases, ThreadRegistry
       handles, dedupe-window reservations, pipe/socket fds, device
       buffers); a path where the resource escapes without release or
       return-to-owner is a leak (see :mod:`.cfg`).
RC13   protocol-state-machine (whole-program) — multi-step wire
       conversations (push offer/begin/chunk/end/abort, drain
       ALIVE→DRAINING→DEAD, PG 2PC, breaker closed/open/half-open) are
       declared as explicit state machines in :mod:`.protocols`; phase 2
       checks every declared driver resolves to a live handler or
       function, every non-terminal state has a timeout/abort escape
       edge, no terminal state has outgoing edges, and no state is
       unreachable.
RC14   knob-hygiene (whole-program) — every ``Config`` knob must be
       read somewhere outside its defining config.py, documented in the
       README knob tables, and exercised by at least one test at a
       non-default value.
RC15   counter-hygiene (whole-program) — every ``.inc()`` site must
       target a metric registered in observability/metrics.py; every
       registered metric must be used outside the registry; every
       dict-valued heartbeat stats field must be rendered by
       ``cli.py status``.
RC16   guarded-by-data-race (whole-program) — RacerD-style inference:
       thread roots (ThreadRegistry spawns, raw Thread targets, RPC
       handlers) + per-root reachability + lockset-annotated field
       accesses; a field written from ≥2 roots whose candidate guard
       (majority lock over write sites) some conflicting access does
       not hold is a race. Escapes: init-before-spawn writes,
       immutable-after-publish, Queue/Event/Condition handoffs,
       single-rooted fields (see :mod:`.races`).
RC17   unbounded-blocking (whole-program) — ``Condition.wait()`` /
       ``Event.wait()`` / ``Queue.get()`` / zero-arg ``.join()`` /
       raw socket ``recv`` outside the rpc framing layer, reachable
       from a thread root, without a timeout: a hung peer must cost a
       bounded wait plus a retry decision, never a wedged daemon.
=====  ==================================================================

RC06–RC09 and RC12–RC17 are *whole-program*: phase 1 (:mod:`.facts`)
extracts call sites, handler registrations, schemas, lock edges, thread
spawns and roots, lockset-annotated field accesses, wait sites,
knob/metric/protocol declarations, and per-file use sets from
every file's AST (parsed once, shared by all rules); phase 2 joins them
across the tree — so they only make sense on a whole-tree scan, which
is what the CLI and the tier-1 gate run.

Run ``python -m ray_tpu_torch.tools.raycheck`` (exit 0 = clean; ``--json``
prints a machine-readable finding list; ``--sarif`` writes a SARIF
2.1.0 report for CI archival). Suppress a single finding
inline with ``# raycheck: disable=RC0N`` on the flagged line or the
line above — always with a reason. ``baseline.txt`` can grandfather
known findings by key (regenerate with ``--update-baseline``); it
ships empty and should stay empty.
"""

from __future__ import annotations

import ast
import os
import re
from dataclasses import dataclass
from typing import Dict, Iterable, List, Optional, Sequence, Set

__all__ = [
    "Finding",
    "SourceFile",
    "check_file",
    "check_tree",
    "default_baseline_path",
    "load_baseline",
    "load_tree",
    "save_baseline",
]


@dataclass(frozen=True)
class Finding:
    code: str      # rule code, e.g. "RC01"
    path: str      # posix path relative to the scan root
    line: int      # 1-indexed
    message: str   # defect + fix-it

    @property
    def key(self) -> str:
        """Stable identity for baseline matching (line numbers drift, so
        the baseline keys on path+code+line — a grandfathered finding
        that moves must be re-reviewed, which is the point)."""
        return f"{self.path}:{self.line}:{self.code}"

    def render(self) -> str:
        return f"{self.path}:{self.line}: {self.code} {self.message}"

    def to_dict(self) -> Dict[str, object]:
        """Machine-readable form for the CLI's ``--json`` report."""
        return {"code": self.code, "path": self.path,
                "line": self.line, "message": self.message,
                "key": self.key}


# ``# raycheck: disable=RC01`` or ``disable=RC01,RC05`` — trailing prose
# (the required justification) is ignored by the parser, not by review.
_SUPPRESS_RE = re.compile(
    r"#\s*raycheck:\s*disable=([A-Za-z0-9_]+(?:\s*,\s*[A-Za-z0-9_]+)*)")


class SourceFile:
    """One parsed file: AST + per-line suppression map."""

    def __init__(self, relpath: str, text: str):
        self.relpath = relpath.replace(os.sep, "/")
        self.text = text
        self.tree = ast.parse(text)
        self._suppressed: Dict[int, Set[str]] = {}
        for lineno, line in enumerate(text.splitlines(), start=1):
            m = _SUPPRESS_RE.search(line)
            if m:
                self._suppressed[lineno] = {
                    c.strip().upper() for c in m.group(1).split(",")}

    def is_suppressed(self, line: int, code: str) -> bool:
        """A suppression comment applies to its own physical line and
        the line directly below it (so long statements can carry the
        comment above)."""
        for ln in (line, line - 1):
            codes = self._suppressed.get(ln)
            if codes and (code in codes or "ALL" in codes):
                return True
        return False


def _resolve_rules(rules=None):
    from ray_tpu_torch.tools.raycheck import rules as _rules

    table = _rules.all_rules()
    if rules is None:
        return table
    wanted = set()
    for r in rules:
        wanted.add(r if isinstance(r, str) else r.code)
    return [r for r in table if r.code in wanted]


def _load_source(path: str, relpath: str):
    """(SourceFile, None) or (None, RC00 Finding) for one file."""
    relpath = relpath.replace(os.sep, "/")
    with open(path, "r", encoding="utf-8") as f:
        text = f.read()
    try:
        return SourceFile(relpath, text), None
    except SyntaxError as e:
        return None, Finding("RC00", relpath, e.lineno or 1,
                             f"file does not parse: {e.msg}")


def check_file(path: str, relpath: Optional[str] = None,
               rules=None) -> List[Finding]:
    """Run the (selected) per-file rules over one file. Unsuppressed
    findings only; a file that does not parse yields a single RC00
    finding. Program rules (RC06+) need the whole tree — use
    :func:`check_tree`."""
    sf, err = _load_source(path, relpath or path)
    if err is not None:
        return [err]
    findings: List[Finding] = []
    for rule in _resolve_rules(rules):
        if rule.program or not rule.applies(sf.relpath):
            continue
        for finding in rule.check(sf):
            if not sf.is_suppressed(finding.line, finding.code):
                findings.append(finding)
    findings.sort(key=lambda f: (f.path, f.line, f.code))
    return findings


_SKIP_DIRS = {"__pycache__", ".git", "build", "node_modules"}


def iter_py_files(root: str) -> Iterable[str]:
    for dirpath, dirnames, filenames in os.walk(root):
        dirnames[:] = sorted(d for d in dirnames
                             if d not in _SKIP_DIRS
                             and not d.startswith("."))
        for name in sorted(filenames):
            if name.endswith(".py"):
                yield os.path.join(dirpath, name)


def load_tree(root: str) -> List[SourceFile]:
    """Parse every ``.py`` under ``root`` into :class:`SourceFile`\\ s
    (unparseable files are skipped — :func:`check_tree` reports them as
    RC00). Useful for building a :class:`~.facts.Program` directly,
    e.g. to pin the extracted wire map in a regression test."""
    root = os.path.abspath(root)
    sources: List[SourceFile] = []
    for path in iter_py_files(root):
        sf, _ = _load_source(path, os.path.relpath(path, root))
        if sf is not None:
            sources.append(sf)
    return sources


def check_tree(root: str, rules=None, timings=None) -> List[Finding]:
    """Scan every ``.py`` under ``root``; finding paths are relative to
    ``root`` (rule scoping matches on those relative path parts).

    Two phases over ONE shared parse (the AST cache): per-file rules
    run against each :class:`SourceFile`; then the program rules
    (RC06–RC09, RC12–RC17) run against the :class:`~.facts.Program`
    joined from every file's extracted facts. Inline suppressions
    apply to both.

    Pass a dict as ``timings`` to receive the wall-time breakdown in
    place: ``{"facts_s": <fact-extraction seconds>, "<code>": <rule
    seconds>, ...}`` — what ``--json`` reports and ``check.sh`` prints
    when the scan overruns its budget."""
    import time as _time

    root = os.path.abspath(root)
    resolved = _resolve_rules(rules)
    sources: List[SourceFile] = []
    findings: List[Finding] = []
    if os.path.isfile(root):
        paths = [(root, os.path.basename(root))]
    else:
        paths = [(p, os.path.relpath(p, root))
                 for p in iter_py_files(root)]
    for path, relpath in paths:
        sf, err = _load_source(path, relpath)
        if err is not None:
            findings.append(err)
        else:
            sources.append(sf)
    per_file = [r for r in resolved if not r.program]
    program_rules = [r for r in resolved if r.program]
    rule_s = {r.code: 0.0 for r in resolved}
    for sf in sources:
        for rule in per_file:
            if not rule.applies(sf.relpath):
                continue
            t0 = _time.monotonic()
            for finding in rule.check(sf):
                if not sf.is_suppressed(finding.line, finding.code):
                    findings.append(finding)
            rule_s[rule.code] += _time.monotonic() - t0
    if program_rules:
        from ray_tpu_torch.tools.raycheck import facts as _facts

        t0 = _time.monotonic()
        program = _facts.Program(sources, root=root)
        facts_s = _time.monotonic() - t0
        by_path = {sf.relpath: sf for sf in sources}
        for rule in program_rules:
            t0 = _time.monotonic()
            for finding in rule.check_program(program):
                sf = by_path.get(finding.path)
                if sf is None or not sf.is_suppressed(finding.line,
                                                      finding.code):
                    findings.append(finding)
            rule_s[rule.code] += _time.monotonic() - t0
    else:
        facts_s = 0.0
    if timings is not None:
        timings["facts_s"] = round(facts_s, 4)
        for code, secs in rule_s.items():
            timings[code] = round(secs, 4)
    findings.sort(key=lambda f: (f.path, f.line, f.code))
    return findings


def default_baseline_path() -> str:
    return os.path.join(os.path.dirname(__file__), "baseline.txt")


def load_baseline(path: Optional[str] = None) -> Set[str]:
    """Finding keys (``path:line:code``) grandfathered by the baseline
    file; blank lines and ``#`` comments are ignored. The shipped
    baseline is empty — the tree is raycheck-clean — and new entries
    should be treated as debt, not as a suppression mechanism."""
    path = path or default_baseline_path()
    keys: Set[str] = set()
    if not os.path.exists(path):
        return keys
    with open(path, "r", encoding="utf-8") as f:
        for line in f:
            line = line.strip()
            if line and not line.startswith("#"):
                keys.add(line)
    return keys


def save_baseline(keys: Iterable[str],
                  path: Optional[str] = None) -> str:
    """Write a baseline file from finding keys (the CLI's
    ``--update-baseline``). The header restates the contract: entries
    are debt to pay down, and the shipped baseline is pinned empty by
    test — this exists so CI can regenerate the file mechanically
    instead of hand-editing keys."""
    path = path or default_baseline_path()
    with open(path, "w", encoding="utf-8") as f:
        f.write("# raycheck baseline — grandfathered finding keys, "
                "one per line as\n# `path:line:code`. Ships EMPTY: "
                "the tree is raycheck-clean, and new\n# entries are "
                "debt to pay down, not an alternative to fixing or "
                "to an\n# inline justified suppression.\n")
        for key in sorted(set(keys)):
            f.write(key + "\n")
    return path
