"""raycheck rule implementations.

Each rule is a :class:`Rule` with a code, a short title, a path scope
(which part of the tree the invariant governs), and a ``check(sf)``
generator yielding :class:`~ray_tpu_torch.tools.raycheck.Finding`. Rules are
purely syntactic/AST-level by design: they over-approximate (a
legitimate exception gets an inline ``# raycheck: disable=RC0N`` with a
reason) rather than under-approximate (a silent miss is a replay or
liveness bug waiting for a fault-injection run to find it the hard
way)."""

from __future__ import annotations

import ast
import os
import re
from typing import Callable, Iterator, List, Optional

from ray_tpu_torch.tools.raycheck import Finding, SourceFile
from ray_tpu_torch.tools.raycheck import races as _races


class Rule:
    """A per-file rule checks one :class:`SourceFile`; a *program* rule
    (``program=True``) checks the whole-scan :class:`~.facts.Program`
    — its facts span files, so it runs once per tree, after phase 1
    extracted every file's facts."""

    def __init__(self, code: str, title: str,
                 scope: Callable[[List[str]], bool],
                 check: Callable, program: bool = False):
        self.code = code
        self.title = title
        self.program = program
        self._scope = scope
        self._check = check

    def applies(self, relpath: str) -> bool:
        return self._scope(relpath.split("/"))

    def check(self, sf: SourceFile) -> Iterator[Finding]:
        return self._check(sf)

    def check_program(self, program) -> Iterator[Finding]:
        return self._check(program)


def _in_dirs(*dirs: str) -> Callable[[List[str]], bool]:
    """Scope predicate: any of ``dirs`` appears as a directory segment
    of the relative path (works whether the scan root is the repo, the
    package, or a corpus fixture tree)."""
    wanted = set(dirs)
    return lambda parts: bool(wanted.intersection(parts[:-1]))


def _terminal_name(node: ast.AST) -> Optional[str]:
    """``self._avail_lock`` -> ``_avail_lock``; ``send_lock`` ->
    ``send_lock``; calls/subscripts -> None (not a named lock)."""
    if isinstance(node, ast.Name):
        return node.id
    if isinstance(node, ast.Attribute):
        return node.attr
    return None


# --------------------------------------------------------------------------
# RC01 — lock-held-blocking
# --------------------------------------------------------------------------

# a with-item naming one of these is treated as a state lock
_LOCK_NAME_RE = re.compile(r"(?:^|_)(?:lock|cv|cond|mutex)$")
# ...unless the name says the lock serializes the I/O itself (the
# send-lock pattern in rpc.py: frames from concurrent handlers must not
# interleave mid-frame, so holding it across sendall is the point)
_IO_LOCK_RE = re.compile(r"send|write|reply")

# socket methods blocking enough to flag unconditionally
_SOCKET_ATTRS = {"sendall", "sendto", "recv_into", "recvfrom"}
# ambiguous names ('send' is also a pipe/generator method): only flagged
# when the receiver's name looks like a socket/connection
_SOCKETISH_ATTRS = {"send", "recv", "connect", "accept"}
_SOCKETISH_RECV_RE = re.compile(r"sock|conn")
# the RPC client surface
_RPC_ATTRS = {"call", "call_stream"}


def _blocking_desc(node: ast.Call) -> Optional[str]:
    fn = node.func
    if isinstance(fn, ast.Name) and fn.id == "open":
        return "file I/O (open())"
    if not isinstance(fn, ast.Attribute):
        return None
    attr = fn.attr
    if attr == "sleep" and isinstance(fn.value, ast.Name) \
            and fn.value.id == "time":
        return "time.sleep()"
    if attr in _SOCKET_ATTRS:
        return f"socket .{attr}()"
    if attr in _SOCKETISH_ATTRS:
        recv = _terminal_name(fn.value)
        if recv and _SOCKETISH_RECV_RE.search(recv.lower()):
            return f"socket .{attr}()"
        return None
    if attr in _RPC_ATTRS:
        return f"blocking RPC .{attr}()"
    return None


def _prune_walk(stmt: ast.stmt) -> Iterator[ast.AST]:
    """ast.walk with pruning at deferred-execution boundaries: nested
    function bodies, lambdas, and class bodies run after the lock is
    released, so calls inside them are not lock-held."""
    stack: List[ast.AST] = [stmt]
    skip = (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda,
            ast.ClassDef)
    while stack:
        node = stack.pop()
        if isinstance(node, skip):
            continue
        yield node
        stack.extend(ast.iter_child_nodes(node))


def check_rc01(sf: SourceFile) -> Iterator[Finding]:
    for node in ast.walk(sf.tree):
        if not isinstance(node, (ast.With, ast.AsyncWith)):
            continue
        lock_name = None
        for item in node.items:
            name = _terminal_name(item.context_expr)
            if name is None:
                continue
            low = name.lower()
            if _LOCK_NAME_RE.search(low) and not _IO_LOCK_RE.search(low):
                lock_name = name
                break
        if lock_name is None:
            continue
        for stmt in node.body:
            for child in _prune_walk(stmt):
                if not isinstance(child, ast.Call):
                    continue
                desc = _blocking_desc(child)
                if desc is not None:
                    yield Finding(
                        "RC01", sf.relpath, child.lineno,
                        f"{desc} while holding `{lock_name}` — move the "
                        f"blocking work outside the critical section "
                        f"(copy state under the lock, act after "
                        f"release); if this lock exists to serialize "
                        f"the I/O itself, name it *send_lock*-style or "
                        f"suppress with a reason")


# --------------------------------------------------------------------------
# RC02 — wall-clock-deadline
# --------------------------------------------------------------------------


def _time_time_calls(sf: SourceFile) -> Iterator[ast.Call]:
    bare_time_imported = any(
        isinstance(n, ast.ImportFrom) and n.module == "time"
        and any(a.name == "time" for a in n.names)
        for n in ast.walk(sf.tree))
    for node in ast.walk(sf.tree):
        if not isinstance(node, ast.Call):
            continue
        fn = node.func
        if isinstance(fn, ast.Attribute) and fn.attr == "time" \
                and isinstance(fn.value, ast.Name) \
                and fn.value.id == "time":
            yield node
        elif bare_time_imported and isinstance(fn, ast.Name) \
                and fn.id == "time":
            yield node


def check_rc02(sf: SourceFile) -> Iterator[Finding]:
    for call in _time_time_calls(sf):
        yield Finding(
            "RC02", sf.relpath, call.lineno,
            "time.time() in runtime code — deadline/backoff/lease "
            "arithmetic must use time.monotonic() (wall-clock steps "
            "under NTP and breaks expiry math); if wall-clock is "
            "genuinely required (filesystem mtimes, user-facing "
            "timestamps), suppress with the reason")


# --------------------------------------------------------------------------
# RC03 — unseeded-randomness
# --------------------------------------------------------------------------

# constructors of explicit streams are the fix, not the violation
_RANDOM_ALLOWED = {"Random", "SystemRandom"}
_NP_RANDOM_ALLOWED = {"default_rng", "Generator", "RandomState"}


def _module_aliases(sf: SourceFile, module: str) -> set:
    out = set()
    for node in ast.walk(sf.tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                if alias.name == module:
                    out.add(alias.asname or module)
    return out


def check_rc03(sf: SourceFile) -> Iterator[Finding]:
    rand_aliases = _module_aliases(sf, "random")
    np_aliases = _module_aliases(sf, "numpy")
    fix = ("thread an explicit seeded random.Random stream in "
           "(fault_plane.derive_rng derives one from the active fault "
           "plan's seed) so schedules replay from a single integer seed")
    # `from random import shuffle` defeats the stream discipline outright
    for node in ast.walk(sf.tree):
        if isinstance(node, ast.ImportFrom) and node.module == "random":
            bad = [a.name for a in node.names
                   if a.name not in _RANDOM_ALLOWED]
            if bad:
                yield Finding(
                    "RC03", sf.relpath, node.lineno,
                    f"module-level randomness imported from `random` "
                    f"({', '.join(bad)}) — {fix}")
    for node in ast.walk(sf.tree):
        if not isinstance(node, ast.Call) \
                or not isinstance(node.func, ast.Attribute):
            continue
        fn = node.func
        if isinstance(fn.value, ast.Name) and fn.value.id in rand_aliases \
                and fn.attr not in _RANDOM_ALLOWED:
            yield Finding(
                "RC03", sf.relpath, node.lineno,
                f"random.{fn.attr}() draws from the process-global RNG "
                f"— {fix}")
        elif isinstance(fn.value, ast.Attribute) \
                and fn.value.attr == "random" \
                and isinstance(fn.value.value, ast.Name) \
                and fn.value.value.id in np_aliases \
                and fn.attr not in _NP_RANDOM_ALLOWED:
            yield Finding(
                "RC03", sf.relpath, node.lineno,
                f"np.random.{fn.attr}() draws from numpy's global RNG "
                f"— {fix}")


# --------------------------------------------------------------------------
# RC04 — mutation-token (gcs_server.py cross-checks registration vs defs)
# --------------------------------------------------------------------------

# the GCS mutation surface: retried/duplicated frames must replay the
# cached reply instead of double-applying (double-counted restarts,
# twice-killed actors, double-placed PGs)
MUTATION_HANDLERS = frozenset({
    "actor_create", "actor_kill", "report_actor_failure",
    "pg_create", "pg_remove", "drain_node",
})
_DECORATOR_NAME = "token_deduped"


def _registered_names(tree: ast.AST) -> set:
    """Handler names registered with the RPC server: literal
    ``srv.register("name", ...)`` calls plus ``for name in (...):``
    loops whose body registers the loop variable."""
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Call) \
                and isinstance(node.func, ast.Attribute) \
                and node.func.attr in ("register", "register_stream") \
                and node.args \
                and isinstance(node.args[0], ast.Constant) \
                and isinstance(node.args[0].value, str):
            out.add(node.args[0].value)
        if isinstance(node, ast.For) \
                and isinstance(node.iter, (ast.Tuple, ast.List, ast.Set)):
            registers = any(
                isinstance(c, ast.Call)
                and isinstance(c.func, ast.Attribute)
                and c.func.attr == "register"
                for b in node.body for c in ast.walk(b))
            if registers:
                out.update(
                    e.value for e in node.iter.elts
                    if isinstance(e, ast.Constant)
                    and isinstance(e.value, str))
    return out


def _has_token_decorator(fn: ast.FunctionDef) -> bool:
    for dec in fn.decorator_list:
        name = _terminal_name(dec)
        if name is None and isinstance(dec, ast.Call):
            name = _terminal_name(dec.func)
        if name == _DECORATOR_NAME:
            return True
    return False


def check_rc04(sf: SourceFile) -> Iterator[Finding]:
    registered = _registered_names(sf.tree)
    for node in ast.walk(sf.tree):
        if not isinstance(node, ast.ClassDef):
            continue
        for fn in node.body:
            if not isinstance(fn, ast.FunctionDef):
                continue
            is_mutation = fn.name in MUTATION_HANDLERS
            takes_token = any(
                a.arg == "token"
                for a in fn.args.args + fn.args.kwonlyargs)
            if not (is_mutation or (takes_token and fn.name in registered)):
                continue
            if is_mutation and fn.name not in registered:
                yield Finding(
                    "RC04", sf.relpath, fn.lineno,
                    f"mutation handler {fn.name}() is not registered "
                    f"with the RPC server — clients retry it by name; "
                    f"add it to the serve() registration list")
            if not _has_token_decorator(fn):
                why = ("declares a request `token` parameter"
                       if takes_token and not is_mutation
                       else "mutates GCS state")
                yield Finding(
                    "RC04", sf.relpath, fn.lineno,
                    f"handler {fn.name}() {why} but is not wrapped by "
                    f"@{_DECORATOR_NAME} — a client retry after a lost "
                    f"ack (or a fault-plane frame duplication) would "
                    f"double-apply the mutation; decorate it and drop "
                    f"any hand-rolled token plumbing")


# --------------------------------------------------------------------------
# RC05 — swallowed-exception
# --------------------------------------------------------------------------


def check_rc05(sf: SourceFile) -> Iterator[Finding]:
    for node in ast.walk(sf.tree):
        if isinstance(node, ast.ExceptHandler) \
                and len(node.body) == 1 \
                and isinstance(node.body[0], ast.Pass):
            what = (ast.unparse(node.type)
                    if node.type is not None else "BaseException")
            yield Finding(
                "RC05", sf.relpath, node.lineno,
                f"`except {what}: pass` swallows the exception without "
                f"a trace — fault-injection failures become "
                f"unattributable; add a logger.debug(...) carrying "
                f"enough context (what was being attempted, on what "
                f"object/peer) or suppress with the reason the swallow "
                f"is safe")


# --------------------------------------------------------------------------
# RC06 — wire-method-resolution (whole-program)
# --------------------------------------------------------------------------


def check_rc06(prog) -> Iterator[Finding]:
    """Joins every wire call site against every registered handler:
    a typo'd method name fails here instead of at runtime (reference:
    proto-compiled stubs make an unknown RPC a compile error), dead
    handlers/schemas are surfaced so the wire surface cannot silently
    rot, and unary/stream kind mismatches are rejected."""
    handlers = prog.handler_map()
    called = prog.called_methods()
    for cs in prog.wire_call_sites():
        hs = handlers.get(cs.method)
        if not hs:
            yield Finding(
                "RC06", cs.path, cs.line,
                f".{cs.kind}({cs.method!r}) resolves to no registered "
                f"handler — no srv.register()/register_stream() in the "
                f"scanned tree declares it; a typo'd or renamed method "
                f"only fails at runtime (AttributeError in dispatch), "
                f"and only on the code path a test happens to exercise")
            continue
        is_stream = any(h.is_stream for h in hs)
        is_unary = any(not h.is_stream for h in hs)
        if cs.kind == "call_stream" and not is_stream:
            yield Finding(
                "RC06", cs.path, cs.line,
                f".call_stream({cs.method!r}) targets a unary handler "
                f"— the reply is a single ok frame, not a chunk "
                f"stream; use .call() or register the handler with "
                f"register_stream()")
        elif cs.kind in ("call", "call_async") and not is_unary:
            yield Finding(
                "RC06", cs.path, cs.line,
                f".{cs.kind}({cs.method!r}) targets a stream handler "
                f"— chunks would be dropped by the unary completion "
                f"path; use .call_stream()")
    for method in sorted(handlers):
        if method in called:
            continue
        for h in handlers[method]:
            yield Finding(
                "RC06", h.path, h.line,
                f"handler {method!r} ({h.server}) is registered but no "
                f".call()/.call_async()/.call_stream() site in the "
                f"scanned tree invokes it — dead wire surface drifts "
                f"unchecked; delete the registration or wire up the "
                f"caller that should exist")
    for sd in prog.schemas:
        if sd.method not in handlers:
            yield Finding(
                "RC06", sd.path, sd.line,
                f"@message({sd.method!r}) schema has no registered "
                f"handler — it validates nothing; delete it or "
                f"register the handler it was written for")


# --------------------------------------------------------------------------
# RC07 — wire-schema-conformance (whole-program)
# --------------------------------------------------------------------------


def check_rc07(prog) -> Iterator[Finding]:
    """Three joins around ``cluster/schema.py``'s @message registry:
    every registered handler must have a schema (the IDL-coverage bar
    — an unschema'd method skips validation entirely), the schema's
    field set must match the handler's signature (validate() drops
    unknown kwargs BEFORE dispatch, so drift surfaces as a missing-arg
    TypeError or a silently lost field), and every literal call site
    must satisfy the schema (required fields present, no fields the
    receiver would drop, literal types the validator accepts)."""
    from ray_tpu_torch.tools.raycheck import facts as _facts

    handlers = prog.handler_map()
    schemas = prog.schema_map()
    for method in sorted(handlers):
        sd = schemas.get(method)
        for h in handlers[method]:
            if sd is None:
                yield Finding(
                    "RC07", h.path, h.line,
                    f"registered handler {method!r} ({h.server}) has "
                    f"no @message schema — its kwargs cross the wire "
                    f"unvalidated (reference: every Ray RPC has a "
                    f".proto message); declare one in "
                    f"cluster/schema.py")
                continue
            if not h.resolved:
                continue
            params = set(h.required) | set(h.optional)
            fields = sd.field_map()
            if not h.var_kw:
                for f in sd.fields:
                    if f.name not in params:
                        yield Finding(
                            "RC07", sd.path, f.line,
                            f"schema field {f.name!r} of "
                            f"@message({method!r}) is not a parameter "
                            f"of the registered handler ({h.server}) "
                            f"— validate() passes it through and "
                            f"dispatch dies with TypeError; remove "
                            f"the field or add the parameter")
            for p in h.required:
                if p not in fields:
                    yield Finding(
                        "RC07", h.path, h.line,
                        f"handler {method!r} requires parameter "
                        f"{p!r} but @message({method!r}) does not "
                        f"declare it — validate() drops or omits the "
                        f"field before dispatch, so every call dies "
                        f"with a missing-argument TypeError; add the "
                        f"field to the schema")
    for cs in prog.wire_call_sites():
        sd = schemas.get(cs.method)
        if sd is None:
            continue
        fields = sd.field_map()
        keys = set(cs.keys) - _facts.CLIENT_KWARGS
        for k in sorted(keys - set(fields)):
            yield Finding(
                "RC07", cs.path, cs.line,
                f"field {k!r} of this {cs.method!r} call is not in "
                f"its @message schema — the receiver SILENTLY DROPS "
                f"unknown fields (proto3 posture), so the argument "
                f"never arrives; fix the kwarg name or extend the "
                f"schema")
        if not cs.splat:
            for f in sd.fields:
                if f.required and f.name not in keys:
                    yield Finding(
                        "RC07", cs.path, cs.line,
                        f"required field {f.name!r} of "
                        f"@message({cs.method!r}) is missing at this "
                        f"call site — validate() raises SchemaError "
                        f"at dispatch; pass it (or give the field a "
                        f"default in cluster/schema.py)")
        for key, typename in cs.consts:
            f = fields.get(key)
            if f is not None and not _facts.type_compatible(f.type,
                                                            typename):
                yield Finding(
                    "RC07", cs.path, cs.line,
                    f"literal {typename} for field {key!r} of "
                    f"@message({cs.method!r}) — the schema declares "
                    f"{f.type} and validate() raises SchemaError; "
                    f"fix the literal or the declared type")


# --------------------------------------------------------------------------
# RC08 — lock-order-cycle (whole-program)
# --------------------------------------------------------------------------


def check_rc08(prog) -> Iterator[Finding]:
    """Cycle detection on the inter-procedural lock-acquisition graph
    over cluster/ + core/ (the static half of what TSAN's deadlock
    detector sees at runtime): two code paths taking the same pair of
    locks in opposite orders can deadlock under concurrency — each
    cycle is reported once with every participating edge's stack."""
    for cycle in prog.lock_cycles:
        first = cycle[0]
        lines = []
        for e in cycle:
            via = f" via {e.via.split('::')[-1]}()" if e.via else ""
            lines.append(f"holding `{_short(e.src)}` acquires "
                         f"`{_short(e.dst)}` at {e.path}:{e.line} "
                         f"(in {e.holder.split('::')[-1]}{via})")
        yield Finding(
            "RC08", first.path, first.line,
            "lock-order cycle (potential deadlock): "
            + "; ".join(lines)
            + " — pick one order and restructure the other path "
            "(copy state under the first lock, act after release), "
            "or suppress with the reason the paths cannot run "
            "concurrently")


def _short(lock_id: str) -> str:
    return lock_id.split("::")[-1]


# --------------------------------------------------------------------------
# RC09 — unmanaged-thread (whole-program facts, per-site findings)
# --------------------------------------------------------------------------


def check_rc09(prog) -> Iterator[Finding]:
    """Every ``threading.Thread(...)`` in the server/daemon modules
    (cluster/, core/) must spawn through a
    :class:`~ray_tpu_torch.cluster.threads.ThreadRegistry` — unregistered
    daemons outlive teardown silently and mutate half-torn-down state;
    the registry joins them BY NAME (threads.py itself is the one
    legitimate spawn site)."""
    for ts in prog.thread_spawns:
        if ts.path.endswith("cluster/threads.py") \
                or ts.path == "threads.py":
            continue
        yield Finding(
            "RC09", ts.path, ts.line,
            "threading.Thread() outside cluster/threads.py — "
            "server/daemon threads must spawn through a "
            "ThreadRegistry so teardown joins them by name instead "
            "of leaking them into the next test; if this thread's "
            "lifetime is genuinely bound to another resource (a "
            "connection, a child process), suppress with that reason")


# --------------------------------------------------------------------------
# RC10 — unbounded-queue
# --------------------------------------------------------------------------

# queue constructors whose bound is the FIRST positional / a keyword
_QUEUE_CLASSES = {
    "Queue": "maxsize",
    "LifoQueue": "maxsize",
    "PriorityQueue": "maxsize",
}


def _queue_ctor_name(node: ast.Call) -> Optional[str]:
    """'deque' / 'Queue' / 'SimpleQueue' / ... for a constructor call,
    whether imported bare (``deque(...)``) or qualified
    (``collections.deque(...)``, ``queue.Queue(...)``)."""
    fn = node.func
    name = None
    if isinstance(fn, ast.Name):
        name = fn.id
    elif isinstance(fn, ast.Attribute):
        name = fn.attr
    if name in _QUEUE_CLASSES or name in ("deque", "SimpleQueue"):
        return name
    return None


def check_rc10(sf: SourceFile) -> Iterator[Finding]:
    """Unbounded producer/consumer queues in the runtime's server and
    daemon modules are the raw material of metastable overload: under a
    stalled consumer they grow without limit, converting a transient
    slowdown into memory exhaustion and unbounded queueing delay
    (Bronson et al., HotOS '21). Every ``deque()`` / ``queue.Queue()``
    must carry an explicit bound (``maxlen=`` / ``maxsize=``);
    ``SimpleQueue`` cannot carry one and is always flagged. A queue
    bounded by an admission check elsewhere (shed-on-submit) carries a
    suppression naming that check."""
    for node in ast.walk(sf.tree):
        if not isinstance(node, ast.Call):
            continue
        name = _queue_ctor_name(node)
        if name is None:
            continue
        kwargs = {kw.arg for kw in node.keywords if kw.arg}
        if name == "deque":
            # deque(iterable, maxlen) — bounded via kwarg or 2nd arg
            if "maxlen" in kwargs or len(node.args) >= 2:
                continue
            fix = "give it maxlen=..."
        elif name == "SimpleQueue":
            fix = ("SimpleQueue has no bound at all — use "
                   "queue.Queue(maxsize=...)")
        else:
            # Queue/LifoQueue/PriorityQueue(maxsize=...) — a literal 0
            # (or omitted) means infinite
            bound = None
            if node.args:
                bound = node.args[0]
            for kw in node.keywords:
                if kw.arg == "maxsize":
                    bound = kw.value
            if bound is not None and not (
                    isinstance(bound, ast.Constant)
                    and bound.value in (0, None)):
                continue
            fix = "pass maxsize=..."
        yield Finding(
            "RC10", sf.relpath, node.lineno,
            f"unbounded {name}() in runtime code — under a stalled "
            f"consumer it grows without limit (queueing delay and "
            f"memory are the overload amplifiers); {fix}, or gate "
            f"every enqueue behind an admission check that sheds with "
            f"RetryLaterError and suppress with the check's name")


# --------------------------------------------------------------------------
# RC11 — batch-handler-dedupe
# --------------------------------------------------------------------------

_ROW_TOKEN_RE = re.compile(r"_row_token")


def check_rc11(sf: SourceFile) -> Iterator[Finding]:
    """Every public ``*_batch`` wire handler in the server modules
    applies a frame of rows that mutate cluster state. A frame retried
    after a dropped reply — or replayed by a GCS recovering its journal
    — re-delivers every row, so the handler must resolve rows against
    the per-row idempotence-token path (``_row_tokens_resolve`` on the
    GCS, ``_row_token_seen``/``_row_token_store`` on the raylet) before
    applying them; cached rows are re-answered, not re-applied. A
    handler whose rows are genuinely idempotent (kills: killing a dead
    actor is a no-op) carries a suppression saying exactly that."""
    for node in ast.walk(sf.tree):
        if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        if node.name.startswith("_") or not node.name.endswith("_batch"):
            continue
        has_token_path = False
        for inner in ast.walk(node):
            if not isinstance(inner, ast.Call):
                continue
            name = _terminal_name(inner.func)
            if name and _ROW_TOKEN_RE.search(name):
                has_token_path = True
                break
        if has_token_path:
            continue
        yield Finding(
            "RC11", sf.relpath, node.lineno,
            f"batch wire handler {node.name}() applies rows without a "
            f"per-row idempotence-token path — a frame retried after a "
            f"lost reply (or replayed by a restarted GCS) re-applies "
            f"every row, double-placing tasks or double-creating "
            f"actors; resolve the frame through _row_tokens_resolve() "
            f"/ _row_token_seen() and store accepted rows, or suppress "
            f"with the reason the rows are idempotent")


# --------------------------------------------------------------------------
# RC12 — resource-lifecycle (whole-program, flow-sensitive)
# --------------------------------------------------------------------------

# the runtime dirs whose acquire sites RC12 governs; corpus fixtures
# mirror the layout, so the same predicate scopes both
_RC12_DIRS = _in_dirs("cluster", "core", "serve", "observability",
                      "autoscaler", "scheduler")


def check_rc12(program) -> Iterator[Finding]:
    """Flow-sensitive leak detection: for every function in the runtime
    dirs, build a CFG (normal + exception edges) and run a may-hold
    dataflow over acquired resources (see :mod:`.cfg` for the
    acquire/release table and the ownership-transfer kills). A resource
    still live at a normal or exceptional exit on some path escaped
    without release or return-to-owner."""
    from ray_tpu_torch.tools.raycheck import cfg as _cfg

    for path in sorted(program.file_functions):
        if not _RC12_DIRS(path.split("/")):
            continue
        for fl in _cfg.analyze_functions(
                path, program.file_functions[path]):
            fn = fl.name.rsplit("::", 1)[-1]
            for leak in fl.leaks:
                how = ("on exception paths (a statement between "
                       "acquire and release can raise)"
                       if leak.exceptional else "on some path")
                yield Finding(
                    "RC12", path, leak.line,
                    f"{leak.kind} acquired into `{leak.var}` in "
                    f"{fn}() escapes {how} without release or "
                    f"return-to-owner — release it in a "
                    f"finally/with, hand it back to its pool, or "
                    f"store it on the owning object; if ownership "
                    f"genuinely transfers in a way the checker "
                    f"cannot see, suppress with the reason")


# --------------------------------------------------------------------------
# RC13 — protocol-state-machine (whole-program)
# --------------------------------------------------------------------------


def check_rc13(program) -> Iterator[Finding]:
    """Check the state machines declared in ``protocols.py`` (see
    :mod:`.protocols`) against themselves and against the phase-1 wire
    map: states must be declared/reachable, terminal states must be
    final, every non-initial non-terminal state needs a timeout/abort
    escape edge, wire drivers must resolve to a registered handler or
    ``@message`` schema, internal drivers to a function defined in the
    tree, and every op the conversation covers (explicitly or by
    ``<name>_`` prefix) must drive at least one edge."""
    decls = list(program.protocol_decls)
    if not decls:
        return
    wire_known = set(program.handler_map()) | set(program.schema_map())
    fn_names = program.function_names()
    for p in sorted(decls, key=lambda d: (d.path, d.line)):
        if p.malformed:
            yield Finding(
                "RC13", p.path, p.line,
                f"protocol {p.name or '<unnamed>'} is not statically "
                f"analyzable ({p.malformed}) — declare states, "
                f"transitions, and covers as plain literals so the "
                f"machine can be checked against the wire map")
            continue
        states = set(p.states)
        terminal = set(p.terminal)
        label = f"protocol {p.name}"
        for s in list(terminal) + ([p.initial] if p.initial else []):
            if s not in states:
                yield Finding(
                    "RC13", p.path, p.line,
                    f"{label}: state '{s}' (initial/terminal) is not "
                    f"in the declared state set")
        adj: dict = {s: set() for s in states}
        escapes_from: set = set()
        for t in p.transitions:
            for s in (t.src, t.dst):
                if s not in states:
                    yield Finding(
                        "RC13", p.path, t.line,
                        f"{label}: transition {t.src}→{t.dst} "
                        f"references undeclared state '{s}'")
            if t.src in terminal:
                yield Finding(
                    "RC13", p.path, t.line,
                    f"{label}: illegal transition out of terminal "
                    f"state '{t.src}' ({t.src}→{t.dst} via "
                    f"{t.driver}) — terminal means the conversation "
                    f"is over; add an explicit restart state if "
                    f"re-entry is real")
            if t.src in adj:
                adj[t.src].add(t.dst)
            if t.escape:
                escapes_from.add(t.src)
            if t.kind == "wire":
                if wire_known and t.driver not in wire_known:
                    yield Finding(
                        "RC13", p.path, t.line,
                        f"{label}: wire driver '{t.driver}' for "
                        f"{t.src}→{t.dst} resolves to no registered "
                        f"handler or @message schema — the declared "
                        f"conversation and the wire surface drifted")
            elif fn_names and t.driver not in fn_names:
                yield Finding(
                    "RC13", p.path, t.line,
                    f"{label}: internal driver '{t.driver}' for "
                    f"{t.src}→{t.dst} is not a function defined "
                    f"anywhere in the tree — the sweeper/deadline "
                    f"path this edge depends on does not exist")
        # reachability from the initial state
        if p.initial in states:
            seen = {p.initial}
            frontier = [p.initial]
            while frontier:
                cur = frontier.pop()
                for nxt in adj.get(cur, ()):
                    if nxt in states and nxt not in seen:
                        seen.add(nxt)
                        frontier.append(nxt)
            for s in sorted(states - seen):
                yield Finding(
                    "RC13", p.path, p.line,
                    f"{label}: state '{s}' is unreachable from "
                    f"initial state '{p.initial}' — dead protocol "
                    f"surface, or a missing transition")
        # every non-initial, non-terminal state must have an escape
        # edge: without one, a dead peer wedges the conversation there
        for s in sorted(states - terminal - {p.initial}):
            if s not in escapes_from:
                yield Finding(
                    "RC13", p.path, p.line,
                    f"{label}: state '{s}' has no timeout/abort "
                    f"escape edge — a peer dying mid-conversation "
                    f"wedges it there forever; add the "
                    f"sweep/deadline/abort transition and mark it "
                    f"escape=True")
        # coverage: declared covers + the op-name family must all
        # drive at least one edge
        drivers = {t.driver for t in p.transitions if t.kind == "wire"}
        for op in p.covers:
            if wire_known and op not in wire_known:
                yield Finding(
                    "RC13", p.path, p.line,
                    f"{label}: covered op '{op}' is not a registered "
                    f"handler or schema")
            if op not in drivers:
                yield Finding(
                    "RC13", p.path, p.line,
                    f"{label}: covered op '{op}' drives no declared "
                    f"transition — a message in the conversation the "
                    f"machine does not model")
        prefix = p.name + "_"
        for op in sorted(wire_known):
            if op.startswith(prefix) and op not in p.covers:
                yield Finding(
                    "RC13", p.path, p.line,
                    f"{label}: wire op '{op}' matches the "
                    f"conversation's name family but is not in "
                    f"covers — new messages must be placed in the "
                    f"state machine (or covered and given edges)")


# --------------------------------------------------------------------------
# RC14 — knob-hygiene (whole-program)
# --------------------------------------------------------------------------


def _read_text(path: str) -> Optional[str]:
    try:
        with open(path, "r", encoding="utf-8") as f:
            return f.read()
    except OSError:
        return None


def _find_aux(root: Optional[str], name: str) -> Optional[str]:
    """Locate ``name`` (a file or dir) at the scan root or one level
    up — the CLI scans the package dir, check.sh the repo root, and a
    corpus fixture is its own root."""
    if root is None:
        return None
    for base in (root, os.path.dirname(root)):
        cand = os.path.join(base, name)
        if os.path.exists(cand):
            return cand
    return None


def check_rc14(program) -> Iterator[Finding]:
    """Every ``Config`` knob must be (1) read somewhere outside its
    defining config.py — an unread knob is dead tuning surface that
    silently does nothing; (2) documented in the README knob tables;
    (3) exercised by at least one test that sets a non-default value.
    Checks (2)/(3) skip when the scan root has no README/tests beside
    it (single-file and bare-corpus scans)."""
    if not program.knobs:
        return
    # "read": the name appears outside the DEFINING file (serve's own
    # config.py is a legitimate reader of the global knobs), as an
    # identifier or as a string constant (the getattr-by-knob-name
    # idiom in the overload lane map)
    defining = {k.path for k in program.knobs}
    used_outside: dict = {p: set() for p in defining}
    for path in program.used_names_by_path:
        for def_path in defining:
            if path != def_path:
                used_outside[def_path] |= \
                    program.used_names_by_path[path]
                used_outside[def_path] |= \
                    program.used_strings_by_path.get(path, set())
    readme_path = _find_aux(program.root, "README.md")
    readme = _read_text(readme_path) if readme_path else None
    readme_words = set(re.findall(r"\w+", readme)) if readme else None
    tests_dir = _find_aux(program.root, "tests")
    tests_text = None
    if tests_dir and os.path.isdir(tests_dir):
        chunks = []
        for dirpath, dirnames, filenames in os.walk(tests_dir):
            dirnames[:] = [d for d in dirnames
                           if d != "__pycache__"
                           and not d.startswith(".")]
            for fname in filenames:
                if fname.endswith(".py"):
                    text = _read_text(os.path.join(dirpath, fname))
                    if text:
                        chunks.append(text)
        tests_text = "\n".join(chunks)
    tests_words = (set(re.findall(r"\w+", tests_text))
                   if tests_text else None)
    for knob in sorted(program.knobs, key=lambda k: (k.path, k.line)):
        if knob.name not in used_outside[knob.path]:
            yield Finding(
                "RC14", knob.path, knob.line,
                f"Config knob '{knob.name}' is never read outside "
                f"{knob.path} — dead tuning surface: wire it into the "
                f"code path it is meant to govern, or delete it")
        if readme_words is not None and knob.name not in readme_words:
            yield Finding(
                "RC14", knob.path, knob.line,
                f"Config knob '{knob.name}' is missing from the "
                f"README knob tables — document the default, the "
                f"unit, and what it governs")
        if tests_words is not None and knob.name not in tests_words:
            yield Finding(
                "RC14", knob.path, knob.line,
                f"Config knob '{knob.name}' is not exercised by any "
                f"test — add coverage that sets a non-default value "
                f"and observes the governed behavior")


# --------------------------------------------------------------------------
# RC15 — counter-hygiene (whole-program)
# --------------------------------------------------------------------------


def check_rc15(program) -> Iterator[Finding]:
    """Counters must round-trip: every ``.inc()`` site targets a metric
    registered in observability/metrics.py (a typo'd receiver silently
    counts into nothing via a registry miss or an AttributeError on a
    cold path); every registered metric is used outside the registry
    (dead metrics are dashboard noise); every dict-valued heartbeat
    stats field is rendered by ``cli.py status`` (stats shipped on
    every heartbeat but never shown are dead wire weight)."""
    metric_names = {m.name for m in program.metrics}
    if metric_names:
        for site in sorted(program.inc_sites,
                           key=lambda s: (s.path, s.line)):
            if not _RC12_DIRS(site.path.split("/")):
                continue
            if site.receiver not in metric_names:
                yield Finding(
                    "RC15", site.path, site.line,
                    f".inc() on '{site.receiver}' which is not a "
                    f"metric registered in the metrics module — "
                    f"register it (Counter/Gauge/Histogram) or fix "
                    f"the receiver name")
        used = program.names_used_outside("metrics")
        for m in sorted(program.metrics,
                        key=lambda m: (m.path, m.line)):
            if m.name not in used:
                yield Finding(
                    "RC15", m.path, m.line,
                    f"{m.kind} '{m.name}' is registered but never "
                    f"used outside {m.path} — dead metric: "
                    f"instrument the code path or delete the "
                    f"registration")
    hb = program.schema_map().get("heartbeat")
    cli_strings: set = set()
    has_cli = False
    for path, strings in program.used_strings_by_path.items():
        if path.rsplit("/", 1)[-1] == "cli.py":
            has_cli = True
            cli_strings |= strings
    if hb is not None and has_cli:
        for field in hb.fields:
            base = field.type.lower()
            if "dict" not in base:
                continue
            if field.name not in cli_strings:
                yield Finding(
                    "RC15", hb.path, field.line,
                    f"heartbeat stats field '{field.name}' is "
                    f"shipped on every heartbeat but never rendered "
                    f"by `cli.py status` — render it (or stop "
                    f"shipping it)")


# --------------------------------------------------------------------------
# registry
# --------------------------------------------------------------------------

_ANY = lambda parts: True  # noqa: E731 — program rules scope via facts

# serve/ joined the runtime scope with the serve resilience plane: its
# controller probe/drain loops, router, and replica shed path carry the
# same liveness/determinism obligations as cluster/ and core/
_RULES = [
    Rule("RC01", "lock-held-blocking",
         _in_dirs("cluster", "core", "serve"), check_rc01),
    Rule("RC02", "wall-clock-deadline",
         _in_dirs("cluster", "core", "scheduler", "serve"), check_rc02),
    Rule("RC03", "unseeded-randomness",
         _in_dirs("cluster", "scheduler"), check_rc03),
    Rule("RC04", "mutation-token",
         lambda parts: parts[-1] == "gcs_server.py", check_rc04),
    Rule("RC05", "swallowed-exception",
         _in_dirs("cluster", "core", "serve"), check_rc05),
    Rule("RC06", "wire-method-resolution", _ANY, check_rc06,
         program=True),
    Rule("RC07", "wire-schema-conformance", _ANY, check_rc07,
         program=True),
    Rule("RC08", "lock-order-cycle", _ANY, check_rc08, program=True),
    Rule("RC09", "unmanaged-thread", _ANY, check_rc09, program=True),
    Rule("RC10", "unbounded-queue",
         _in_dirs("cluster", "core", "serve"), check_rc10),
    Rule("RC11", "batch-handler-dedupe",
         lambda parts: parts[-1] in ("gcs_server.py",
                                     "raylet_server.py"), check_rc11),
    Rule("RC12", "resource-lifecycle", _ANY, check_rc12, program=True),
    Rule("RC13", "protocol-state-machine", _ANY, check_rc13,
         program=True),
    Rule("RC14", "knob-hygiene", _ANY, check_rc14, program=True),
    Rule("RC15", "counter-hygiene", _ANY, check_rc15, program=True),
    Rule("RC16", "guarded-by-data-race", _ANY, _races.check_rc16,
         program=True),
    Rule("RC17", "unbounded-blocking", _ANY, _races.check_rc17,
         program=True),
]


def all_rules() -> List[Rule]:
    return list(_RULES)
