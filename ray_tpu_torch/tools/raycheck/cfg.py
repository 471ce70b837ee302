"""Per-function control-flow graphs + the RC12 resource-lifecycle
dataflow (raycheck phase-1.5: flow-sensitive, where RC01–RC11 are
pattern- or join-shaped).

The runtime acquires real kernel and owner-managed resources on its hot
paths — sockets and pipe fds in the RPC substrate, mmap'd shm segments
in the byte store, worker-pool leases, ThreadRegistry handles,
dedupe-window reservations, device buffers behind the scheduler's
``DeviceMatrixMirror``. A resource acquired into a local and dropped on
an early ``return`` — or, the classic shape, leaked when the statement
*between* acquire and release raises — is invisible to per-line
pattern rules: the defect is a *path*, not a statement. So RC12 builds
a statement-level CFG per function (normal edges AND exception edges:
any statement inside a ``try`` may transfer to its handlers/finally,
any statement outside one may exit the function exceptionally) and runs
a forward may-hold dataflow over it (reference posture: this is the
static half of what LSAN/ASAN's leak checking sees at runtime in the
C++ raylet's CI).

Ownership model (deliberately lenient — the goal is real leaks, not a
borrow checker):

* **gen** — a call whose terminal callee name is in the resource table
  (or in a module-local function summary, see below) assigned to plain
  name(s): ``s = socket.create_connection(...)``,
  ``r, w = os.pipe()``.
* **kill** — any of: a release-method call on the resource
  (``s.close()``); passing the resource as an argument to ANY call
  (ownership transfer: ``self._pool._release(w)``,
  ``os.close(fd)``, ``closing(s)``); storing it into an attribute /
  subscript / container (return-to-owner: ``self._sock = s``);
  ``return``/``yield``-ing it (transfer to caller); ``del``;
  rebinding the name; using it as a ``with`` context manager. Kinds
  with ``release_any`` additionally kill on a *bare call by name*
  anywhere on the path (the shm pin / dedupe-window shape, where the
  release call names the object id, not the handle variable).
* acquisitions inside a ``with`` item never gen (the context manager
  owns the release on every edge).

A resource still live at the function's normal or exceptional exit on
SOME path is a finding at its acquire line. Interprocedural summaries
close the module-local wrapper gap: a function that acquires and
*returns* a resource makes its callers (``self.method()`` / bare-name
calls in the same file) acquirers of the same kind, to a fixpoint.
"""

from __future__ import annotations

import ast
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional, Set, Tuple

__all__ = [
    "RESOURCE_KINDS",
    "ResourceKind",
    "FunctionLeaks",
    "Leak",
    "Node",
    "build_cfg",
    "analyze_functions",
]


# --------------------------------------------------------------------------
# the resource table
# --------------------------------------------------------------------------


@dataclass(frozen=True)
class ResourceKind:
    """One acquire/release pairing the dataflow tracks.

    ``acquire`` — terminal callee names whose call result IS the
    resource. ``release_methods`` — method names on the resource that
    end its lifetime. ``release_any`` — function/method names whose
    mere call (any receiver, any args) releases every live resource of
    this kind in the function: the shm-pin / dedupe-window shape where
    release is keyed by object id or token, not by the handle
    variable."""
    name: str
    acquire: Tuple[str, ...]
    release_methods: Tuple[str, ...] = ()
    release_any: Tuple[str, ...] = ()


RESOURCE_KINDS: Tuple[ResourceKind, ...] = (
    # kernel fds: the RPC substrate's sockets, train's rendezvous
    # socket, the worker pipe pair
    ResourceKind("socket", ("create_connection", "socket"),
                 release_methods=("close", "detach", "shutdown")),
    ResourceKind("pipe/file fd", ("pipe", "open", "fdopen", "dup"),
                 release_methods=("close", "detach")),
    ResourceKind("mmap", ("mmap",), release_methods=("close",)),
    # byte-store shm segments: ShmStore() maps a segment + fd + mmap;
    # close() unmaps all three (and unlinks when owner)
    ResourceKind("shm segment", ("ShmStore",),
                 release_methods=("close",)),
    # shm pins: get_buffer/pin_region pin the block until
    # store.release(object_id) — release is keyed by object id, so a
    # bare `.release(...)` call on the path counts
    ResourceKind("shm pin", ("get_buffer", "pin_region"),
                 release_any=("release",)),
    # worker-pool leases: a popped WorkerProcess must flow back through
    # _release/_return (transfer-kill) or be stored on the owner
    ResourceKind("worker-pool lease", ("_lease", "_warm_lease"),
                 release_methods=("kill", "terminate")),
    # ThreadRegistry: the registry handle owns named daemon threads;
    # join_all is the observable teardown
    ResourceKind("thread registry", ("ThreadRegistry",),
                 release_methods=("join_all",)),
    # dedupe-window reservations: rows resolved against the per-row
    # token window must be stored back (or answered from cache) —
    # resolving and dropping the pending rows silently disables the
    # exactly-once replay path
    ResourceKind("dedupe-window reservation",
                 ("_row_tokens_resolve",),
                 release_any=("_row_tokens_store", "_row_token_store")),
    # device buffers held by the scheduler's mirror: close/invalidate
    # returns them to the allocator
    ResourceKind("device-mirror buffer", ("DeviceMatrixMirror",),
                 release_methods=("close", "invalidate", "reset")),
)

_ACQUIRE_TO_KIND: Dict[str, ResourceKind] = {
    name: kind for kind in RESOURCE_KINDS for name in kind.acquire}

# release_any names, joined across kinds, checked per-kind at kill time
_RELEASE_ANY: Dict[str, Tuple[str, ...]] = {
    kind.name: kind.release_any for kind in RESOURCE_KINDS}


def _terminal_name(node: ast.AST) -> Optional[str]:
    if isinstance(node, ast.Name):
        return node.id
    if isinstance(node, ast.Attribute):
        return node.attr
    if isinstance(node, ast.Call):
        return _terminal_name(node.func)
    return None


# --------------------------------------------------------------------------
# the CFG
# --------------------------------------------------------------------------


class Node:
    """One statement-level CFG node. ``succ`` are normal-flow
    successors; ``exc`` are exception successors (the innermost
    enclosing handler/finally entries, or the function's exceptional
    exit). Sentinel nodes (entry/exit/exc_exit/join) carry no stmt.
    ``refine`` — branch-refinement pseudo-nodes carry (var, kill):
    entering this edge proves ``var`` is None (kill=True) or not-None
    (kill=False), from an ``if var is [not] None`` test."""

    __slots__ = ("stmt", "succ", "exc", "label", "refine")

    def __init__(self, stmt: Optional[ast.stmt] = None,
                 label: str = "stmt"):
        self.stmt = stmt
        self.succ: List["Node"] = []
        self.exc: List["Node"] = []
        self.label = label
        self.refine: Optional[Tuple[str, bool]] = None

    def __repr__(self) -> str:  # pragma: no cover - debug aid
        line = getattr(self.stmt, "lineno", "-")
        return f"<Node {self.label}:{line}>"


@dataclass
class Cfg:
    entry: Node
    exit: Node          # normal return / fall-off-the-end
    exc_exit: Node      # uncaught exception propagates to the caller
    nodes: List[Node] = field(default_factory=list)


class _Builder:
    """Builds a statement-level CFG for one function body.

    ``finally`` is modeled without block duplication: exceptional flow
    is routed through the same finally nodes and then to BOTH the
    normal continuation and the propagation target. The extra
    normal-continuation path is a may-analysis over-approximation — it
    only matters if it reaches an exit with a live resource, and a
    correct finally released it."""

    def __init__(self) -> None:
        self.exit = Node(label="exit")
        self.exc_exit = Node(label="exc_exit")
        self.nodes: List[Node] = [self.exit, self.exc_exit]

    def _node(self, stmt: Optional[ast.stmt], label: str = "stmt") -> Node:
        n = Node(stmt, label)
        self.nodes.append(n)
        return n

    def build(self, body: List[ast.stmt]) -> Cfg:
        entry = self._node(None, "entry")
        exits = self._body(body, [entry], [self.exc_exit], None, None)
        for n in exits:
            n.succ.append(self.exit)
        return Cfg(entry, self.exit, self.exc_exit, self.nodes)

    # ``preds`` — nodes whose normal flow enters the construct;
    # returns the nodes whose normal flow leaves it.
    def _body(self, stmts: List[ast.stmt], preds: List[Node],
              exc: List[Node], brk: Optional[Node],
              cont: Optional[Node]) -> List[Node]:
        cur = preds
        for stmt in stmts:
            cur = self._stmt(stmt, cur, exc, brk, cont)
            if not cur:   # unreachable code after return/raise/...
                break
        return cur

    def _link(self, preds: List[Node], node: Node) -> None:
        for p in preds:
            node not in p.succ and p.succ.append(node)

    def _stmt(self, stmt: ast.stmt, preds: List[Node], exc: List[Node],
              brk: Optional[Node], cont: Optional[Node]) -> List[Node]:
        if isinstance(stmt, ast.If):
            test = self._node(stmt, "if")
            self._link(preds, test)
            if _expr_can_raise(stmt.test):
                test.exc = list(exc)
            # None-refinement: `if var is None:` proves the acquire
            # returned nothing on the true branch (the get_buffer /
            # attach-miss guard shape), and vice versa for `is not`
            t_pred, f_pred = [test], [test]
            ref = _none_test(stmt.test)
            if ref is not None:
                var, is_none = ref
                t_node = self._node(None, "assume")
                t_node.refine = (var, is_none)
                f_node = self._node(None, "assume")
                f_node.refine = (var, not is_none)
                self._link([test], t_node)
                self._link([test], f_node)
                t_pred, f_pred = [t_node], [f_node]
            t = self._body(stmt.body, t_pred, exc, brk, cont)
            f = (self._body(stmt.orelse, f_pred, exc, brk, cont)
                 if stmt.orelse else f_pred)
            return t + f
        if isinstance(stmt, (ast.While, ast.For, ast.AsyncFor)):
            head = self._node(stmt, "loop")
            self._link(preds, head)
            if isinstance(stmt, ast.While) \
                    and not _expr_can_raise(stmt.test):
                pass   # `while True:` / `while flag:` heads don't raise
            else:
                head.exc = list(exc)
            after: List[Node] = [head]   # loop may run zero times
            body_exits = self._body(stmt.body, [head], exc,
                                    brk=head, cont=head)
            for n in body_exits:
                n.succ.append(head)      # back edge
            if stmt.orelse:
                after = self._body(stmt.orelse, after, exc, brk, cont)
            return after
        if isinstance(stmt, (ast.Try, getattr(ast, "TryStar", ast.Try))):
            return self._try(stmt, preds, exc, brk, cont)
        if isinstance(stmt, (ast.With, ast.AsyncWith)):
            head = self._node(stmt, "with")
            self._link(preds, head)
            head.exc = list(exc)
            # the with body's exceptions unwind through __exit__ then
            # propagate to the enclosing target
            return self._body(stmt.body, [head], exc, brk, cont)
        if isinstance(stmt, (ast.Return, ast.Raise)):
            node = self._node(stmt, "return" if isinstance(
                stmt, ast.Return) else "raise")
            self._link(preds, node)
            node.exc = list(exc)
            if isinstance(stmt, ast.Return):
                node.succ.append(self.exit)
            else:
                for t in exc:
                    node.succ.append(t)
            return []
        if isinstance(stmt, ast.Break):
            node = self._node(stmt, "break")
            self._link(preds, node)
            # break target's *after* set is resolved by the loop head
            # approximation: flow back to the loop head, whose normal
            # successors include everything after the loop
            if brk is not None:
                node.succ.append(brk)
            return []
        if isinstance(stmt, ast.Continue):
            node = self._node(stmt, "continue")
            self._link(preds, node)
            if cont is not None:
                node.succ.append(cont)
            return []
        # plain statement (expr, assign, del, assert, import, ...)
        node = self._node(stmt)
        self._link(preds, node)
        if _can_raise(stmt):
            node.exc = list(exc)
        return [node]

    def _try(self, stmt: ast.Try, preds: List[Node], exc: List[Node],
             brk: Optional[Node], cont: Optional[Node]) -> List[Node]:
        # entries the try body's exceptions transfer to: every handler,
        # plus the finally (when present), plus — for re-raise after
        # unmatched handlers — the outer target
        handler_entries: List[Node] = []
        handler_nodes: List[Tuple[Node, ast.ExceptHandler]] = []
        for h in stmt.handlers:
            hn = self._node(h, "except")
            handler_entries.append(hn)
            handler_nodes.append((hn, h))

        fin_entry: Optional[Node] = None
        if stmt.finalbody:
            fin_entry = self._node(None, "finally")

        # an exception from the body enters a handler, or — when no
        # handler matches (or none exist) — unwinds through the finally
        # when present, else propagates to the outer target. It never
        # bypasses an existing finally.
        body_exc = handler_entries + (
            [fin_entry] if fin_entry else list(exc))
        body_exits = self._body(stmt.body, preds, body_exc, brk, cont)
        if stmt.orelse:
            body_exits = self._body(stmt.orelse, body_exits, body_exc,
                                    brk, cont)

        all_exits: List[Node] = list(body_exits)
        for hn, h in handler_nodes:
            h_exc = ([fin_entry] if fin_entry else []) + list(exc)
            hn.exc = h_exc
            all_exits += self._body(h.body, [hn], h_exc, brk, cont)

        if fin_entry is None:
            return all_exits
        self._link(all_exits, fin_entry)
        fin_exits = self._body(stmt.finalbody, [fin_entry], exc, brk,
                               cont)
        # finally completes: normal continuation AND (for the
        # exceptional entry) propagation outward
        for n in fin_exits:
            for t in exc:
                t not in n.succ and n.succ.append(t)
        return fin_exits


def _none_test(test: ast.AST) -> Optional[Tuple[str, bool]]:
    """``var is None`` → (var, True); ``var is not None`` →
    (var, False); anything else → None."""
    if isinstance(test, ast.Compare) \
            and isinstance(test.left, ast.Name) \
            and len(test.ops) == 1 \
            and isinstance(test.ops[0], (ast.Is, ast.IsNot)) \
            and isinstance(test.comparators[0], ast.Constant) \
            and test.comparators[0].value is None:
        return test.left.id, isinstance(test.ops[0], ast.Is)
    return None


# expression kinds that cannot realistically raise: names, attribute
# loads on bound objects, constants, tuples, additive arithmetic,
# comparisons. Calls, subscripts, division, and await/yield can.
_SAFE_EXPRS = (ast.Name, ast.Attribute, ast.Constant, ast.Tuple,
               ast.List, ast.UnaryOp, ast.BoolOp, ast.Compare,
               ast.Load, ast.Store, ast.Del, ast.And, ast.Or,
               ast.Not, ast.USub, ast.UAdd, ast.Eq, ast.NotEq,
               ast.Lt, ast.LtE, ast.Gt, ast.GtE, ast.Is, ast.IsNot,
               ast.In, ast.NotIn, ast.Add, ast.Sub, ast.Mult,
               ast.expr_context, ast.boolop, ast.operator,
               ast.unaryop, ast.cmpop)


def _expr_can_raise(expr: ast.AST) -> bool:
    """True unless every subexpression is a safe load/arith node —
    names, attribute loads, constants, comparisons, additive
    arithmetic. Calls, subscripts, division, and f-strings can
    raise."""
    for node in ast.walk(expr):
        if isinstance(node, ast.BinOp):
            if not isinstance(node.op, (ast.Add, ast.Sub, ast.Mult)):
                return True
            continue
        if not isinstance(node, _SAFE_EXPRS):
            return True
    return False


def _can_raise(stmt: ast.stmt) -> bool:
    """False only for trivially non-raising statements (``x = y``,
    ``self.total += n``, ``flag = a and not b``): every subexpression
    is a safe load/arith node. Anything containing a call, subscript,
    division, or f-string keeps its exception edge."""
    if not isinstance(stmt, (ast.Assign, ast.AugAssign, ast.AnnAssign,
                             ast.Expr, ast.Pass)):
        return True
    for node in ast.walk(stmt):
        if node is stmt:
            continue
        if isinstance(node, ast.BinOp):
            if not isinstance(node.op, (ast.Add, ast.Sub, ast.Mult)):
                return True
            continue
        if not isinstance(node, _SAFE_EXPRS):
            return True
    return False


def build_cfg(fndef: ast.AST) -> Cfg:
    """Statement-level CFG (with exception edges) for one function."""
    return _Builder().build(list(fndef.body))


# --------------------------------------------------------------------------
# the may-hold dataflow
# --------------------------------------------------------------------------


@dataclass(frozen=True)
class Leak:
    var: str
    kind: str
    line: int           # acquire line
    exceptional: bool   # leak path reaches the exceptional exit only


@dataclass
class FunctionLeaks:
    path: str
    name: str
    leaks: List[Leak]


_FN_BOUNDARY = (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda,
                ast.ClassDef)


def _own_walk(node: ast.AST) -> Iterable[ast.AST]:
    """ast.walk pruned at nested function/class boundaries (their
    bodies run later, under their own CFG)."""
    stack = [node]
    while stack:
        n = stack.pop()
        yield n
        for c in ast.iter_child_nodes(n):
            if not isinstance(c, _FN_BOUNDARY):
                stack.append(c)


class _Dataflow:
    """Forward may-hold analysis over one CFG. State: frozenset of
    (var, rid) aliases; ``rid`` identifies one acquire site. A rid
    live at an exit node on any path is a leak at its acquire line."""

    def __init__(self, path: str, fndef: ast.AST,
                 acquire_to_kind: Dict[str, ResourceKind]):
        self.path = path
        self.fndef = fndef
        self.acquires = acquire_to_kind
        self.rid_info: Dict[int, Tuple[str, int]] = {}  # rid->(kind,line)
        self._next_rid = 0

    # -- expression helpers ------------------------------------------------
    def _acquire_kind(self, value: ast.AST) -> Optional[ResourceKind]:
        if not isinstance(value, ast.Call):
            return None
        name = _terminal_name(value.func)
        return self.acquires.get(name) if name else None

    def _vars_passed_to_calls(self, stmt: ast.stmt) -> Set[str]:
        out: Set[str] = set()
        for node in _own_walk(stmt):
            if isinstance(node, ast.Call):
                for a in list(node.args) + [k.value for k in
                                            node.keywords]:
                    for sub in ast.walk(a):
                        if isinstance(sub, ast.Name):
                            out.add(sub.id)
        return out

    def _release_method_receivers(self, stmt: ast.stmt) -> Set[Tuple[str, str]]:
        """(var, method) pairs for ``var.method(...)`` calls."""
        out: Set[Tuple[str, str]] = set()
        for node in _own_walk(stmt):
            if isinstance(node, ast.Call) \
                    and isinstance(node.func, ast.Attribute) \
                    and isinstance(node.func.value, ast.Name):
                out.add((node.func.value.id, node.func.attr))
        return out

    def _called_names(self, stmt: ast.stmt) -> Set[str]:
        out: Set[str] = set()
        for node in _own_walk(stmt):
            if isinstance(node, ast.Call):
                name = _terminal_name(node.func)
                if name:
                    out.add(name)
        return out

    # -- transfer ----------------------------------------------------------
    def transfer(self, node: Node, state: frozenset,
                 gen: bool = True) -> frozenset:
        """Post-state of ``node``. With ``gen=False``, apply kills only
        — the exception-edge semantics: a statement that raises may
        still have completed its release/ownership transfer (a close()
        that raises still closed; a callee that raises still received
        the resource), but an acquire whose statement raised never
        bound the name."""
        stmt = node.stmt
        if stmt is None:
            if node.refine is not None and node.refine[1]:
                # the `is None` branch: the acquire returned nothing
                var = node.refine[0]
                return frozenset(p for p in state if p[0] != var)
            return state
        aliases = set(state)

        def kill_rid(rid: int) -> None:
            for pair in [p for p in aliases if p[1] == rid]:
                aliases.discard(pair)

        def kill_var(var: str) -> None:
            for pair in [p for p in aliases if p[0] == var]:
                aliases.discard(pair)

        def rids_of(var: str) -> List[int]:
            return [rid for v, rid in aliases if v == var]

        # 1. releases: var.release_method() / release_any-by-kind /
        #    passing the var to any call (ownership transfer)
        for var, meth in self._release_method_receivers(stmt):
            for rid in rids_of(var):
                kind, _ = self.rid_info[rid]
                spec = next(k for k in RESOURCE_KINDS if k.name == kind)
                if meth in spec.release_methods:
                    kill_rid(rid)
        called = self._called_names(stmt)
        for v, rid in list(aliases):
            kind, _ = self.rid_info[rid]
            if any(name in called for name in _RELEASE_ANY.get(kind, ())):
                kill_rid(rid)
        for var in self._vars_passed_to_calls(stmt):
            for rid in rids_of(var):
                kill_rid(rid)

        # 2. transfer to caller / owner: return, yield, attribute or
        #    subscript store, container literal in an assignment value,
        #    with-context use, del
        if isinstance(stmt, ast.Return) and stmt.value is not None:
            for n in ast.walk(stmt.value):
                if isinstance(n, ast.Name):
                    for rid in rids_of(n.id):
                        kill_rid(rid)
        for n in _own_walk(stmt):
            if isinstance(n, (ast.Yield, ast.YieldFrom)) \
                    and n.value is not None:
                for sub in ast.walk(n.value):
                    if isinstance(sub, ast.Name):
                        for rid in rids_of(sub.id):
                            kill_rid(rid)
        if isinstance(stmt, (ast.Assign, ast.AnnAssign, ast.AugAssign)):
            targets = (stmt.targets if isinstance(stmt, ast.Assign)
                       else [stmt.target])
            stores_to_owner = any(
                isinstance(t, (ast.Attribute, ast.Subscript))
                or any(isinstance(s, (ast.Attribute, ast.Subscript))
                       for s in ast.walk(t))
                for t in targets)
            value = getattr(stmt, "value", None)
            if value is not None:
                for sub in ast.walk(value):
                    if isinstance(sub, ast.Name) and (
                            stores_to_owner
                            or isinstance(value, (ast.List, ast.Tuple,
                                                  ast.Dict, ast.Set))):
                        for rid in rids_of(sub.id):
                            kill_rid(rid)
        if isinstance(stmt, (ast.With, ast.AsyncWith)):
            for item in stmt.items:
                for sub in ast.walk(item.context_expr):
                    if isinstance(sub, ast.Name):
                        for rid in rids_of(sub.id):
                            kill_rid(rid)
        if isinstance(stmt, ast.Delete):
            for t in stmt.targets:
                if isinstance(t, ast.Name):
                    for rid in rids_of(t.id):
                        kill_rid(rid)

        # 3. gen: acquire call assigned to plain name(s). Aliasing
        #    (`y = x`) maps the new name onto the same rid.
        if gen and isinstance(stmt, ast.Assign) \
                and len(stmt.targets) == 1:
            target = stmt.targets[0]
            value = stmt.value
            if isinstance(target, ast.Name):
                if isinstance(value, ast.Name):
                    src_rids = rids_of(value.id)
                    kill_var(target.id)
                    for rid in src_rids:
                        aliases.add((target.id, rid))
                else:
                    kind = self._acquire_kind(value)
                    kill_var(target.id)
                    if kind is not None:
                        rid = self._rid(kind.name, stmt.lineno)
                        aliases.add((target.id, rid))
            elif isinstance(target, (ast.Tuple, ast.List)):
                kind = self._acquire_kind(value)
                for elt in target.elts:
                    if isinstance(elt, ast.Name):
                        kill_var(elt.id)
                        if kind is not None:
                            rid = self._rid(kind.name, stmt.lineno)
                            aliases.add((elt.id, rid))
        return frozenset(aliases)

    def _rid(self, kind: str, line: int) -> int:
        # one rid per (kind, line): re-executions of the same acquire
        # statement (loops) merge into one tracked resource
        for rid, info in self.rid_info.items():
            if info == (kind, line):
                return rid
        rid = self._next_rid
        self._next_rid += 1
        self.rid_info[rid] = (kind, line)
        return rid

    # -- fixpoint ----------------------------------------------------------
    def run(self) -> List[Leak]:
        cfg = build_cfg(self.fndef)
        in_state: Dict[int, Set[frozenset]] = {id(n): set()
                                               for n in cfg.nodes}
        in_state[id(cfg.entry)] = {frozenset()}
        work = [cfg.entry]
        # per-node union of reachable states, propagated to fixpoint;
        # states are small (few live resources), functions are small —
        # convergence is fast in practice
        guard = 0
        while work and guard < 20000:
            guard += 1
            node = work.pop()
            for st in list(in_state[id(node)]):
                out = self.transfer(node, st)
                exc_out = self.transfer(node, st, gen=False)
                for succ in node.succ:
                    if out not in in_state[id(succ)]:
                        in_state[id(succ)].add(out)
                        work.append(succ)
                for succ in node.exc:
                    if exc_out not in in_state[id(succ)]:
                        in_state[id(succ)].add(exc_out)
                        work.append(succ)
        leaks: Dict[int, bool] = {}   # rid -> leaked-on-normal-exit?
        for exit_node, exceptional in ((cfg.exit, False),
                                       (cfg.exc_exit, True)):
            for st in in_state[id(exit_node)]:
                for var, rid in st:
                    if not exceptional:
                        leaks[rid] = True
                    else:
                        leaks.setdefault(rid, False)
        out: List[Leak] = []
        seen_lines: Set[Tuple[int, str]] = set()
        for rid, on_normal in sorted(leaks.items()):
            kind, line = self.rid_info[rid]
            var = self._var_for(rid, in_state)
            key = (line, kind)
            if key in seen_lines:
                continue
            seen_lines.add(key)
            out.append(Leak(var, kind, line, exceptional=not on_normal))
        return out

    def _var_for(self, rid: int,
                 in_state: Dict[int, Set[frozenset]]) -> str:
        for states in in_state.values():
            for st in states:
                for var, r in st:
                    if r == rid:
                        return var
        return "?"


# --------------------------------------------------------------------------
# interprocedural summaries + the per-file entry point
# --------------------------------------------------------------------------


def _returns_acquired(fndef: ast.AST,
                      acquires: Dict[str, ResourceKind]) -> Optional[ResourceKind]:
    """Does ``fndef`` acquire a resource and return it (possibly via a
    local)? Then calling it IS an acquire of that kind.

    Statements are walked in source order, and a var stored into an
    attribute/subscript target BEFORE the return is dropped from the
    acquired set: a function that parks the handle in a module cache or
    on ``self`` and then returns it is lending a reference the owner
    still tracks, not transferring fresh ownership (the ``attach_shm``
    shape)."""
    acquired_vars: Dict[str, ResourceKind] = {}
    for node in _ordered_stmts(fndef.body):
        if isinstance(node, ast.Assign):
            # store-to-owner: `self._x = seg` / `_cache[k] = seg`
            if any(isinstance(t, (ast.Attribute, ast.Subscript))
                   for t in node.targets):
                for sub in ast.walk(node.value):
                    if isinstance(sub, ast.Name):
                        acquired_vars.pop(sub.id, None)
            elif len(node.targets) == 1 \
                    and isinstance(node.targets[0], ast.Name) \
                    and isinstance(node.value, ast.Call):
                name = _terminal_name(node.value.func)
                kind = acquires.get(name) if name else None
                if kind is not None:
                    acquired_vars[node.targets[0].id] = kind
                else:
                    acquired_vars.pop(node.targets[0].id, None)
        if isinstance(node, ast.Return) and node.value is not None:
            if isinstance(node.value, ast.Call):
                name = _terminal_name(node.value.func)
                kind = acquires.get(name) if name else None
                if kind is not None:
                    return kind
            if isinstance(node.value, ast.Name) \
                    and node.value.id in acquired_vars:
                return acquired_vars[node.value.id]
    return None


def _ordered_stmts(body: List[ast.stmt]) -> Iterable[ast.stmt]:
    """Statements in source order, recursing into compound-statement
    bodies but not nested function/class definitions (the ordering
    _own_walk's LIFO stack does not give)."""
    for stmt in body:
        yield stmt
        if isinstance(stmt, _FN_BOUNDARY):
            continue
        for attr in ("body", "orelse", "finalbody"):
            sub = getattr(stmt, attr, None)
            if sub:
                yield from _ordered_stmts(sub)
        for handler in getattr(stmt, "handlers", ()) or ():
            yield from _ordered_stmts(handler.body)


def analyze_functions(path: str,
                      functions: Dict[str, Tuple[Optional[str], ast.AST]],
                      ) -> List[FunctionLeaks]:
    """RC12 over one file's functions (``functions`` as extracted by
    facts._FileFacts: fid -> (class, fndef)). Module-local summaries:
    wrappers that acquire-and-return become acquirers for their
    callers, to a fixpoint."""
    acquires = dict(_ACQUIRE_TO_KIND)
    # fixpoint over module-local acquire summaries (a wrapper of a
    # wrapper still counts)
    for _ in range(4):
        grew = False
        for fid, (_cls, fndef) in functions.items():
            kind = _returns_acquired(fndef, acquires)
            fname = fid.rsplit(".", 1)[-1].split("::")[-1]
            if kind is not None and fname not in acquires:
                acquires[fname] = kind
                grew = True
        if not grew:
            break
    out: List[FunctionLeaks] = []
    for fid, (_cls, fndef) in sorted(functions.items()):
        # a function that acquires-and-returns hands ownership to its
        # caller by design; its own exit-with-live-resource is the
        # return statement, already killed by the transfer rule
        flow = _Dataflow(path, fndef, acquires)
        leaks = flow.run()
        if leaks:
            out.append(FunctionLeaks(path, fid, leaks))
    return out
