"""Whole-program fact extraction — phase 1 of raycheck's RC06–RC09.

The per-file rules (RC01–RC05) check invariants a single AST can
witness. The wire-protocol and lock-order invariants cannot be seen
from one file: a ``client.call("actor_create", ...)`` site in
``process_cluster.py`` is only correct relative to the handler
registered in ``gcs_server.serve()`` and the ``@message`` schema in
``cluster/schema.py``, and a lock-order deadlock needs the acquisition
edges of *both* participating code paths. So the analysis is split:

* **Phase 1 (this module)** walks every parsed file once and extracts
  facts — :class:`CallSite`, :class:`Handler`, :class:`SchemaDef`,
  the inter-procedural lock-acquisition graph (:class:`LockEdge`), and
  :class:`ThreadSpawn` sites — into a :class:`Program`.
* **Phase 2** (the RC06–RC09 rules in :mod:`.rules`) joins facts across
  files and reports violations.

Analysis boundaries (deliberate, documented over-approximations):

* A ``.call("name", ...)`` site participates in the wire analysis only
  when it is *wire-shaped* (a literal method name and keyword-only
  arguments — the :class:`~ray_tpu_torch.cluster.rpc.RpcClient` signature)
  AND the receiver's name looks like an RPC client (``gcs``,
  ``client``, ``peer``, ``hb``, ...). This keeps the serve
  ``ControllerRef.call(method, *args)`` actor surface and the
  process-pool pipe protocol (``worker.call("task", {...})``) out of
  the join.
* Lock identities are qualified per file and class
  (``cluster/gcs_server.py::GcsService._lock``); a
  ``threading.Condition(self._lock)`` aliases to its underlying lock.
  Call edges resolve module-locally (``self.method()`` and bare
  module functions); cross-module attribute calls are not followed —
  a cycle spanning that boundary needs a runtime detector, not this
  checker. Self-edges (re-acquiring the lock you hold) are ignored:
  the runtime's state locks are reentrant by convention (RLock /
  Condition), and reentrancy is not an ordering violation.
"""

from __future__ import annotations

import ast
import re
from dataclasses import dataclass
from typing import Dict, Iterable, List, Optional, Set, Tuple

__all__ = [
    "CallSite",
    "FieldAccess",
    "Handler",
    "IncSite",
    "KnobDef",
    "LockEdge",
    "MetricDef",
    "Program",
    "ProtocolDecl",
    "SchemaDef",
    "SchemaField",
    "ThreadRoot",
    "ThreadSpawn",
    "TransitionDecl",
    "WaitSite",
    "type_compatible",
]


# --------------------------------------------------------------------------
# shared AST helpers (kept local: rules.py imports facts, not vice versa)
# --------------------------------------------------------------------------


def _terminal_name(node: ast.AST) -> Optional[str]:
    if isinstance(node, ast.Name):
        return node.id
    if isinstance(node, ast.Attribute):
        return node.attr
    if isinstance(node, ast.Call):
        return _terminal_name(node.func)
    return None


_FN_BOUNDARY = (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda,
                ast.ClassDef)


class _NotLiteral(Exception):
    """A protocols.py declaration field that is not a plain literal —
    the machine cannot be checked statically, which RC13 reports."""


# --------------------------------------------------------------------------
# wire facts: call sites, handlers, schemas
# --------------------------------------------------------------------------

WIRE_CALL_ATTRS = {"call", "call_async", "call_stream"}

# Receiver-name heuristic separating RPC-substrate clients from the
# other ``.call`` surfaces in the tree (serve's ControllerRef takes
# positional args; the process-pool pipe protocol passes a payload
# dict). Matched against the receiver expression's terminal name.
_WIRE_RECEIVER_RE = re.compile(
    r"gcs|client|peer|raylet|rpc|reap|^hb$|^c$|^srv$")

# kwargs consumed client-side before the frame is built (RpcClient.call
# signature); never part of the wire schema
CLIENT_KWARGS = frozenset({"timeout"})


@dataclass(frozen=True)
class CallSite:
    path: str
    line: int
    method: str
    kind: str              # "call" | "call_async" | "call_stream"
    keys: Tuple[str, ...]  # literal kwarg names (client kwargs included)
    splat: bool            # a **kwargs splat defeats field checks
    consts: Tuple[Tuple[str, str], ...]  # (kwarg, literal type name)
    receiver: str
    wire: bool             # wire-shaped AND wire-named receiver


@dataclass(frozen=True)
class Handler:
    path: str
    line: int
    method: str
    server: str            # "gcs_server.GcsService"-style owner label
    is_stream: bool
    resolved: bool         # signature was resolved to a function def
    required: Tuple[str, ...] = ()
    optional: Tuple[str, ...] = ()
    var_kw: bool = False


@dataclass(frozen=True)
class SchemaField:
    name: str
    line: int
    type: str
    required: bool


@dataclass(frozen=True)
class SchemaDef:
    path: str
    line: int
    method: str
    fields: Tuple[SchemaField, ...]

    def field_map(self) -> Dict[str, SchemaField]:
        return {f.name: f for f in self.fields}


@dataclass(frozen=True)
class ThreadSpawn:
    path: str
    line: int


# ---- raycheck v4 fact kinds (RC16–RC17) ----------------------------------


@dataclass(frozen=True, order=True)
class ThreadRoot:
    """One entry point from which a distinct thread of control starts:
    a ThreadRegistry ``spawn`` target, a ``threading.Thread(target=)``,
    or a registered RPC handler (dispatch-pool / reader-thread entry).
    ``label`` is the human root name — ``<stem>.<qualname>`` — shared
    with :meth:`~ray_tpu_torch.cluster.threads.ThreadRegistry.roots` so RC16
    reports and the flight recorder name threads identically."""
    path: str
    line: int
    kind: str    # "registry-spawn" | "thread" | "handler"
    fid: str     # function id the root enters
    label: str


@dataclass(frozen=True)
class FieldAccess:
    """One read/write of ``self.<attr>`` (``cls`` set) or of a module
    global declared via ``global`` (``cls == ""``), annotated with the
    lockset held at the site: locks acquired locally plus the entry
    lockset flowed through the module-local call closure. Container
    mutations (``self.x[k] = v``, ``self.x.append(...)``) count as
    writes — rebind-only tracking misses most real races."""
    path: str
    cls: str
    attr: str
    line: int
    fid: str
    write: bool
    locks: frozenset


@dataclass(frozen=True, order=True)
class WaitSite:
    """One potentially-unbounded cross-thread wait: ``Condition.wait``
    / ``wait_for``, ``Event.wait``, ``Queue.get``, a zero-arg
    ``.join()``, or a raw socket ``recv`` outside the rpc framing
    layer. ``bounded`` records whether a timeout argument is present
    at the call site."""
    path: str
    line: int
    fid: str
    desc: str
    bounded: bool
    receiver: str


# ---- raycheck v3 fact kinds (RC12–RC15) ----------------------------------


@dataclass(frozen=True)
class KnobDef:
    """One annotated field of a ``Config`` dataclass in a file named
    ``config.py`` (underscore-prefixed internals excluded)."""
    path: str
    line: int
    name: str


@dataclass(frozen=True)
class MetricDef:
    """One module-level ``name = Counter|Gauge|Histogram(...)`` in a
    file named ``metrics.py``."""
    path: str
    line: int
    name: str
    kind: str          # "Counter" | "Gauge" | "Histogram"


@dataclass(frozen=True)
class IncSite:
    """One ``<receiver>.inc(...)`` call; ``receiver`` is the terminal
    name of the receiver expression (``metrics.tasks_shed`` →
    ``tasks_shed``)."""
    path: str
    line: int
    receiver: str


@dataclass(frozen=True)
class TransitionDecl:
    src: str
    dst: str
    driver: str
    kind: str
    escape: bool
    line: int


@dataclass(frozen=True)
class ProtocolDecl:
    """One literal ``Protocol(...)`` declaration re-extracted from a
    ``protocols.py`` AST. ``malformed`` carries a reason when the
    declaration is not statically analyzable (non-literal fields)."""
    path: str
    line: int
    name: str
    states: Tuple[str, ...] = ()
    initial: str = ""
    terminal: Tuple[str, ...] = ()
    transitions: Tuple[TransitionDecl, ...] = ()
    covers: Tuple[str, ...] = ()
    malformed: str = ""


@dataclass(frozen=True, order=True)
class LockEdge:
    """While holding ``src``, ``dst`` is (possibly transitively)
    acquired at ``path:line`` inside ``holder``; ``via`` names the
    callee chain entry point for inter-procedural edges ("" for a
    directly nested ``with``)."""
    src: str
    dst: str
    path: str
    line: int
    holder: str
    via: str


# literal-constant type vs schema annotation compatibility, mirroring
# schema._runtime_type's isinstance targets (bool is an int subclass;
# any buffer type is wire-equivalent to bytes)
_TYPE_OK = {
    "bytes": {"bytes", "bytearray", "memoryview"},
    "str": {"str"},
    "bool": {"bool"},
    "int": {"int", "bool"},
    "float": {"int", "float", "bool"},
    "dict": {"dict"}, "Dict": {"dict"},
    "list": {"list"}, "List": {"list"},
    "tuple": {"tuple"},
}


def type_compatible(annotation: str, literal_type: str) -> bool:
    """Would ``schema.validate`` accept a literal of ``literal_type``
    for a field annotated ``annotation``? Unknown annotations are
    unchecked at runtime, so they are compatible here too."""
    if literal_type == "NoneType":
        return True  # validate() skips None values
    ann = annotation.strip().strip("\"'")
    base = ann.split("[")[0].strip()
    if base == "Optional":
        inner = ann[ann.index("[") + 1:-1] if "[" in ann else ""
        return type_compatible(inner, literal_type)
    allowed = _TYPE_OK.get(base)
    return True if allowed is None else literal_type in allowed


# --------------------------------------------------------------------------
# per-file extraction
# --------------------------------------------------------------------------


def _signature(fn: ast.FunctionDef) -> Tuple[Tuple[str, ...],
                                             Tuple[str, ...], bool]:
    """(required, optional, has **kwargs) of a handler def, self
    stripped; a @token_deduped wrapper adds the reserved optional
    ``token`` kwarg it owns."""
    a = fn.args
    pos = list(getattr(a, "posonlyargs", [])) + list(a.args)
    if pos and pos[0].arg in ("self", "cls"):
        pos = pos[1:]
    n_opt = len(a.defaults)
    required = [p.arg for p in pos[:len(pos) - n_opt]]
    optional = [p.arg for p in pos[len(pos) - n_opt:]]
    for kw, default in zip(a.kwonlyargs, a.kw_defaults):
        (required if default is None else optional).append(kw.arg)
    if any(_terminal_name(d) == "token_deduped" for d in fn.decorator_list):
        optional.append("token")
    return tuple(required), tuple(optional), a.kwarg is not None


class _FileFacts(ast.NodeVisitor):
    """One pass over one file's AST collecting every fact kind."""

    def __init__(self, relpath: str, tree: ast.AST):
        self.relpath = relpath
        self.call_sites: List[CallSite] = []
        self.handlers: List[Handler] = []
        self.schemas: List[SchemaDef] = []
        self.thread_spawns: List[ThreadSpawn] = []
        # raycheck v3 facts
        self.knobs: List[KnobDef] = []
        self.metrics: List[MetricDef] = []
        self.inc_sites: List[IncSite] = []
        self.protocol_decls: List[ProtocolDecl] = []
        self.used_names: Set[str] = set()
        self.used_strings: Set[str] = set()
        # lock facts, resolved later by _LockAnalysis
        self._cls_stack: List[ast.ClassDef] = []
        self._methods: Dict[str, Dict[str, ast.FunctionDef]] = {}
        self.functions: Dict[str, Tuple[Optional[str], ast.FunctionDef]] = {}
        self.cond_aliases: Dict[Tuple[str, str], str] = {}
        # raycheck v4 raw facts, resolved later by _LockAnalysis:
        # (kind, owner_cls, target_kind, target_name, line)
        self.root_sites: List[
            Tuple[str, Optional[str], str, str, int]] = []
        # (cls, attr) -> ctor name for `self.X = Ctor(...)` assignments
        self.field_types: Dict[Tuple[str, str], str] = {}
        self.global_names: Set[str] = set()
        self._stem = relpath.rsplit("/", 1)[-1][:-3]
        for node in ast.iter_child_nodes(tree):
            if isinstance(node, ast.ClassDef):
                self._methods[node.name] = {
                    n.name: n for n in node.body
                    if isinstance(n, ast.FunctionDef)}
        self.visit(tree)
        if self._stem == "config":
            self._extract_knobs(tree)
        if self._stem == "metrics":
            self._extract_metrics(tree)
        if self._stem == "protocols":
            self._extract_protocols(tree)

    # -- structure tracking ----------------------------------------------
    def visit_ClassDef(self, node: ast.ClassDef) -> None:
        self._cls_stack.append(node)
        self.generic_visit(node)
        self._cls_stack.pop()

    def _cur_cls(self) -> Optional[str]:
        return self._cls_stack[-1].name if self._cls_stack else None

    def visit_FunctionDef(self, node: ast.FunctionDef) -> None:
        cls = self._cur_cls()
        fid = (f"{self.relpath}::{cls}.{node.name}" if cls
               else f"{self.relpath}::{node.name}")
        # first def wins (nested defs under a method keep the method id)
        self.functions.setdefault(fid, (cls, node))
        self.generic_visit(node)

    visit_AsyncFunctionDef = visit_FunctionDef

    # -- fact collection ---------------------------------------------------
    def visit_Assign(self, node: ast.Assign) -> None:
        cls = self._cur_cls()
        if cls and len(node.targets) == 1 \
                and isinstance(node.targets[0], ast.Attribute) \
                and isinstance(node.targets[0].value, ast.Name) \
                and node.targets[0].value.id == "self" \
                and isinstance(node.value, ast.Call):
            attr = node.targets[0].attr
            ctor = _terminal_name(node.value.func)
            # self.X = threading.Condition(self.Y): X aliases lock Y
            if ctor == "Condition" and node.value.args:
                underlying = node.value.args[0]
                if isinstance(underlying, ast.Attribute) \
                        and isinstance(underlying.value, ast.Name) \
                        and underlying.value.id == "self":
                    self.cond_aliases[(cls, attr)] = underlying.attr
            # self.X = Queue(...)/Event()/...: field type for the
            # race-escape and wait-receiver resolution (first ctor
            # assignment wins — __init__ is visited first)
            if ctor is not None:
                self.field_types.setdefault((cls, attr), ctor)
        self.generic_visit(node)

    def visit_Global(self, node: ast.Global) -> None:
        self.global_names.update(node.names)

    def visit_Call(self, node: ast.Call) -> None:
        self._maybe_call_site(node)
        self._maybe_register(node)
        self._maybe_thread(node)
        self._maybe_spawn(node)
        self._maybe_inc(node)
        self.generic_visit(node)

    # -- use sets (RC14/RC15 joins) ----------------------------------------
    def visit_Name(self, node: ast.Name) -> None:
        self.used_names.add(node.id)

    def visit_Attribute(self, node: ast.Attribute) -> None:
        self.used_names.add(node.attr)
        self.generic_visit(node)

    def visit_Constant(self, node: ast.Constant) -> None:
        if isinstance(node.value, str):
            self.used_strings.add(node.value)

    def visit_For(self, node: ast.For) -> None:
        # the loop-registration idiom:
        #   for name in ("a", "b", ...):
        #       srv.register(name, getattr(self, name), ...)
        if isinstance(node.iter, (ast.Tuple, ast.List, ast.Set)) \
                and isinstance(node.target, ast.Name):
            registers = any(
                isinstance(c, ast.Call)
                and isinstance(c.func, ast.Attribute)
                and c.func.attr in ("register", "register_stream")
                and c.args and isinstance(c.args[0], ast.Name)
                and c.args[0].id == node.target.id
                for b in node.body for c in ast.walk(b))
            if registers:
                for elt in node.iter.elts:
                    if isinstance(elt, ast.Constant) \
                            and isinstance(elt.value, str):
                        self._add_handler(elt.value, elt.lineno,
                                          elt.value, is_stream=False)
        self.generic_visit(node)

    def _maybe_call_site(self, node: ast.Call) -> None:
        fn = node.func
        if not isinstance(fn, ast.Attribute) \
                or fn.attr not in WIRE_CALL_ATTRS:
            return
        if not (node.args and isinstance(node.args[0], ast.Constant)
                and isinstance(node.args[0].value, str)):
            return
        receiver = _terminal_name(fn.value) or ""
        # RpcClient's surface is kwargs-only past the method name (plus
        # call_stream's on_chunk); positional extras mean a different
        # protocol that merely shares the attribute name. Non-wire
        # sites are still recorded (liberal input to the dead-handler
        # check) but excluded from the strict RC06/RC07 joins.
        allowed_pos = 2 if fn.attr == "call_stream" else 1
        wire = (len(node.args) <= allowed_pos
                and bool(_WIRE_RECEIVER_RE.search(receiver.lower())))
        keys, consts = [], []
        splat = False
        for kw in node.keywords:
            if kw.arg is None:
                splat = True
                continue
            keys.append(kw.arg)
            if isinstance(kw.value, ast.Constant):
                consts.append((kw.arg, type(kw.value.value).__name__))
        self.call_sites.append(CallSite(
            self.relpath, node.lineno, node.args[0].value, fn.attr,
            tuple(keys), splat, tuple(consts), receiver, wire))

    def _maybe_register(self, node: ast.Call) -> None:
        fn = node.func
        if not isinstance(fn, ast.Attribute) \
                or fn.attr not in ("register", "register_stream"):
            return
        if not (node.args and isinstance(node.args[0], ast.Constant)
                and isinstance(node.args[0].value, str)):
            return
        target = None
        if len(node.args) > 1:
            expr = node.args[1]
            if isinstance(expr, ast.Attribute) \
                    and isinstance(expr.value, ast.Name) \
                    and expr.value.id == "self":
                target = expr.attr
            elif isinstance(expr, ast.Call) \
                    and _terminal_name(expr.func) == "getattr" \
                    and len(expr.args) == 2 \
                    and isinstance(expr.args[1], ast.Constant):
                target = expr.args[1].value
        self._add_handler(node.args[0].value, node.lineno, target,
                          is_stream=fn.attr == "register_stream")

    def _add_handler(self, method: str, line: int,
                     target: Optional[str], is_stream: bool) -> None:
        cls = self._cur_cls()
        server = f"{self._stem}.{cls}" if cls else self._stem
        # every registered handler is a thread root: the dispatch pool
        # (or a connection's reader thread, for inline handlers) runs it
        # concurrently with every other root
        if cls and (target or method):
            self.root_sites.append(
                ("handler", cls, "self", target or method, line))
        fndef = (self._methods.get(cls, {}).get(target)
                 if cls and target else None)
        if fndef is None:
            self.handlers.append(Handler(
                self.relpath, line, method, server, is_stream,
                resolved=False))
            return
        required, optional, var_kw = _signature(fndef)
        self.handlers.append(Handler(
            self.relpath, line, method, server, is_stream,
            resolved=True, required=required, optional=optional,
            var_kw=var_kw))

    def _target_desc(self, expr: Optional[ast.AST]) \
            -> Optional[Tuple[str, str]]:
        """A thread-entry expression as ("self", attr) / ("name", id);
        anything else (lambdas, partials, cross-object methods) is not
        module-locally resolvable and yields no root."""
        if isinstance(expr, ast.Attribute) \
                and isinstance(expr.value, ast.Name) \
                and expr.value.id == "self":
            return ("self", expr.attr)
        if isinstance(expr, ast.Name):
            return ("name", expr.id)
        return None

    def _maybe_thread(self, node: ast.Call) -> None:
        fn = node.func
        if isinstance(fn, ast.Attribute) and fn.attr == "Thread" \
                and isinstance(fn.value, ast.Name) \
                and fn.value.id == "threading":
            self.thread_spawns.append(
                ThreadSpawn(self.relpath, node.lineno))
            target = next((kw.value for kw in node.keywords
                           if kw.arg == "target"), None)
            desc = self._target_desc(target)
            if desc is not None:
                self.root_sites.append(
                    ("thread", self._cur_cls(), desc[0], desc[1],
                     node.lineno))

    def _maybe_spawn(self, node: ast.Call) -> None:
        # <registry>.spawn(self._loop, "name", ...) — the ThreadRegistry
        # surface (cluster/threads.py); matched by attribute shape so
        # corpus fixtures don't need the real class
        fn = node.func
        if isinstance(fn, ast.Attribute) and fn.attr == "spawn" \
                and node.args:
            desc = self._target_desc(node.args[0])
            if desc is not None:
                self.root_sites.append(
                    ("registry-spawn", self._cur_cls(), desc[0],
                     desc[1], node.lineno))

    def _maybe_inc(self, node: ast.Call) -> None:
        # <metric>.inc(...) — receiver's terminal name joins against the
        # metrics registry in RC15
        fn = node.func
        if isinstance(fn, ast.Attribute) and fn.attr == "inc":
            receiver = _terminal_name(fn.value)
            if receiver is not None:
                self.inc_sites.append(
                    IncSite(self.relpath, node.lineno, receiver))

    # -- raycheck v3 declaration extraction --------------------------------
    def _extract_knobs(self, tree: ast.AST) -> None:
        for node in ast.iter_child_nodes(tree):
            if not (isinstance(node, ast.ClassDef)
                    and node.name == "Config"):
                continue
            for stmt in node.body:
                if isinstance(stmt, ast.AnnAssign) \
                        and isinstance(stmt.target, ast.Name) \
                        and not stmt.target.id.startswith("_"):
                    self.knobs.append(KnobDef(
                        self.relpath, stmt.lineno, stmt.target.id))

    _METRIC_CTORS = frozenset({"Counter", "Gauge", "Histogram"})

    def _extract_metrics(self, tree: ast.AST) -> None:
        for node in ast.iter_child_nodes(tree):
            if isinstance(node, ast.Assign) \
                    and len(node.targets) == 1 \
                    and isinstance(node.targets[0], ast.Name) \
                    and isinstance(node.value, ast.Call):
                ctor = _terminal_name(node.value.func)
                if ctor in self._METRIC_CTORS:
                    self.metrics.append(MetricDef(
                        self.relpath, node.lineno,
                        node.targets[0].id, ctor))

    def _extract_protocols(self, tree: ast.AST) -> None:
        for node in ast.walk(tree):
            if isinstance(node, ast.Call) \
                    and _terminal_name(node.func) == "Protocol":
                self.protocol_decls.append(
                    self._parse_protocol(node))

    def _parse_protocol(self, call: ast.Call) -> ProtocolDecl:
        order = ("name", "states", "initial", "terminal",
                 "transitions", "covers")
        kw: Dict[str, ast.AST] = dict(zip(order, call.args))
        for k in call.keywords:
            if k.arg is not None:
                kw[k.arg] = k.value

        def _str(node: ast.AST) -> str:
            if isinstance(node, ast.Constant) \
                    and isinstance(node.value, str):
                return node.value
            raise _NotLiteral(node)

        def _strs(node: Optional[ast.AST]) -> Tuple[str, ...]:
            if node is None:
                return ()
            if not isinstance(node, (ast.Tuple, ast.List)):
                raise _NotLiteral(node)
            return tuple(_str(e) for e in node.elts)

        def _transition(node: ast.AST) -> TransitionDecl:
            if not (isinstance(node, ast.Call)
                    and _terminal_name(node.func) == "T"):
                raise _NotLiteral(node)
            t_order = ("src", "dst", "driver", "kind", "escape")
            t_kw: Dict[str, ast.AST] = dict(zip(t_order, node.args))
            for k in node.keywords:
                if k.arg is not None:
                    t_kw[k.arg] = k.value
            escape = False
            if "escape" in t_kw:
                e = t_kw["escape"]
                if not (isinstance(e, ast.Constant)
                        and isinstance(e.value, bool)):
                    raise _NotLiteral(e)
                escape = e.value
            kind = _str(t_kw["kind"]) if "kind" in t_kw else "wire"
            return TransitionDecl(
                _str(t_kw["src"]), _str(t_kw["dst"]),
                _str(t_kw["driver"]), kind, escape, node.lineno)

        try:
            trans_node = kw.get("transitions")
            if trans_node is not None \
                    and not isinstance(trans_node, (ast.Tuple, ast.List)):
                raise _NotLiteral(trans_node)
            return ProtocolDecl(
                self.relpath, call.lineno, _str(kw["name"]),
                states=_strs(kw.get("states")),
                initial=_str(kw["initial"]) if "initial" in kw else "",
                terminal=_strs(kw.get("terminal")),
                transitions=tuple(
                    _transition(e) for e in trans_node.elts)
                if trans_node is not None else (),
                covers=_strs(kw.get("covers")))
        except (_NotLiteral, KeyError) as e:
            name = ""
            node = kw.get("name")
            if isinstance(node, ast.Constant) \
                    and isinstance(node.value, str):
                name = node.value
            reason = ("missing required field"
                      if isinstance(e, KeyError)
                      else "non-literal field")
            return ProtocolDecl(self.relpath, call.lineno, name,
                                malformed=reason)

    def extract_schemas(self, tree: ast.AST) -> None:
        for node in ast.walk(tree):
            if not isinstance(node, ast.ClassDef):
                continue
            method = None
            for dec in node.decorator_list:
                if isinstance(dec, ast.Call) \
                        and _terminal_name(dec.func) == "message" \
                        and dec.args \
                        and isinstance(dec.args[0], ast.Constant) \
                        and isinstance(dec.args[0].value, str):
                    method = dec.args[0].value
            if method is None:
                continue
            fields = []
            for stmt in node.body:
                if isinstance(stmt, ast.AnnAssign) \
                        and isinstance(stmt.target, ast.Name):
                    ann = ast.unparse(stmt.annotation).strip()
                    fields.append(SchemaField(
                        stmt.target.id, stmt.lineno, ann,
                        required=stmt.value is None))
            self.schemas.append(SchemaDef(
                self.relpath, node.lineno, method, tuple(fields)))


# --------------------------------------------------------------------------
# lock-order analysis
# --------------------------------------------------------------------------

# a with-item naming one of these is a lock acquisition; I/O-serializing
# locks (send_lock) participate too — they still order against state
# locks in a deadlock
_LOCK_NAME_RE = re.compile(r"(?:^|_)(?:lock|cv|cond|mutex)$")

# ---- raycheck v4 classification tables -----------------------------------

# synchronization-object constructors: fields holding one are a
# thread-safe handoff, not raceable shared state (RC16 escape), and
# the receiver types RC17 resolves wait methods against
_QUEUE_CTORS = frozenset({"Queue", "LifoQueue", "PriorityQueue",
                          "SimpleQueue"})
_WAITABLE_CTORS = frozenset({"Event", "Condition"})
SYNC_CTORS = frozenset({"Lock", "RLock", "Semaphore",
                        "BoundedSemaphore", "Barrier",
                        "ThreadRegistry"}) \
    | _QUEUE_CTORS | _WAITABLE_CTORS

# receiver names that read as a waitable even when the ctor assignment
# is out of reach (locals, parameters)
_WAITABLE_NAME_RE = re.compile(r"(?:^|_)(?:cv|cond|ev|event)$")

# method calls that mutate the container a field holds — counted as
# writes: rebind-only tracking misses the dict/deque races that matter
_MUTATOR_ATTRS = frozenset({
    "append", "appendleft", "extend", "extendleft", "insert",
    "pop", "popleft", "popitem", "remove", "discard", "clear",
    "update", "setdefault", "add"})

_SOCKET_RECV_ATTRS = frozenset({"recv", "recv_into", "recvfrom"})
_SOCKETISH_NAME_RE = re.compile(r"sock|conn")


def _root_label(fid: str) -> str:
    """``cluster/raylet_server.py::RayletServer._heartbeat_loop`` →
    ``raylet_server.RayletServer._heartbeat_loop`` — module stem plus
    qualname, the SAME derivation
    :func:`ray_tpu_torch.cluster.threads.root_label` applies to a live
    callable, so static reports and runtime thread registries name
    roots identically."""
    path, qual = fid.rsplit("::", 1)
    stem = path.rsplit("/", 1)[-1][:-3]
    return f"{stem}.{qual}"


class _LockAnalysis:
    """Builds the inter-procedural acquisition graph for one scan,
    plus the raycheck-v4 concurrency facts layered on the same call
    resolution: thread roots with per-root reachability, field
    accesses annotated with flowed locksets, and wait sites."""

    def __init__(self, file_facts: List[_FileFacts]):
        self.edges: List[LockEdge] = []
        self._direct: Dict[str, Set[str]] = {}
        self._calls: Dict[str, Set[str]] = {}
        self._may: Dict[str, Set[str]] = {}
        # v4: per-callee [(caller, locks held at the call site)], raw
        # accesses/waits with their locally-held locksets, roots
        self._call_locks: Dict[str, List[Tuple[str, frozenset]]] = {}
        self._raw_accesses: List[
            Tuple[str, str, str, int, str, bool, frozenset]] = []
        self.wait_sites: List[WaitSite] = []
        self.roots: List[ThreadRoot] = []
        self.reach: Dict[str, Set[str]] = {}
        self.accesses: List[FieldAccess] = []
        self.field_types: Dict[Tuple[str, str, str], str] = {}
        for ff in file_facts:
            for (cls, attr), ctor in ff.field_types.items():
                self.field_types[(ff.relpath, cls, attr)] = ctor
            for fid, (cls, fndef) in ff.functions.items():
                self._direct[fid] = set()
                self._calls[fid] = set()
                self._scan_function(ff, fid, cls, fndef)
        for ff in file_facts:
            for fid, (cls, fndef) in ff.functions.items():
                self._scan_accesses(ff, fid, cls, fndef)
        self._fixpoint()
        for ff in file_facts:
            for fid, (cls, fndef) in ff.functions.items():
                self._emit_edges(ff, fid, cls, fndef)
        self._resolve_roots(file_facts)
        self._compute_reach()
        self._finalize_accesses()

    # -- helpers -----------------------------------------------------------
    def _lock_id(self, ff: _FileFacts, cls: Optional[str],
                 expr: ast.AST) -> Optional[str]:
        if isinstance(expr, ast.Attribute) \
                and isinstance(expr.value, ast.Name) \
                and expr.value.id == "self" and cls is not None:
            name = ff.cond_aliases.get((cls, expr.attr), expr.attr)
            if _LOCK_NAME_RE.search(name.lower()):
                return f"{ff.relpath}::{cls}.{name}"
            return None
        name = _terminal_name(expr)
        if name is not None and not isinstance(expr, ast.Call) \
                and _LOCK_NAME_RE.search(name.lower()):
            return f"{ff.relpath}::{name}"
        return None

    def _callee(self, ff: _FileFacts, cls: Optional[str],
                node: ast.Call) -> Optional[str]:
        fn = node.func
        if isinstance(fn, ast.Attribute) \
                and isinstance(fn.value, ast.Name) \
                and fn.value.id == "self" and cls is not None:
            fid = f"{ff.relpath}::{cls}.{fn.attr}"
            return fid if fid in self._direct else None
        if isinstance(fn, ast.Name):
            fid = f"{ff.relpath}::{fn.id}"
            return fid if fid in self._direct else None
        return None

    # -- passes ------------------------------------------------------------
    def _scan_function(self, ff: _FileFacts, fid: str,
                       cls: Optional[str], fndef: ast.AST) -> None:
        for node in ast.walk(fndef):
            if isinstance(node, (ast.With, ast.AsyncWith)):
                for item in node.items:
                    lock = self._lock_id(ff, cls, item.context_expr)
                    if lock is not None:
                        self._direct[fid].add(lock)
            elif isinstance(node, ast.Call):
                callee = self._callee(ff, cls, node)
                if callee is not None:
                    self._calls[fid].add(callee)

    def _fixpoint(self) -> None:
        self._may = {fid: set(locks)
                     for fid, locks in self._direct.items()}
        changed = True
        while changed:
            changed = False
            for fid, callees in self._calls.items():
                acc = self._may[fid]
                before = len(acc)
                for callee in callees:
                    acc |= self._may.get(callee, set())
                if len(acc) != before:
                    changed = True

    def _emit_edges(self, ff: _FileFacts, fid: str,
                    cls: Optional[str], fndef: ast.AST) -> None:
        for node in ast.walk(fndef):
            if not isinstance(node, (ast.With, ast.AsyncWith)):
                continue
            held = None
            for item in node.items:
                held = held or self._lock_id(ff, cls, item.context_expr)
            if held is None:
                continue
            for stmt in node.body:
                for child in _iter_with_body(stmt):
                    if isinstance(child, (ast.With, ast.AsyncWith)):
                        for item in child.items:
                            inner = self._lock_id(ff, cls,
                                                  item.context_expr)
                            if inner is not None and inner != held:
                                self.edges.append(LockEdge(
                                    held, inner, ff.relpath,
                                    child.lineno, fid, ""))
                    elif isinstance(child, ast.Call):
                        callee = self._callee(ff, cls, child)
                        if callee is None:
                            continue
                        for inner in sorted(self._may.get(callee, ())):
                            if inner != held:
                                self.edges.append(LockEdge(
                                    held, inner, ff.relpath,
                                    child.lineno, fid, callee))

    # -- raycheck v4 passes ------------------------------------------------
    def _scan_accesses(self, ff: _FileFacts, fid: str,
                       cls: Optional[str], fndef: ast.AST) -> None:
        """One pruned walk per function tracking the locally-held
        lockset: field/global accesses, wait sites, and call sites
        (with held locks, for the entry-lockset fixpoint)."""
        local_types: Dict[str, str] = {}

        def walk(node: ast.AST, held: frozenset) -> None:
            if isinstance(node, _FN_BOUNDARY):
                return
            if isinstance(node, (ast.With, ast.AsyncWith)):
                inner = held
                for item in node.items:
                    walk(item.context_expr, held)
                    lock = self._lock_id(ff, cls, item.context_expr)
                    if lock is not None:
                        inner = inner | {lock}
                for b in node.body:
                    walk(b, inner)
                return
            self._record_events(ff, fid, cls, node, held, local_types)
            for child in ast.iter_child_nodes(node):
                walk(child, held)

        body = getattr(fndef, "body", [])
        for stmt in body:
            walk(stmt, frozenset())

    def _record_events(self, ff: _FileFacts, fid: str,
                       cls: Optional[str], node: ast.AST,
                       held: frozenset,
                       local_types: Dict[str, str]) -> None:
        if isinstance(node, ast.Assign) \
                and len(node.targets) == 1 \
                and isinstance(node.targets[0], ast.Name) \
                and isinstance(node.value, ast.Call):
            ctor = _terminal_name(node.value.func)
            if ctor is not None:
                local_types[node.targets[0].id] = ctor
            return
        if isinstance(node, ast.Attribute) \
                and isinstance(node.value, ast.Name) \
                and node.value.id == "self" and cls is not None:
            write = isinstance(node.ctx, (ast.Store, ast.Del))
            self._raw_accesses.append(
                (ff.relpath, cls, node.attr, node.lineno, fid,
                 write, held))
            return
        if isinstance(node, ast.Name) and node.id in ff.global_names:
            write = isinstance(node.ctx, (ast.Store, ast.Del))
            self._raw_accesses.append(
                (ff.relpath, "", node.id, node.lineno, fid,
                 write, held))
            return
        if isinstance(node, ast.Subscript) \
                and isinstance(node.ctx, (ast.Store, ast.Del)):
            # self.x[k] = v / del self.x[k]: a container write
            tgt = node.value
            if isinstance(tgt, ast.Attribute) \
                    and isinstance(tgt.value, ast.Name) \
                    and tgt.value.id == "self" and cls is not None:
                self._raw_accesses.append(
                    (ff.relpath, cls, tgt.attr, node.lineno, fid,
                     True, held))
            return
        if isinstance(node, ast.Call):
            callee = self._callee(ff, cls, node)
            if callee is not None:
                self._call_locks.setdefault(callee, []).append(
                    (fid, held))
            self._maybe_mutator(ff, fid, cls, node, held)
            self._maybe_wait(ff, fid, cls, node, local_types)

    def _maybe_mutator(self, ff: _FileFacts, fid: str,
                       cls: Optional[str], node: ast.Call,
                       held: frozenset) -> None:
        fn = node.func
        if isinstance(fn, ast.Attribute) \
                and fn.attr in _MUTATOR_ATTRS \
                and isinstance(fn.value, ast.Attribute) \
                and isinstance(fn.value.value, ast.Name) \
                and fn.value.value.id == "self" and cls is not None:
            self._raw_accesses.append(
                (ff.relpath, cls, fn.value.attr, node.lineno, fid,
                 True, held))

    def _receiver_type(self, ff: _FileFacts, cls: Optional[str],
                       expr: ast.AST,
                       local_types: Dict[str, str]) -> Optional[str]:
        if isinstance(expr, ast.Attribute) \
                and isinstance(expr.value, ast.Name) \
                and expr.value.id == "self" and cls is not None:
            if (cls, expr.attr) in ff.cond_aliases:
                return "Condition"
            return ff.field_types.get((cls, expr.attr))
        if isinstance(expr, ast.Name):
            return local_types.get(expr.id)
        return None

    def _maybe_wait(self, ff: _FileFacts, fid: str,
                    cls: Optional[str], node: ast.Call,
                    local_types: Dict[str, str]) -> None:
        fn = node.func
        if not isinstance(fn, ast.Attribute):
            return
        attr = fn.attr
        recv = _terminal_name(fn.value) or ""
        rtype = self._receiver_type(ff, cls, fn.value, local_types)
        timeout_kw = any(kw.arg in ("timeout", "timeout_s")
                         for kw in node.keywords)
        npos = len(node.args)
        desc = bounded = None
        if attr in ("wait", "wait_for"):
            waitable = (rtype in _WAITABLE_CTORS
                        or (rtype is None
                            and _WAITABLE_NAME_RE.search(recv.lower())))
            if not waitable:
                return
            desc = f"{rtype or 'Condition'}.{attr}"
            need_pos = 2 if attr == "wait_for" else 1
            bounded = timeout_kw or npos >= need_pos
        elif attr == "get":
            if rtype not in _QUEUE_CTORS:
                return
            desc = f"{rtype}.get"
            block_false = any(
                kw.arg == "block" and isinstance(kw.value, ast.Constant)
                and kw.value.value is False for kw in node.keywords)
            first_false = (npos >= 1
                           and isinstance(node.args[0], ast.Constant)
                           and node.args[0].value is False)
            bounded = (timeout_kw or block_false or first_false
                       or npos >= 2)
        elif attr == "join":
            if npos or node.keywords:
                return  # join(timeout) / str-join / path-join
            desc = ".join()"
            bounded = False
        elif attr in _SOCKET_RECV_ATTRS:
            # the rpc framing layer owns its socket deadlines
            # (Deadline-driven settimeout); raw recv anywhere else
            # must bound itself
            if ff.relpath.endswith("rpc.py") \
                    or not _SOCKETISH_NAME_RE.search(recv.lower()):
                return
            desc = f"socket .{attr}()"
            bounded = False
        if desc is not None:
            self.wait_sites.append(WaitSite(
                ff.relpath, node.lineno, fid, desc, bool(bounded),
                recv))

    def _resolve_roots(self, file_facts: List[_FileFacts]) -> None:
        seen: Set[Tuple[str, str, int]] = set()
        for ff in file_facts:
            for kind, cls0, tkind, name, line in ff.root_sites:
                if tkind == "self":
                    if not cls0:
                        continue
                    fid = f"{ff.relpath}::{cls0}.{name}"
                else:
                    fid = f"{ff.relpath}::{name}"
                if fid not in self._direct:
                    continue  # target not module-locally resolvable
                key = (fid, kind, line)
                if key in seen:
                    continue
                seen.add(key)
                self.roots.append(ThreadRoot(
                    ff.relpath, line, kind, fid, _root_label(fid)))
        self.roots.sort()

    def _compute_reach(self) -> None:
        for root in self.roots:
            stack = [root.fid]
            visited: Set[str] = set()
            while stack:
                f = stack.pop()
                if f in visited:
                    continue
                visited.add(f)
                self.reach.setdefault(f, set()).add(root.label)
                stack.extend(self._calls.get(f, ()))

    def _finalize_accesses(self) -> None:
        """Entry-lockset fixpoint (meet = intersection over call sites,
        roots enter with nothing held), then effective lockset =
        entry ∪ locally-held per access."""
        entry: Dict[str, Optional[frozenset]] = {
            fid: None for fid in self._direct}  # None = not-yet-known
        root_fids = {r.fid for r in self.roots}
        for f in root_fids:
            entry[f] = frozenset()
        changed = True
        while changed:
            changed = False
            for callee, sites in self._call_locks.items():
                contribs = [frozenset()] if callee in root_fids else []
                for caller, held in sites:
                    e = entry.get(caller)
                    if e is not None:
                        contribs.append(e | held)
                if not contribs:
                    continue
                new = frozenset.intersection(*contribs)
                if entry.get(callee) != new:
                    entry[callee] = new
                    changed = True
        self.entry_locks = entry
        for path, cls0, attr, line, fid, write, held in \
                self._raw_accesses:
            e = entry.get(fid)
            locks = held if e is None else (held | e)
            self.accesses.append(FieldAccess(
                path, cls0, attr, line, fid, write, locks))
        self.accesses.sort(
            key=lambda a: (a.path, a.cls, a.attr, a.line, a.fid,
                           a.write))
        self.wait_sites.sort()


def _iter_with_body(stmt: ast.stmt) -> Iterable[ast.AST]:
    """Walk a with-body including nested ``with`` blocks but pruned at
    deferred-execution boundaries."""
    stack: List[ast.AST] = [stmt]
    while stack:
        node = stack.pop()
        if isinstance(node, _FN_BOUNDARY):
            continue
        yield node
        stack.extend(ast.iter_child_nodes(node))


def _lock_cycles(edges: List[LockEdge]) -> List[List[LockEdge]]:
    """Strongly connected components of the acquisition graph with ≥ 2
    locks; each SCC is reported once, as the sorted list of its
    internal edges (deterministic output)."""
    graph: Dict[str, Set[str]] = {}
    for e in edges:
        graph.setdefault(e.src, set()).add(e.dst)
        graph.setdefault(e.dst, set())
    # Tarjan, iterative
    index: Dict[str, int] = {}
    low: Dict[str, int] = {}
    on_stack: Set[str] = set()
    stack: List[str] = []
    sccs: List[Set[str]] = []
    counter = [0]

    def strongconnect(root: str) -> None:
        work = [(root, iter(sorted(graph[root])))]
        index[root] = low[root] = counter[0]
        counter[0] += 1
        stack.append(root)
        on_stack.add(root)
        while work:
            v, it = work[-1]
            advanced = False
            for w in it:
                if w not in index:
                    index[w] = low[w] = counter[0]
                    counter[0] += 1
                    stack.append(w)
                    on_stack.add(w)
                    work.append((w, iter(sorted(graph[w]))))
                    advanced = True
                    break
                if w in on_stack:
                    low[v] = min(low[v], index[w])
            if advanced:
                continue
            work.pop()
            if work:
                parent = work[-1][0]
                low[parent] = min(low[parent], low[v])
            if low[v] == index[v]:
                scc = set()
                while True:
                    w = stack.pop()
                    on_stack.discard(w)
                    scc.add(w)
                    if w == v:
                        break
                if len(scc) > 1:
                    sccs.append(scc)

    for v in sorted(graph):
        if v not in index:
            strongconnect(v)
    cycles: List[List[LockEdge]] = []
    for scc in sccs:
        members = sorted(
            e for e in edges if e.src in scc and e.dst in scc)
        # dedupe identical (src,dst,holder) edges from repeated sites
        seen: Set[Tuple[str, str, str]] = set()
        unique: List[LockEdge] = []
        for e in sorted(members, key=lambda e: (e.src, e.dst, e.path,
                                                e.line)):
            key = (e.src, e.dst, e.holder)
            if key not in seen:
                seen.add(key)
                unique.append(e)
        cycles.append(unique)
    cycles.sort(key=lambda es: (es[0].src, es[0].dst))
    return cycles


# --------------------------------------------------------------------------
# the joined program
# --------------------------------------------------------------------------


class Program:
    """All facts of one scan, extracted once and shared by every
    program rule (the AST cache: each file is parsed and walked a
    single time regardless of how many rules consume the facts)."""

    def __init__(self, files, root: Optional[str] = None) -> None:
        # files: List[SourceFile]; root: scan root on disk, used by the
        # hygiene rules (RC14) for README/tests lookups next to the tree
        self.root = root
        self.call_sites: List[CallSite] = []
        self.handlers: List[Handler] = []
        self.schemas: List[SchemaDef] = []
        self.thread_spawns: List[ThreadSpawn] = []
        self.knobs: List[KnobDef] = []
        self.metrics: List[MetricDef] = []
        self.inc_sites: List[IncSite] = []
        self.protocol_decls: List[ProtocolDecl] = []
        self.used_names_by_path: Dict[str, Set[str]] = {}
        self.used_strings_by_path: Dict[str, Set[str]] = {}
        self.file_functions: Dict[
            str, Dict[str, Tuple[Optional[str], ast.AST]]] = {}
        lock_facts: List[_FileFacts] = []
        for sf in files:
            ff = _FileFacts(sf.relpath, sf.tree)
            ff.extract_schemas(sf.tree)
            self.call_sites.extend(ff.call_sites)
            self.handlers.extend(ff.handlers)
            self.schemas.extend(ff.schemas)
            self.knobs.extend(ff.knobs)
            self.metrics.extend(ff.metrics)
            self.inc_sites.extend(ff.inc_sites)
            self.protocol_decls.extend(ff.protocol_decls)
            self.used_names_by_path[sf.relpath] = ff.used_names
            self.used_strings_by_path[sf.relpath] = ff.used_strings
            self.file_functions[sf.relpath] = dict(ff.functions)
            parts = sf.relpath.split("/")
            if {"cluster", "core"}.intersection(parts[:-1]):
                self.thread_spawns.extend(ff.thread_spawns)
                lock_facts.append(ff)
        analysis = _LockAnalysis(lock_facts)
        self.lock_edges: List[LockEdge] = analysis.edges
        self.lock_cycles: List[List[LockEdge]] = _lock_cycles(
            self.lock_edges)
        # raycheck v4 concurrency facts (same cluster/+core/ scope as
        # the lock graph they extend)
        self.thread_roots: List[ThreadRoot] = analysis.roots
        self.field_accesses: List[FieldAccess] = analysis.accesses
        self.wait_sites: List[WaitSite] = analysis.wait_sites
        self.root_reach: Dict[str, Set[str]] = analysis.reach
        self.field_types: Dict[Tuple[str, str, str], str] = \
            analysis.field_types

    # -- joined views ------------------------------------------------------
    def handler_map(self) -> Dict[str, List[Handler]]:
        out: Dict[str, List[Handler]] = {}
        for h in self.handlers:
            out.setdefault(h.method, []).append(h)
        return out

    def schema_map(self) -> Dict[str, SchemaDef]:
        return {s.method: s for s in self.schemas}

    def called_methods(self) -> Set[str]:
        """Every literal method name at any ``.call``-family site —
        liberal on purpose: the dead-handler check must not flag a
        handler reached through an unusually named client."""
        return {cs.method for cs in self.call_sites}

    def wire_call_sites(self) -> List[CallSite]:
        return [cs for cs in self.call_sites if cs.wire]

    def function_names(self) -> Set[str]:
        """Simple names of every function/method defined anywhere in the
        scan (``cluster/gcs_server.py::GcsService._mark_node_dead`` →
        ``_mark_node_dead``) — the resolution target for RC13's
        internal-driver edges."""
        out: Set[str] = set()
        for fns in self.file_functions.values():
            for fid in fns:
                out.add(fid.rsplit("::", 1)[-1].rsplit(".", 1)[-1])
        return out

    def names_used_outside(self, *exclude_stems: str) -> Set[str]:
        """Union of identifier uses over every file whose basename stem
        is NOT in ``exclude_stems`` (RC14: knob read outside config.py;
        RC15: metric used outside metrics.py)."""
        out: Set[str] = set()
        for path, names in self.used_names_by_path.items():
            stem = path.rsplit("/", 1)[-1][:-3]
            if stem not in exclude_stems:
                out |= names
        return out
