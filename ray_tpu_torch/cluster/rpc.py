"""Generic framed-TCP RPC substrate for the process-separated cluster.

The reference routes all control traffic through gRPC service stubs
(src/ray/rpc/grpc_server.h, grpc_client.h). This is the equivalent seam
for the process tier: a threaded ``RpcServer`` dispatching named methods,
and an ``RpcClient`` holding one persistent connection with pipelined
request ids, so many threads can issue calls over a single socket.

Wire format per message (both directions):
    8-byte big-endian length | cloudpickle body
    body = (seq: int, kind: str, payload)
      request : (seq, method_name, kwargs_dict)
      reply   : (seq, "ok", result) | (seq, "err", (pickled_exc, tb, repr))

The payloads use cluster/protocol.py's pickle-5 codec, so numpy arrays
travel zero-copy into the frame without an extra pickle copy.
"""

from __future__ import annotations

import contextlib
import logging
import socket
import socketserver
import struct
import threading
import time
from collections import deque
from typing import Any, Callable, Dict, Optional, Tuple  # noqa: F401

from ray_tpu_torch.cluster import fault_plane as _fault
from ray_tpu_torch.cluster import protocol
from ray_tpu_torch.exceptions import RetryLaterError
from ray_tpu_torch.util import tracing as _tracing

logger = logging.getLogger(__name__)

_LEN = struct.Struct(">Q")


class RpcConnectionError(ConnectionError):
    """The peer is gone (process died or socket closed)."""


class RpcVersionError(RpcConnectionError):
    """The peer speaks a different wire-protocol version."""


# --------------------------------------------------------------------------
# Wire versioning (reference: src/ray/protobuf/ gives every message a
# schema; cross-version processes refuse to talk rather than mis-parse).
# Every connection opens with a 5-byte hello — 4 magic bytes + 1 version
# byte — in BOTH directions; a mismatch raises RpcVersionError instead
# of feeding unversioned pickles to the wrong parser. Schema rules for
# the frames themselves live in cluster/schema.py.
#
# Version history (bump on any incompatible frame-layout change):
#   1: initial versioned protocol — pickled (seq, method, kwargs)
#      request frames, (seq, kind, payload) reply frames, raw "R"
#      chunk frames.
#   2: requests may carry the reserved ``_deadline_s`` kwarg — the
#      caller's remaining timeout budget, stripped before dispatch and
#      re-established as the handler thread's deadline so nested RPCs
#      inherit the budget instead of re-minting their own. A v1
#      receiver would hand the unknown kwarg to unschema'd handlers.
#   3: requests may carry the reserved ``_trace`` kwarg — the caller's
#      sampled trace context (trace_id, span_id, sampled), stripped
#      before dispatch and recorded as a server-side handler span
#      parented to the caller's span (util/tracing.record_remote_span).
#      A v2 receiver would hand the unknown kwarg to unschema'd
#      handlers.
#   4: REQUESTS may be raw data frames (the b"R" marker, previously
#      reply-direction only): b"R" + seq + header-length + pickled
#      (method, kwargs) header + unpickled payload bytes, received via
#      recv_into straight into their final destination (the data
#      plane's single-copy chunk path). A v3 receiver would feed the
#      raw body to the pickle parser.
# --------------------------------------------------------------------------
PROTOCOL_MAGIC = b"RTPU"
PROTOCOL_VERSION = 4

# reserved request kwarg carrying the caller's remaining budget (v2)
_DEADLINE_KW = "_deadline_s"
# reserved request kwarg carrying the caller's trace context (v3)
_TRACE_KW = "_trace"


def _plane_enabled() -> bool:
    from ray_tpu_torch._private.config import Config
    return Config.instance().observability_plane_enabled


class Deadline:
    """Thread-local RPC deadline budget (reference: gRPC deadline
    propagation — a caller's deadline rides the wire and bounds every
    nested call, so one slow hop cannot spend a budget the caller no
    longer has).

    ``Deadline.budget(seconds)`` establishes (or tightens — budgets only
    ever shrink) the current thread's absolute deadline; every
    ``RpcClient.call`` clamps its timeout to the remaining budget and
    forwards the remainder in the request frame, where the server
    re-establishes it around the handler."""

    _local = threading.local()

    @classmethod
    def current(cls) -> Optional[float]:
        """Absolute monotonic deadline, or None when unbounded."""
        return getattr(cls._local, "value", None)

    @classmethod
    def remaining(cls) -> Optional[float]:
        v = cls.current()
        return None if v is None else max(0.0, v - time.monotonic())

    @classmethod
    def clamp(cls, timeout: Optional[float]) -> Optional[float]:
        """min(timeout, remaining budget), None-aware."""
        rem = cls.remaining()
        if rem is None:
            return timeout
        return rem if timeout is None else min(timeout, rem)

    @classmethod
    @contextlib.contextmanager
    def budget(cls, seconds: Optional[float]):
        if seconds is None:
            yield
            return
        prev = cls.current()
        new = time.monotonic() + seconds
        if prev is not None:
            new = min(prev, new)  # budgets only shrink
        cls._local.value = new
        try:
            yield
        finally:
            cls._local.value = prev


def _send_hello(sock: socket.socket) -> None:
    sock.sendall(PROTOCOL_MAGIC + bytes([PROTOCOL_VERSION]))


def _check_hello(sock: socket.socket, who: str,
                 timeout: Optional[float] = 10.0) -> None:
    """Read and validate the peer's hello. Runs before any framed
    traffic, under a bounded timeout so a silent peer cannot park the
    reader forever."""
    old = sock.gettimeout()
    try:
        sock.settimeout(timeout)
        hello = bytes(_recv_exact(sock, len(PROTOCOL_MAGIC) + 1))
    except socket.timeout:
        raise RpcVersionError(
            f"{who} sent no protocol hello within {timeout}s") from None
    finally:
        try:
            sock.settimeout(old)
        except OSError as e:
            # socket died during the hello; the next recv/send raises
            logger.debug("restoring socket timeout after hello "
                         "failed: %r", e)
    if hello[:len(PROTOCOL_MAGIC)] != PROTOCOL_MAGIC:
        raise RpcVersionError(
            f"{who} is not a ray_tpu_torch rpc peer (bad magic {hello[:4]!r})")
    if hello[-1] != PROTOCOL_VERSION:
        raise RpcVersionError(
            f"{who} speaks wire protocol v{hello[-1]}, this process "
            f"speaks v{PROTOCOL_VERSION}; refusing to exchange frames")


# --------------------------------------------------------------------------
# framing over sockets
# --------------------------------------------------------------------------


def _send_msg(sock: socket.socket, body: bytes) -> None:
    sock.sendall(_LEN.pack(len(body)) + body)


# Raw stream frames: payload bytes travel unpickled. Body layout is
# b"R" + 8-byte seq + raw payload; pickled bodies always start with
# 0x80 (the pickle PROTO opcode), so the marker cannot collide.
_RAW_MARKER = 0x52  # ord("R")
_U32 = struct.Struct(">I")


def _send_raw_chunk(sock: socket.socket, seq: int, payload) -> None:
    sock.sendall(_LEN.pack(9 + len(payload)) + b"R" + _LEN.pack(seq))
    sock.sendall(payload)


# Raw REQUEST data frames (wire v4): the client→server mirror of the
# raw stream reply, for payloads that must not round-trip through
# pickle. Body layout is b"R" + 8-byte seq + 4-byte header length +
# pickled (method, kwargs) header + raw payload — the header is tiny
# (ids + offsets), the payload is never copied into a pickle, and the
# receiving handler reads it with recv_into straight into its final
# destination (a preallocated shm offset on the push path). The same
# 0x52-vs-0x80 discrimination applies on the server's reader.


def _send_data_frame(sock: socket.socket, seq: int, header: bytes,
                     payload) -> None:
    sock.sendall(_LEN.pack(9 + 4 + len(header) + len(payload))
                 + b"R" + _LEN.pack(seq) + _U32.pack(len(header))
                 + header)
    sock.sendall(payload)


def _recv_exact(sock: socket.socket, n: int) -> bytearray:
    buf = bytearray(n)
    view = memoryview(buf)
    got = 0
    while got < n:
        r = sock.recv_into(view[got:], min(n - got, 4 * 1024 * 1024))
        if not r:
            raise RpcConnectionError(
                f"socket closed with {n - got}/{n} bytes outstanding")
        got += r
    return buf


def _recv_msg(sock: socket.socket) -> bytearray:
    (length,) = _LEN.unpack(_recv_exact(sock, _LEN.size))
    return _recv_exact(sock, length)


# --------------------------------------------------------------------------
# server
# --------------------------------------------------------------------------


class _DispatchPool:
    """Bounded dispatch pool — the server side of the overload plane
    (reference: gRPC server thread caps; Ray's num_server_call_thread).

    Threaded (non-inline) requests queue here instead of each spawning
    an unbounded thread. Admission is a hard bound: when every worker
    is busy, no new worker may spawn, and the queue is at depth, the
    request is SHED — the caller gets a typed :class:`RetryLaterError`
    with a backoff hint instead of a silently growing queue. Workers
    spawn on demand up to ``max_threads`` and exit when the pool stops.
    """

    def __init__(self, run: Callable, max_threads: int,
                 queue_depth: int, name: str):
        self._run = run
        self._max = max(1, int(max_threads))
        self._depth = max(1, int(queue_depth))
        self._name = name
        self._cv = threading.Condition()
        # raycheck: disable=RC10 — bounded by submit()'s admission check (queue_depth): over-bound requests return False and are shed with RetryLaterError by the caller
        self._queue: deque = deque()
        self._idle = 0
        self._num_threads = 0
        self._spawned = 0
        self._stopped = False

    def submit(self, item) -> bool:
        """True = admitted (a worker will run it); False = shed."""
        with self._cv:
            if self._stopped:
                return False
            if (len(self._queue) >= self._depth
                    and self._num_threads >= self._max
                    and self._idle == 0):
                return False
            self._queue.append(item)
            if self._idle == 0 and self._num_threads < self._max:
                self._num_threads += 1
                self._spawned += 1
                # raycheck: disable=RC09 — pool workers are daemon threads whose lifetime is bounded by the pool: stop() drains idle workers via the condition, busy ones exit after their current handler; joining them would block teardown on long-poll handlers
                threading.Thread(
                    target=self._worker, daemon=True,
                    name=f"{self._name}-{self._spawned}").start()
            else:
                self._cv.notify()
            depth = len(self._queue)
        from ray_tpu_torch.observability.metrics import rpc_dispatch_queue_depth

        rpc_dispatch_queue_depth.set(depth)
        return True

    def _worker(self) -> None:
        while True:
            with self._cv:
                self._idle += 1
                while not self._queue and not self._stopped:
                    self._cv.wait(1.0)
                self._idle -= 1
                if not self._queue:
                    self._num_threads -= 1
                    return  # stopped and drained
                item = self._queue.popleft()
            try:
                self._run(item)
            except Exception:
                logger.exception("rpc dispatch worker failed")

    def depth(self) -> int:
        with self._cv:
            return len(self._queue)

    def stats(self) -> dict:
        with self._cv:
            return {"queued": len(self._queue),
                    "threads": self._num_threads,
                    "idle": self._idle,
                    "max_threads": self._max,
                    "queue_depth": self._depth}

    def stop(self) -> None:
        with self._cv:
            self._stopped = True
            self._cv.notify_all()


class RpcServer:
    """Threaded TCP server dispatching named methods.

    Handlers are ``fn(**kwargs) -> result``; raising propagates the
    exception to the caller (restored via protocol.restore_exception).
    A handler may also be registered as a *stream* producer returning an
    iterator of chunks; each chunk is sent as its own reply frame with
    kind "chunk", terminated by an "ok" frame (used by object transfer).
    """

    def __init__(self, host: str = "127.0.0.1", port: int = 0,
                 max_dispatch_threads: Optional[int] = None,
                 queue_depth: Optional[int] = None):
        self._handlers: Dict[str, Callable] = {}
        self._stream_handlers: Dict[str, Callable] = {}
        self._data_handlers: Dict[str, Callable] = {}
        self._inline: set = set()  # known-fast methods: no thread
        # overload counters (admission control + reply path); the lock
        # also guards the per-method shed map
        self._overload_lock = threading.Lock()
        self._shed_counts: Dict[str, int] = {}  # method -> sheds
        self.num_shed_queue_full = 0
        self.num_shed_deadline = 0
        self.num_dispatched = 0
        self.num_replies_dropped = 0
        outer = self

        class _Handler(socketserver.BaseRequestHandler):
            def handle(self):  # one reader thread per connection
                sock = self.request
                sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
                # versioned hello both ways before any framed traffic
                try:
                    _send_hello(sock)
                    _check_hello(sock, "client")
                except RpcVersionError:
                    try:
                        sock.close()
                    except OSError as e:
                        logger.debug("closing version-mismatched "
                                     "client socket failed: %r", e)
                    return
                except (ConnectionError, OSError):
                    return
                # Clients pipeline requests over one connection, so a
                # blocking handler (object_wait_location, wait_task,
                # actor_call) must not head-of-line-block the rest: those
                # run on their own thread, with a shared lock serializing
                # reply frames. Methods registered inline=True (pure
                # bookkeeping) skip the thread spawn — they are the hot
                # control path (heartbeats, submits, directory updates).
                send_lock = threading.Lock()
                try:
                    peer = "%s:%s" % self.client_address[:2]
                except Exception:
                    peer = ""
                try:
                    while True:
                        (length,) = _LEN.unpack(
                            bytes(_recv_exact(sock, _LEN.size)))
                        first = _recv_exact(sock, 1)[0]
                        if first == _RAW_MARKER:
                            # v4 raw data frame: the payload stays on
                            # the socket for the handler's recv_into —
                            # single copy into its final destination.
                            # Runs inline on this reader thread, so
                            # data frames keep their send order (the
                            # chunk stream's begin/chunk/end contract).
                            outer._dispatch_data(sock, send_lock,
                                                 length, peer)
                            continue
                        body = bytearray(length)
                        body[0] = first
                        if length > 1:
                            view = memoryview(body)
                            got = 1
                            while got < length:
                                r = sock.recv_into(
                                    view[got:],
                                    min(length - got, 4 * 1024 * 1024))
                                if not r:
                                    raise RpcConnectionError(
                                        f"socket closed with "
                                        f"{length - got}/{length} "
                                        f"bytes outstanding")
                                got += r
                        nbytes = len(body)
                        seq, method, kwargs = protocol.loads(body)
                        if method in outer._inline:
                            outer._dispatch(sock, send_lock, seq, method,
                                            kwargs, peer, nbytes=nbytes)
                        elif outer._pool is not None:
                            # admission control: a full pool + full
                            # queue sheds the request here, on the
                            # reader thread, with a typed retry-later
                            # reply — never an unbounded thread spawn
                            item = (sock, send_lock, seq, method,
                                    kwargs, peer, time.monotonic(),
                                    nbytes)
                            if not outer._pool.submit(item):
                                outer._shed(sock, send_lock, seq,
                                            method, peer, "queue_full")
                        else:
                            # overload plane disabled: legacy unbounded
                            # thread-per-request dispatch
                            # raycheck: disable=RC09 — per-request dispatch thread; its lifetime is the handler call itself and the reply path tolerates a closed socket, so there is no teardown to coordinate
                            threading.Thread(
                                target=outer._dispatch,
                                args=(sock, send_lock, seq, method,
                                      kwargs, peer),
                                kwargs={"nbytes": nbytes},
                                daemon=True).start()
                except (RpcConnectionError, ConnectionError, OSError) as e:
                    # client went away: normal connection teardown
                    logger.debug("connection reader for %s exiting: %r",
                                 peer, e)

        class _Server(socketserver.ThreadingTCPServer):
            allow_reuse_address = True
            daemon_threads = True

        self._server = _Server((host, port), _Handler)
        self.host, self.port = self._server.server_address
        # Bounded dispatch pool (admission control). Explicit ctor args
        # force admission on; with neither given, the Config master
        # switch decides — off restores thread-per-request dispatch.
        from ray_tpu_torch._private.config import Config

        cfg = Config.instance()
        if (max_dispatch_threads is None and queue_depth is None
                and not cfg.overload_enabled):
            self._pool: Optional[_DispatchPool] = None
        else:
            self._pool = _DispatchPool(
                self._run_queued,
                max_dispatch_threads
                or cfg.rpc_server_max_dispatch_threads,
                queue_depth or cfg.rpc_server_queue_depth,
                f"rpc-dispatch-{self.port}")
        # raycheck: disable=RC09 — the accept-loop thread is torn down by stop() via ThreadingTCPServer.shutdown(), which joins the serve_forever loop; a registry join on top would be redundant
        self._thread = threading.Thread(
            target=self._server.serve_forever, daemon=True,
            name=f"rpc-server-{self.port}")

    @property
    def address(self) -> str:
        return f"{self.host}:{self.port}"

    def register(self, name: str, fn: Callable,
                 inline: bool = False) -> None:
        self._handlers[name] = fn
        if inline:
            self._inline.add(name)

    def register_stream(self, name: str, fn: Callable) -> None:
        self._stream_handlers[name] = fn

    def register_data(self, name: str, fn: Callable) -> None:
        """Register a raw-data-frame handler (wire v4): ``fn(payload_len,
        recv_payload, **kwargs) -> result``. The handler calls
        ``recv_payload(writable_view)`` to land the frame's payload via
        ``recv_into`` — directly into a preallocated shm offset on the
        push path, the one copy the payload makes. Always dispatched
        inline on the connection's reader thread, so a client's data
        frames are processed in send order."""
        self._data_handlers[name] = fn

    def _dispatch_data(self, sock, send_lock, length: int,
                       peer: str) -> None:
        """Parse and dispatch one raw data frame whose b"R" marker has
        been consumed; LENGTH is the full body length (incl. marker).
        The payload is still on the socket — the handler pulls it with
        the recv_payload callback; whatever it leaves is drained so a
        failing handler cannot desync the frame stream."""
        prefix = bytes(_recv_exact(sock, 12))  # 8B seq + 4B header len
        (seq,) = _LEN.unpack(prefix[:8])
        (hlen,) = _U32.unpack(prefix[8:12])
        method, kwargs = protocol.loads(_recv_exact(sock, hlen))
        payload_len = length - 1 - 12 - hlen
        consumed = [0]

        def recv_payload(dst) -> int:
            view = memoryview(dst)
            if not view.contiguous or view.readonly:
                view.release()
                raise TypeError("recv_payload needs a writable "
                                "contiguous buffer")
            view = view.cast("B")
            need = len(view)
            if consumed[0] + need > payload_len:
                raise ValueError(
                    f"recv_payload over-read: {consumed[0]}+{need} "
                    f"> {payload_len}")
            got = 0
            while got < need:
                r = sock.recv_into(view[got:],
                                   min(need - got, 4 * 1024 * 1024))
                if not r:
                    raise RpcConnectionError(
                        f"socket closed with {need - got} payload "
                        f"bytes outstanding")
                got += r
            consumed[0] += need
            return need

        with self._overload_lock:
            self.num_dispatched += 1
        budget = kwargs.pop(_DEADLINE_KW, None) if kwargs else None
        if kwargs:
            kwargs.pop(_TRACE_KW, None)
        fn = self._data_handlers.get(method)
        try:
            if fn is None:
                raise AttributeError(f"no rpc data method {method!r}")
            from ray_tpu_torch.cluster import schema

            kwargs = schema.validate(method, kwargs)
            with Deadline.budget(budget):
                frame = (seq, "ok", fn(payload_len, recv_payload,
                                       **kwargs))
        except BaseException as e:  # noqa: BLE001 — ship to caller
            frame = (seq, "err", protocol.format_exception(e))
        finally:
            # drain whatever the handler did not consume: the next
            # frame must start exactly at this frame's end
            left = payload_len - consumed[0]
            while left > 0:
                left -= len(_recv_exact(sock,
                                        min(left, 4 * 1024 * 1024)))
        try:
            body = protocol.dumps(frame)
            with send_lock:
                _send_msg(sock, body)
        except (ConnectionError, OSError) as e:
            with self._overload_lock:
                self.num_replies_dropped += 1
            logger.debug("data-frame reply to %s for %s (seq %d) "
                         "undeliverable: %r", peer, method, seq, e)

    # ------------------------------------------------- admission control
    def _run_queued(self, item) -> None:
        """Pool worker entry: queue-deadline shed, then dispatch. A
        request whose propagated ``_deadline_s`` budget expired while it
        sat in the queue is rejected BEFORE the handler runs — working
        on it would burn a pool slot producing an answer the caller has
        already abandoned (Dean & Barroso's tail amplification)."""
        sock, send_lock, seq, method, kwargs, peer, t_enq, nbytes = item
        budget = kwargs.get(_DEADLINE_KW) if kwargs else None
        if budget is not None and time.monotonic() - t_enq >= budget:
            self._shed(sock, send_lock, seq, method, peer,
                       "queue_deadline")
            return
        self._dispatch(sock, send_lock, seq, method, kwargs, peer,
                       t_enq=t_enq, nbytes=nbytes)

    def _shed(self, sock, send_lock, seq, method, peer: str,
              reason: str) -> None:
        """Reject a request with a typed RetryLaterError reply carrying
        a server-suggested backoff hint scaled by queue pressure."""
        from ray_tpu_torch.observability.metrics import rpc_requests_shed

        qlen = self._pool.depth() if self._pool is not None else 0
        with self._overload_lock:
            if reason == "queue_full":
                self.num_shed_queue_full += 1
            else:
                self.num_shed_deadline += 1
            self._shed_counts[method] = \
                self._shed_counts.get(method, 0) + 1
        rpc_requests_shed.inc(tags={"reason": reason})
        hint = min(2.0, 0.05 + 0.01 * qlen)
        exc = RetryLaterError(
            f"rpc server {self.host}:{self.port} shed {method!r} "
            f"({reason}, {qlen} queued); retry in ~{hint:.2f}s",
            retry_after_s=hint)
        try:
            body = protocol.dumps(
                (seq, "err", protocol.format_exception(exc)))
            with send_lock:
                _send_msg(sock, body)
        except (ConnectionError, OSError) as e:
            with self._overload_lock:
                self.num_replies_dropped += 1
            logger.debug("shed reply to %s for %s undeliverable: %r",
                         peer, method, e)

    def overload_stats(self) -> dict:
        """Admission/shed counters for node_stats, cluster_view, and
        `cli.py status` (plus the Prometheus series)."""
        with self._overload_lock:
            out = {
                "shed_queue_full": self.num_shed_queue_full,
                "shed_deadline": self.num_shed_deadline,
                "dispatched": self.num_dispatched,
                "replies_dropped": self.num_replies_dropped,
                "shed_by_method": dict(self._shed_counts),
            }
        out["pool"] = (self._pool.stats() if self._pool is not None
                       else None)
        return out

    def _dispatch(self, sock, send_lock, seq, method, kwargs,
                  peer: str = "", t_enq: Optional[float] = None,
                  nbytes: Optional[int] = None) -> None:
        t_run = time.monotonic()
        plane = _fault.get_plane()
        if plane is not None:
            # Seeded server-side slowdown (the "stall" rule kind): the
            # sleep happens INSIDE the dispatch slot, after admission —
            # a stalled method builds a real queue. The decision stream
            # keys on the SERVER address (not the requesting peer): a
            # wedged server is slow for everyone, and a single stream
            # makes `count`-windowed storms deterministic in event
            # space regardless of how many clients are hammering it.
            stall = plane.decide("handler",
                                 f"{self.host}:{self.port}", method)
            if stall is not None and stall["action"] == "stall":
                time.sleep(stall["seconds"])
        with self._overload_lock:
            self.num_dispatched += 1

        def reply(frame) -> None:
            if plane is not None:
                fault = plane.decide("reply", peer, method)
                if fault is not None:
                    action = fault["action"]
                    if action in ("drop", "partition"):
                        return  # the ack vanishes: one-way partition
                    if action == "delay":
                        time.sleep(fault["seconds"])
                    elif action == "truncate":
                        body = protocol.dumps(frame)
                        cut = fault.get("truncate_bytes")
                        if cut is None:
                            cut = max(1, len(body) // 2)
                        with send_lock:
                            sock.sendall(_LEN.pack(len(body))
                                         + bytes(body[:cut]))
                            sock.close()  # die mid-frame
                        return
                    elif action == "duplicate":
                        body = protocol.dumps(frame)
                        with send_lock:
                            _send_msg(sock, body)
                            _send_msg(sock, body)
                        return
                    elif action == "corrupt":
                        body = _fault.apply_corruption(
                            protocol.dumps(frame), fault,
                            tail_bias=True)
                        with send_lock:
                            _send_msg(sock, bytes(body))
                        return
            body = protocol.dumps(frame)
            with send_lock:  # frames from concurrent handlers must not
                _send_msg(sock, body)  # interleave mid-frame

        # v2: the caller's remaining budget rides the request; it bounds
        # this handler's own nested RPCs (Deadline.clamp in call()).
        budget = kwargs.pop(_DEADLINE_KW, None) if kwargs else None
        # v3: the caller's trace context rides the request; popped (like
        # the deadline) before schema validation, so handlers and
        # schemas never see it. When present + sampled, this dispatch
        # records a handler span split into queue-wait vs handler time.
        wire_trace = kwargs.pop(_TRACE_KW, None) if kwargs else None
        obs = _plane_enabled()
        if obs and wire_trace is not None:
            # raycheck: disable=RC02 — wall-clock span timestamp for cross-process trace correlation, not deadline arithmetic
            wall_start = time.time()
        else:
            wall_start = 0.0
        # Run the handler first, catching EVERYTHING it raises — a
        # handler's own ConnectionError (e.g. it called a dead peer) must
        # become an err frame, or the caller would block forever on a
        # reply that never comes.
        frames = []
        try:
            with Deadline.budget(budget):
                if method in self._stream_handlers:
                    from ray_tpu_torch.cluster import schema

                    kwargs = schema.validate(method, kwargs)
                    for chunk in self._stream_handlers[method](**kwargs):
                        if isinstance(chunk,
                                      (bytes, bytearray, memoryview)):
                            with send_lock:  # raw frame: unpickled
                                _send_raw_chunk(sock, seq, chunk)
                        else:
                            reply((seq, "chunk", chunk))
                    frames.append((seq, "ok", None))
                else:
                    fn = self._handlers.get(method)
                    if fn is None:
                        raise AttributeError(f"no rpc method {method!r}")
                    from ray_tpu_torch.cluster import schema

                    kwargs = schema.validate(method, kwargs)
                    frames.append((seq, "ok", fn(**kwargs)))
        except BaseException as e:  # noqa: BLE001 — ship to caller
            frames = [(seq, "err", protocol.format_exception(e))]
        if obs:
            self._observe(method, t_run, t_enq, nbytes, wire_trace,
                          wall_start, peer, frames)
        try:
            for frame in frames:
                reply(frame)
        except (ConnectionError, OSError) as e:
            # Client went away (BrokenPipeError/EPIPE after the peer
            # gave up on a shed or slow request): count-and-drop — a
            # per-reply stack trace under overload would itself be an
            # amplification vector. Its reader thread will notice.
            from ray_tpu_torch.observability.metrics import rpc_replies_dropped

            with self._overload_lock:
                self.num_replies_dropped += 1
            rpc_replies_dropped.inc()
            logger.debug("reply to %s for %s (seq %d) undeliverable: "
                         "%r", peer, method, seq, e)

    def start(self) -> "RpcServer":
        self._thread.start()
        return self

    def _observe(self, method: str, t_run: float,
                 t_enq: Optional[float], nbytes: Optional[int],
                 wire_trace, wall_start: float, peer: str,
                 frames) -> None:
        """Observability plane: per-method latency/queue/size histograms
        tagged (method, dst_kind), plus — for sampled wire traces — a
        handler span parented to the caller's span over the wire."""
        try:
            dt_s = time.monotonic() - t_run
            queue_s = (t_run - t_enq) if t_enq is not None else 0.0
            role = _fault.process_role()
            tags = {"method": method, "dst_kind": role}
            from ray_tpu_torch.observability.metrics import (
                rpc_request_bytes,
                rpc_server_latency_ms,
                rpc_server_queue_ms,
            )

            rpc_server_latency_ms.observe(dt_s * 1e3, tags)
            rpc_server_queue_ms.observe(queue_s * 1e3, tags)
            if nbytes is not None:
                rpc_request_bytes.observe(nbytes, tags)
            if wire_trace is not None:
                ok = bool(frames) and frames[0][1] == "ok"
                _tracing.record_remote_span(
                    f"rpc.{method}", wire_trace,
                    wall_start, wall_start + dt_s,
                    queue_wait_s=queue_s,
                    attributes={"method": method, "dst_kind": role,
                                "peer": peer,
                                "nbytes": nbytes or 0},
                    status="OK" if ok else "ERROR")
        except Exception as e:
            logger.debug("rpc observability for %s failed: %r",
                         method, e)

    def stop(self) -> None:
        if self._pool is not None:
            self._pool.stop()
        try:
            self._server.shutdown()
            self._server.server_close()
        except Exception as e:
            logger.debug("rpc server %s stop raced: %r",
                         self.address, e)


# --------------------------------------------------------------------------
# client
# --------------------------------------------------------------------------


class RpcClient:
    """One persistent connection; thread-safe pipelined calls.

    A dedicated reader thread demultiplexes replies by seq id, so N
    threads can have calls in flight concurrently (the reference's
    completion-queue client, rpc/client_call.h, by other means).
    """

    def __init__(self, address: str, connect_timeout: float = 10.0):
        self.address = address
        host, port_s = address.rsplit(":", 1)
        plane = _fault.get_plane()
        fault = (plane.decide("connect", address)
                 if plane is not None else None)
        if fault is not None:
            if fault["action"] == "refuse" or (
                    fault["action"] in ("drop", "partition")
                    and fault.get("phase") != "post-hello"):
                raise RpcConnectionError(
                    f"cannot connect to {address}: "
                    f"[fault-injected refuse]")
            if fault["action"] == "delay":
                time.sleep(fault["seconds"])
        try:
            self._sock = socket.create_connection(
                (host, int(port_s)), timeout=connect_timeout)
        except OSError as e:
            raise RpcConnectionError(
                f"cannot connect to {address}: {e}") from None
        self._sock.settimeout(None)
        self._sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        # reject-on-mismatch handshake precedes the reader thread: a
        # version skew surfaces here as RpcVersionError, synchronously
        try:
            _send_hello(self._sock)
            _check_hello(self._sock, f"server {address}",
                         timeout=connect_timeout)
        except RpcVersionError:
            self._sock.close()
            raise
        except (ConnectionError, OSError) as e:
            self._sock.close()
            raise RpcConnectionError(
                f"handshake with {address} failed: {e}") from None
        if fault is not None and fault["action"] in ("drop", "partition") \
                and fault.get("phase") == "post-hello":
            # half-open peer: the handshake completed, then it died
            self._sock.close()
            raise RpcConnectionError(
                f"connection to {address} dropped post-hello "
                f"[fault-injected]")
        self._send_lock = threading.Lock()
        self._pending: Dict[int, "_Call"] = {}
        self._pending_lock = threading.Lock()
        self._seq = 0
        self._closed = False
        # raycheck: disable=RC09 — the reader's lifetime is the socket's: close() aborts the blocking recv and the loop exits through _fail_all; it cannot outlive the connection it demultiplexes
        self._reader = threading.Thread(
            target=self._read_loop, daemon=True,
            name=f"rpc-client-{address}")
        self._reader.start()

    # -- plumbing ----------------------------------------------------------
    def _next_seq(self) -> int:
        with self._pending_lock:
            self._seq += 1
            return self._seq

    def _read_loop(self) -> None:
        try:
            while True:
                body = _recv_msg(self._sock)
                if body and body[0] == _RAW_MARKER:
                    (seq,) = _LEN.unpack(bytes(body[1:9]))
                    kind, payload = "chunk", memoryview(body)[9:]
                else:
                    seq, kind, payload = protocol.loads(body)
                with self._pending_lock:
                    call = self._pending.get(seq)
                if call is None:
                    continue  # cancelled
                call.feed(kind, payload)
                if kind != "chunk":
                    with self._pending_lock:
                        self._pending.pop(seq, None)
        except (RpcConnectionError, ConnectionError, OSError) as e:
            self._fail_all(e)

    def _fail_all(self, exc: Exception) -> None:
        self._closed = True
        with self._pending_lock:
            pending, self._pending = self._pending, {}
        for call in pending.values():
            call.feed("conn_err", (None, "", repr(exc)))

    # -- API ---------------------------------------------------------------
    def call(self, method: str, timeout: Optional[float] = None,
             **kwargs) -> Any:
        """Blocking unary call. The timeout is clamped to the thread's
        remaining Deadline budget (a nested RPC never waits longer than
        its caller is still willing to), and the effective budget rides
        the request so the handler's own RPCs inherit it."""
        timeout = Deadline.clamp(timeout)
        call = self._start(method, kwargs, budget=timeout)
        return call.result(timeout)

    def call_async(self, method: str, **kwargs) -> "_Call":
        """Returns a handle; .result(timeout) joins it."""
        return self._start(method, kwargs)

    def call_stream(self, method: str, on_chunk: Callable[[Any], None],
                    timeout: Optional[float] = None, **kwargs) -> None:
        """Invoke a stream method; on_chunk fires (on the reader thread)
        per chunk; returns when the terminating ok/err frame arrives."""
        timeout = Deadline.clamp(timeout)
        call = self._start(method, kwargs, on_chunk=on_chunk,
                           budget=timeout)
        call.result(timeout)

    def call_data_async(self, method: str, payload,
                        **kwargs) -> "_Call":
        """Send a raw data frame (wire v4): the pickled (method,
        kwargs) header plus PAYLOAD's bytes verbatim — the payload is
        handed to the kernel straight from the caller's buffer (a
        pinned shm view on the push path), never copied into a pickle.
        Returns a handle; .result(timeout) joins the server's ack.
        Data frames share the connection's framing with ordinary
        calls, so they interleave safely and arrive in send order."""
        if self._closed:
            raise RpcConnectionError(
                f"connection to {self.address} closed")
        plane = _fault.get_plane()
        fault = (plane.decide("request", self.address, method)
                 if plane is not None else None)
        seq = self._next_seq()
        call = _Call(self.address, None)
        with self._pending_lock:
            self._pending[seq] = call
        if fault is not None and fault["action"] in ("drop", "partition"):
            return call  # silently lost: caller times out
        if fault is not None and fault["action"] == "delay":
            time.sleep(fault["seconds"])
        try:
            header = protocol.dumps((method, kwargs))
            if fault is not None and fault["action"] == "corrupt":
                # flip seeded payload bytes in flight — the data-plane
                # analog of _start's frame corruption; tail-biased into
                # the chunk bytes, which only the integrity plane's
                # fused crc can catch (the framing stays intact)
                payload = _fault.apply_corruption(
                    bytearray(payload), fault, tail_bias=True)
            if fault is not None and fault["action"] == "truncate":
                with self._send_lock:
                    self._sock.sendall(
                        _LEN.pack(9 + 4 + len(header) + len(payload))
                        + b"R" + _LEN.pack(seq)
                        + _U32.pack(len(header)) + header)
                    self._sock.sendall(bytes(payload[:len(payload) // 2]))
                    self._sock.close()  # die mid-frame
                raise RpcConnectionError(
                    f"send to {self.address} truncated mid-frame "
                    f"[fault-injected]")
            with self._send_lock:
                _send_data_frame(self._sock, seq, header, payload)
        except (ConnectionError, OSError) as e:
            with self._pending_lock:
                self._pending.pop(seq, None)
            self._closed = True
            raise RpcConnectionError(
                f"send to {self.address} failed: {e}") from None
        except RpcConnectionError:
            with self._pending_lock:
                self._pending.pop(seq, None)
            self._closed = True
            raise
        return call

    def _start(self, method: str, kwargs: dict,
               on_chunk: Optional[Callable] = None,
               budget: Optional[float] = None) -> "_Call":
        if self._closed:
            raise RpcConnectionError(f"connection to {self.address} closed")
        # v2: ship the effective budget — the already-clamped per-call
        # timeout when there is one, else the thread's ambient remaining
        # budget; the server re-establishes it around the handler so
        # nested hops keep shrinking it. A small reply margin is shaved
        # off so a handler that spends its whole budget still gets its
        # answer back before the caller abandons the call.
        if budget is None:
            budget = Deadline.remaining()
        if budget is not None:
            kwargs = dict(kwargs)
            kwargs[_DEADLINE_KW] = max(
                0.0, budget - min(0.5, 0.1 * budget))
        # v3: a sampled trace context rides the frame, so the server can
        # parent its handler span to the caller's current span. The
        # enabled() bool is the only cost when tracing is off; unsampled
        # traces propagate nothing (head-based sampling: a trace is
        # recorded everywhere or nowhere).
        if _tracing.enabled():
            ctx = _tracing.current_context()
            if (ctx is not None and ctx.sampled
                    and _TRACE_KW not in kwargs and _plane_enabled()):
                kwargs = dict(kwargs)
                kwargs[_TRACE_KW] = ctx.to_dict()
        plane = _fault.get_plane()
        fault = (plane.decide("request", self.address, method)
                 if plane is not None else None)
        seq = self._next_seq()
        call = _Call(self.address, on_chunk)
        with self._pending_lock:
            self._pending[seq] = call
        if fault is not None and fault["action"] in ("drop", "partition"):
            # the frame is silently lost — the caller sees exactly what
            # a one-way partition produces: a timeout, not a conn error
            return call
        if fault is not None and fault["action"] == "delay":
            time.sleep(fault["seconds"])
        try:
            body = protocol.dumps((seq, method, kwargs))
            if fault is not None and fault["action"] == "corrupt":
                # silent data corruption: one seeded byte of the frame
                # flips in flight; tail-biased so a big chunk frame
                # corrupts payload bytes (caught by the integrity
                # plane's checksums), not the pickle framing (which
                # would fail loudly on its own)
                body = _fault.apply_corruption(body, fault,
                                               tail_bias=True)
            if fault is not None and fault["action"] == "truncate":
                cut = fault.get("truncate_bytes")
                if cut is None:
                    cut = max(1, len(body) // 2)
                with self._send_lock:
                    self._sock.sendall(_LEN.pack(len(body))
                                       + bytes(body[:cut]))
                    self._sock.close()  # cut mid-frame
                raise RpcConnectionError(
                    f"send to {self.address} truncated mid-frame "
                    f"[fault-injected]")
            with self._send_lock:
                self._sock.sendall(_LEN.pack(len(body)) + body)
                if fault is not None and fault["action"] == "duplicate":
                    self._sock.sendall(_LEN.pack(len(body)) + body)
        except (ConnectionError, OSError) as e:
            with self._pending_lock:
                self._pending.pop(seq, None)
            self._closed = True
            raise RpcConnectionError(
                f"send to {self.address} failed: {e}") from None
        except RpcConnectionError:
            with self._pending_lock:
                self._pending.pop(seq, None)
            self._closed = True
            raise
        return call

    @property
    def closed(self) -> bool:
        return self._closed

    def close(self) -> None:
        self._closed = True
        try:
            self._sock.close()
        except Exception as e:
            logger.debug("closing rpc socket to %s failed: %r",
                         self.address, e)


class ResilientRpcClient:
    """RpcClient wrapper that survives server restarts and transient
    partitions: a call that hits a dead connection reconnects and
    retries under **capped exponential backoff with full jitter**
    (reference: GCS client reconnect/retry on GCS failover,
    gcs_rpc_client.h retryable channels; the backoff discipline is the
    AWS full-jitter recipe, so N clients waking from the same partition
    don't stampede the recovering server in lockstep). Only for
    idempotent control-plane calls — the GCS surface (heartbeats,
    directory updates, KV, pubsub) is, and the mutation RPCs carry
    request tokens (gcs_server.py) so a retried create/kill cannot
    double-apply.

    The retry window honors, in order of tightness: the configured
    window, the caller's per-call timeout, and the thread's propagated
    Deadline budget — a retry never spends time the original caller no
    longer has.

    Overload plane (cluster/overload.py): retries additionally spend a
    per-destination token-bucket **retry budget** (replenished by
    successes, so aggregate retry traffic is capped at a fixed fraction
    of goodput — the defense against metastable retry storms), and a
    per-destination **circuit breaker** opens after K consecutive
    failures, fails fast while open, and half-open-probes its way
    closed, honoring the backoff hint of a server's
    :class:`RetryLaterError` shed reply. Both are shared by every
    client in the process talking to the same address."""

    def __init__(self, address: str, connect_timeout: Optional[float] = None,
                 retry_window_s: Optional[float] = None,
                 base_backoff_s: Optional[float] = None,
                 max_backoff_s: Optional[float] = None,
                 retry_budget=None, breaker=None,
                 overload: Optional[bool] = None):
        from ray_tpu_torch._private.config import Config
        from ray_tpu_torch.cluster import overload as _overload

        cfg = Config.instance()
        self.address = address
        self._connect_timeout = (connect_timeout
                                 if connect_timeout is not None
                                 else cfg.rpc_connect_timeout_s)
        self._retry_window_s = (retry_window_s
                                if retry_window_s is not None
                                else cfg.rpc_retry_window_s)
        self._base_backoff_s = (base_backoff_s
                                if base_backoff_s is not None
                                else cfg.rpc_retry_base_ms / 1000.0)
        self._max_backoff_s = (max_backoff_s
                               if max_backoff_s is not None
                               else cfg.rpc_retry_max_backoff_ms / 1000.0)
        # budget + breaker: explicit instances win (tests); else the
        # process-wide per-destination registries, unless the plane is
        # off (`overload=False`, or the Config master switch)
        on = _overload.enabled() if overload is None else bool(overload)
        self._budget = retry_budget if retry_budget is not None else (
            _overload.budget_for(address) if on else None)
        self._breaker = breaker if breaker is not None else (
            _overload.breaker_for(address) if on else None)
        self._lock = threading.Lock()
        self._client: Optional[RpcClient] = None
        self._closed = False
        # explicit jitter stream: under an active fault plan the
        # backoff schedule replays from the plan's single seed
        self._rng = _fault.derive_rng(f"rpc-backoff|{address}")

    def _get(self) -> RpcClient:
        with self._lock:
            if self._closed:
                raise RpcConnectionError(
                    f"client to {self.address} is closed")
            if self._client is None or self._client.closed:
                self._client = RpcClient(self.address,
                                         self._connect_timeout)
            return self._client

    def call(self, method: str, timeout: Optional[float] = None,
             **kwargs) -> Any:
        # never retry past the caller's own timeout contract, nor past
        # the deadline budget propagated from an upstream caller
        window = self._retry_window_s
        if timeout is not None:
            window = min(window, timeout)
        window = Deadline.clamp(window)
        deadline = time.monotonic() + window
        attempt = 0
        last_exc: Optional[BaseException] = None
        while True:
            # breaker gate: while open, no attempt reaches the wire —
            # wait out the cool-down (fail fast once the window would
            # outlive the caller's own retry window, re-raising the
            # error type the caller already handles when there is one)
            if self._breaker is not None and not self._breaker.allow():
                wait = max(self._breaker.remaining_s(), 0.02)
                now = time.monotonic()
                if self._closed or now + wait >= deadline:
                    if last_exc is not None:
                        raise last_exc
                    raise RetryLaterError(
                        f"circuit to {self.address} is open "
                        f"({self._breaker.snapshot()})",
                        retry_after_s=wait)
                time.sleep(wait)
                continue
            try:
                result = self._get().call(method, timeout=timeout,
                                          **kwargs)
            except RpcConnectionError as e:
                last_exc = e
                if self._breaker is not None:
                    self._breaker.record_failure()
                if not self._retry_admitted(deadline, attempt):
                    raise
                attempt += 1
            except RetryLaterError as e:
                # a shed reply: the server is alive but overloaded —
                # honor its backoff hint, and let the breaker fail
                # fast if sheds keep coming
                last_exc = e
                if self._breaker is not None:
                    self._breaker.record_failure(hint_s=e.retry_after_s)
                if not self._retry_admitted(deadline, attempt,
                                            hint=e.retry_after_s):
                    raise
                attempt += 1
            else:
                if self._breaker is not None:
                    self._breaker.record_success()
                if self._budget is not None:
                    self._budget.on_success()
                return result

    def _retry_admitted(self, deadline: float, attempt: int,
                        hint: float = 0.0) -> bool:
        """May one more attempt go to the wire? Checks the retry window
        and spends one retry-budget token, then sleeps the backoff
        (capped exponential, full jitter, floored so a refused loop
        cannot hot-spin, and never below the server's hint)."""
        now = time.monotonic()
        if self._closed or now >= deadline:
            return False
        if self._budget is not None and not self._budget.try_spend():
            # budget empty: retrying would amplify the overload — give
            # up and surface the failure to the caller instead
            return False
        cap = min(self._max_backoff_s,
                  self._base_backoff_s * (2 ** attempt))
        sleep = max(self._rng.uniform(0.0, cap),
                    self._base_backoff_s / 4.0, 0.005, hint)
        sleep = min(sleep, max(deadline - now, 0.0))
        if sleep > 0:
            time.sleep(sleep)
        return True

    @property
    def closed(self) -> bool:
        return self._closed

    def close(self) -> None:
        self._closed = True
        with self._lock:
            if self._client is not None:
                self._client.close()


# Back-compat name (pre-fault-plane callers); same class, the retry
# policy just generalized from fixed 0.2 s sleeps to jittered backoff.
ReconnectingRpcClient = ResilientRpcClient


def fetch_object(client: "RpcClient", object_id: bytes,
                 timeout: float = 120.0) -> Optional[Tuple[bool, bytes]]:
    """Pull one object over a raylet's chunked ``get_object`` stream.

    Returns (is_error, payload) or None when the holder is gone, doesn't
    have the object, or the transfer was truncated. Shared by the driver
    and the raylet-to-raylet transfer plane so the reassembly protocol
    has exactly one implementation."""
    meta: Dict[str, Any] = {}
    state = {"buf": bytearray(), "view": None, "off": 0}

    def on_chunk(chunk):
        if isinstance(chunk, dict):
            meta.update(chunk)
            if meta.get("size"):  # preallocate: one write per chunk
                state["buf"] = bytearray(meta["size"])
                state["view"] = memoryview(state["buf"])
            return
        n = len(chunk)
        off = state["off"]
        view = state["view"]
        if view is not None and off + n <= len(state["buf"]):
            view[off:off + n] = chunk
        else:  # size-less or overflowing stream: fall back to append
            state["view"] = None
            if off and len(state["buf"]) != off:
                del state["buf"][off:]
            state["buf"].extend(chunk)
        state["off"] = off + n

    try:
        client.call_stream("get_object", on_chunk, timeout=timeout,
                           object_id=object_id)
    except Exception:
        return None
    state["view"] = None
    buf = state["buf"]
    if len(buf) > state["off"]:
        del buf[state["off"]:]
    if "size" in meta and len(buf) != meta["size"]:
        return None
    # integrity plane: the stream's header frame carries the holder's
    # digest — verify the reassembled payload at pull completion. A
    # mismatch reads as a failed holder (return None): the caller
    # tries the next replica, which is exactly the corruption-
    # triggered re-pull contract.
    crc = meta.get("crc")
    if crc is not None:
        from ray_tpu_torch.cluster import integrity
        from ray_tpu_torch.exceptions import ObjectCorruptedError

        try:
            integrity.verify(buf, crc, "pull_stream", bytes(object_id))
        except ObjectCorruptedError:
            logger.warning("pulled payload of %s failed its digest; "
                           "trying another holder",
                           bytes(object_id).hex()[:8])
            return None
    return bool(meta.get("is_error", False)), buf


class _Call:
    __slots__ = ("_event", "_kind", "_payload", "_on_chunk", "_address")

    def __init__(self, address: str, on_chunk: Optional[Callable] = None):
        self._event = threading.Event()
        self._kind: Optional[str] = None
        self._payload: Any = None
        self._on_chunk = on_chunk
        self._address = address

    def feed(self, kind: str, payload) -> None:
        if kind == "chunk":
            if self._on_chunk is not None:
                try:
                    self._on_chunk(payload)
                except Exception:
                    logger.exception("stream chunk callback failed")
            return
        self._kind = kind
        self._payload = payload
        self._event.set()

    def result(self, timeout: Optional[float] = None) -> Any:
        if not self._event.wait(timeout):
            raise TimeoutError(
                f"rpc to {self._address} timed out after {timeout}s")
        if self._kind == "ok":
            return self._payload
        if self._kind == "conn_err":
            raise RpcConnectionError(
                f"connection to {self._address} lost: {self._payload[2]}")
        raise protocol.restore_exception(*self._payload)

    def done(self) -> bool:
        return self._event.is_set()
