"""Wire protocol for the client (reference: src/ray/protobuf/
ray_client.proto + python/ray/util/client/ARCHITECTURE.md — the real one
is gRPC; here it is length-prefixed cloudpickle frames over TCP, which
keeps the same request/response shapes without a protobuf toolchain).

Requests: {"op": <str>, ...}; responses: {"ok": bool, ...}.
Ops: init, put, get, wait, task (submit), actor_create, actor_call,
kill, shutdown.
"""

from __future__ import annotations

import socket
import struct
from typing import Any

try:
    import cloudpickle as pickle
except ImportError:  # pragma: no cover
    import pickle

_LEN = struct.Struct("!Q")
MAX_FRAME = 1 << 31


def send_msg(sock: socket.socket, obj: Any) -> None:
    payload = pickle.dumps(obj)
    if len(payload) > MAX_FRAME:
        raise ValueError("frame too large")
    sock.sendall(_LEN.pack(len(payload)) + payload)


def recv_msg(sock: socket.socket) -> Any:
    header = _recv_exact(sock, _LEN.size)
    (length,) = _LEN.unpack(header)
    if length > MAX_FRAME:
        raise ValueError("frame too large")
    return pickle.loads(_recv_exact(sock, length))


def _recv_exact(sock: socket.socket, n: int) -> bytes:
    chunks = []
    got = 0
    while got < n:
        chunk = sock.recv(n - got)
        if not chunk:
            raise ConnectionError("peer closed")
        chunks.append(chunk)
        got += len(chunk)
    return b"".join(chunks)
