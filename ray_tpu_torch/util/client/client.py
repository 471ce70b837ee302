"""Client-side remote driver (reference: python/ray/util/client/
__init__.py RayAPIStub + worker.py): connect with
``ray_tpu_torch.util.client.connect("ray://host:port")`` and use the familiar
remote/get/put/wait surface; code ships to the server as cloudpickle.
"""

from __future__ import annotations

import socket
import threading
import uuid
from typing import Any, List, Optional, Union

from ray_tpu_torch.util.client.protocol import recv_msg, send_msg


class ClientObjectRef:
    def __init__(self, rid: bytes, client: "ClientContext"):
        self._rid = rid
        self._client = client

    def __reduce_ex__(self, proto):
        raise TypeError(
            "ClientObjectRef can only be used as a direct task argument")

    def _wire(self) -> dict:
        return {"__client_ref__": self._rid}


def _encode_args(args, kwargs):
    def enc(v):
        return v._wire() if isinstance(v, ClientObjectRef) else v

    return tuple(enc(a) for a in args), {k: enc(v)
                                         for k, v in kwargs.items()}


class ClientRemoteFunction:
    def __init__(self, client: "ClientContext", func, options:
                 Optional[dict] = None):
        self._client = client
        self._func = func
        self._options = options or {}
        self._func_id = uuid.uuid4().bytes

    def options(self, **overrides) -> "ClientRemoteFunction":
        return ClientRemoteFunction(self._client, self._func,
                                    {**self._options, **overrides})

    def remote(self, *args, **kwargs):
        wire_args, wire_kwargs = _encode_args(args, kwargs)
        reply = self._client._request({
            "op": "task", "func": self._func, "func_id": self._func_id,
            "options": self._options,
            "args": wire_args, "kwargs": wire_kwargs})
        refs = [ClientObjectRef(r, self._client) for r in reply["refs"]]
        return refs[0] if reply["single"] else refs


class ClientActorMethod:
    def __init__(self, handle: "ClientActorHandle", method: str):
        self._handle = handle
        self._method = method

    def remote(self, *args, **kwargs) -> ClientObjectRef:
        wire_args, wire_kwargs = _encode_args(args, kwargs)
        reply = self._handle._client._request({
            "op": "actor_call", "actor_id": self._handle._actor_id,
            "method": self._method,
            "args": wire_args, "kwargs": wire_kwargs})
        return ClientObjectRef(reply["ref"], self._handle._client)


class ClientActorHandle:
    def __init__(self, client: "ClientContext", actor_id: bytes):
        self._client = client
        self._actor_id = actor_id

    def __getattr__(self, item):
        if item.startswith("_"):
            raise AttributeError(item)
        return ClientActorMethod(self, item)


class ClientActorClass:
    def __init__(self, client: "ClientContext", cls,
                 options: Optional[dict] = None):
        self._client = client
        self._cls = cls
        self._options = options or {}

    def options(self, **overrides) -> "ClientActorClass":
        return ClientActorClass(self._client, self._cls,
                                {**self._options, **overrides})

    def remote(self, *args, **kwargs) -> ClientActorHandle:
        wire_args, wire_kwargs = _encode_args(args, kwargs)
        reply = self._client._request({
            "op": "actor_create", "cls": self._cls,
            "options": self._options,
            "args": wire_args, "kwargs": wire_kwargs})
        return ClientActorHandle(self._client, reply["actor_id"])


class ClientContext:
    def __init__(self, address: str):
        if address.startswith("ray://"):
            address = address[len("ray://"):]
        host, _, port = address.rpartition(":")
        self._sock = socket.create_connection((host or "127.0.0.1",
                                               int(port)), timeout=60)
        self._lock = threading.Lock()
        reply = self._request({"op": "init"})
        self.server_version = reply["version"]
        self.connected = True

    def _request(self, msg: dict) -> dict:
        with self._lock:
            send_msg(self._sock, msg)
            reply = recv_msg(self._sock)
        if not reply.get("ok"):
            raise reply.get("error", RuntimeError("client request failed"))
        return reply

    # -------------------------------------------------------- ray surface
    def remote(self, obj=None, **options):
        import inspect

        def wrap(o):
            if inspect.isclass(o):
                return ClientActorClass(self, o, options)
            return ClientRemoteFunction(self, o, options)

        if obj is not None:
            return wrap(obj)
        return wrap

    def put(self, value: Any) -> ClientObjectRef:
        reply = self._request({"op": "put", "value": value})
        return ClientObjectRef(reply["ref"], self)

    def get(self, refs: Union[ClientObjectRef, List[ClientObjectRef]],
            timeout: Optional[float] = None):
        single = isinstance(refs, ClientObjectRef)
        ref_list = [refs] if single else list(refs)
        reply = self._request({
            "op": "get", "refs": [r._rid for r in ref_list],
            "timeout": timeout})
        return reply["values"][0] if single else reply["values"]

    def wait(self, refs: List[ClientObjectRef], *, num_returns: int = 1,
             timeout: Optional[float] = None):
        reply = self._request({
            "op": "wait", "refs": [r._rid for r in refs],
            "num_returns": num_returns, "timeout": timeout})
        by_id = {r._rid: r for r in refs}
        return ([by_id[r] for r in reply["ready"]],
                [by_id[r] for r in reply["unready"]])

    def kill(self, handle: ClientActorHandle,
             no_restart: bool = True) -> None:
        self._request({"op": "kill", "actor_id": handle._actor_id,
                       "no_restart": no_restart})

    def disconnect(self) -> None:
        if self.connected:
            self._sock.close()
            self.connected = False


def connect(address: str) -> ClientContext:
    return ClientContext(address)
