"""Client server — hosts remote drivers (reference:
python/ray/util/client/server/server.py proxying each client onto the
cluster). One thread per connection; object refs cross the wire as
opaque ids held server-side per client (released on disconnect).
"""

from __future__ import annotations

import socketserver
import threading
import uuid
from typing import Any, Dict, Optional, Tuple

import ray_tpu_torch
from ray_tpu_torch.util.client.protocol import recv_msg, send_msg


def _make_remote(func_or_class, options):
    if options:
        return ray_tpu_torch.remote(**options)(func_or_class)
    return ray_tpu_torch.remote(func_or_class)


def _resolve_descriptor(name: str):
    """'module:attr' -> the named callable (cross-language descriptor)."""
    import importlib

    mod_name, _, attr = name.partition(":")
    return getattr(importlib.import_module(mod_name), attr)


class _ClientSession:
    """Server-side state for one connected client."""

    def __init__(self):
        self.refs: Dict[bytes, Any] = {}       # client ref id -> ObjectRef
        self.actors: Dict[bytes, Any] = {}     # client actor id -> handle
        self.funcs: Dict[bytes, Any] = {}      # func id -> RemoteFunction
        # non-Python clients (cpp/) can't unpickle exception objects;
        # init{"simple_errors": true} downgrades errors to repr strings
        self.simple_errors = False

    def track_ref(self, ref) -> bytes:
        rid = uuid.uuid4().bytes
        self.refs[rid] = ref
        return rid


class ClientServer:
    def __init__(self, host: str = "127.0.0.1", port: int = 0,
                 init_kwargs: Optional[dict] = None):
        if not ray_tpu_torch.is_initialized():
            ray_tpu_torch.init(**(init_kwargs or {}))
        outer = self

        class Handler(socketserver.BaseRequestHandler):
            def handle(self):
                session = _ClientSession()
                try:
                    while True:
                        try:
                            msg = recv_msg(self.request)
                        except (ConnectionError, EOFError):
                            break
                        try:
                            reply = outer._dispatch(session, msg)
                        except BaseException as e:  # noqa: BLE001
                            reply = {"ok": False,
                                     "error": repr(e) if session.simple_errors
                                     else e}
                        try:
                            send_msg(self.request, reply)
                        except ValueError as e:
                            send_msg(self.request,
                                     {"ok": False, "error": e})
                finally:
                    session.refs.clear()
                    for handle in session.actors.values():
                        try:
                            ray_tpu_torch.kill(handle)
                        except Exception:
                            pass

        class Server(socketserver.ThreadingTCPServer):
            daemon_threads = True
            allow_reuse_address = True

        self._server = Server((host, port), Handler)
        self.port = self._server.server_address[1]
        self._thread = threading.Thread(
            target=self._server.serve_forever, daemon=True)
        self._thread.start()

    @property
    def address(self) -> str:
        return f"ray://127.0.0.1:{self.port}"

    def stop(self) -> None:
        self._server.shutdown()

    # --------------------------------------------------------------- ops
    def _dispatch(self, session: _ClientSession, msg: dict) -> dict:
        op = msg["op"]
        if op == "init":
            session.simple_errors = bool(msg.get("simple_errors"))
            return {"ok": True, "version": ray_tpu_torch.__version__}
        if op == "put":
            ref = ray_tpu_torch.put(msg["value"])
            return {"ok": True, "ref": session.track_ref(ref)}
        if op == "get":
            refs = [session.refs[r] for r in msg["refs"]]
            values = ray_tpu_torch.get(refs, timeout=msg.get("timeout"))
            return {"ok": True, "values": values}
        if op == "wait":
            by_id = {rid: session.refs[rid] for rid in msg["refs"]}
            ready, unready = ray_tpu_torch.wait(
                list(by_id.values()), num_returns=msg["num_returns"],
                timeout=msg.get("timeout"))
            ready_set = {id(r) for r in ready}
            return {"ok": True,
                    "ready": [rid for rid, r in by_id.items()
                              if id(r) in ready_set],
                    "unready": [rid for rid, r in by_id.items()
                                if id(r) not in ready_set]}
        if op == "task":
            fid = msg["func_id"]
            if fid not in session.funcs:
                session.funcs[fid] = _make_remote(
                    msg["func"], msg.get("options"))
            return self._submit_task(session, session.funcs[fid], msg)
        if op == "task_by_name":
            # Cross-language entry (reference: cross_language.py — Java/C++
            # callers name Python functions by module descriptor instead of
            # shipping pickled code): "module:attr", resolved server-side.
            options = msg.get("options") or {}
            # options are part of the identity: the same name with
            # different options must not reuse a cached wrapper
            key = b"name:" + repr((msg["name"], sorted(
                options.items()))).encode()
            if key not in session.funcs:
                session.funcs[key] = _make_remote(
                    _resolve_descriptor(msg["name"]), options)
            return self._submit_task(session, session.funcs[key], msg)
        if op in ("actor_create", "actor_create_by_name"):
            cls = (_resolve_descriptor(msg["name"])
                   if op == "actor_create_by_name" else msg["cls"])
            actor_cls = _make_remote(cls, msg.get("options"))
            args, kwargs = self._resolve(session, msg.get("args", ()),
                                         msg.get("kwargs", {}))
            handle = actor_cls.remote(*args, **kwargs)
            aid = uuid.uuid4().bytes
            session.actors[aid] = handle
            return {"ok": True, "actor_id": aid}
        if op == "actor_call":
            handle = session.actors[msg["actor_id"]]
            args, kwargs = self._resolve(session, msg["args"],
                                         msg["kwargs"])
            ref = getattr(handle, msg["method"]).remote(*args, **kwargs)
            return {"ok": True, "ref": session.track_ref(ref)}
        if op == "kill":
            no_restart = bool(msg.get("no_restart", True))
            # the handle stays in the session map in BOTH cases: after a
            # restartable kill it routes to the restarted incarnation,
            # and after a hard kill later calls surface ActorDiedError
            # exactly like the direct path (popping it here made them a
            # bare KeyError); disconnect cleanup tolerates dead handles
            handle = session.actors.get(msg["actor_id"])
            if handle is not None:
                ray_tpu_torch.kill(handle, no_restart=no_restart)
            return {"ok": True}
        raise ValueError(f"unknown op {op!r}")

    def _submit_task(self, session: _ClientSession, remote_func,
                     msg: dict) -> dict:
        args, kwargs = self._resolve(session, msg.get("args", ()),
                                     msg.get("kwargs", {}))
        out = remote_func.remote(*args, **kwargs)
        refs = out if isinstance(out, list) else [out]
        return {"ok": True,
                "refs": [session.track_ref(r) for r in refs],
                "single": not isinstance(out, list)}

    def _resolve(self, session: _ClientSession, args, kwargs
                 ) -> Tuple[tuple, dict]:
        def r(v):
            if isinstance(v, dict) and v.get("__client_ref__") is not None:
                return session.refs[v["__client_ref__"]]
            return v

        return tuple(r(a) for a in args), {k: r(v)
                                           for k, v in kwargs.items()}


def main(argv=None) -> None:
    """Standalone client server process (the reference's `ray start
    --ray-client-server-port` role): hosts an in-process runtime and
    serves ray:// drivers. The runtime runs on CUDA unless
    ``--init-kwargs`` says ``"device": "cpu"``."""
    import argparse
    import json
    import threading

    parser = argparse.ArgumentParser()
    parser.add_argument("--host", default="127.0.0.1")
    parser.add_argument("--port", type=int, default=0)
    parser.add_argument("--init-kwargs", default="{}",
                        help="JSON kwargs for ray_tpu_torch.init, e.g. "
                        "'{\"num_cpus\": 4, \"device\": \"cpu\"}'")
    args = parser.parse_args(argv)
    server = ClientServer(args.host, args.port,
                          init_kwargs=json.loads(args.init_kwargs))
    print(f"CLIENT_SERVER_ADDRESS {server.address}", flush=True)
    try:
        threading.Event().wait()
    except KeyboardInterrupt:
        server.stop()


if __name__ == "__main__":
    main()
