"""Python -> C++ task execution (the reverse of the C++ client).

Reference: cpp/src/ray/worker/default_worker.cc — a native worker
registers C++ functions and executes tasks other languages submit.
Here the native worker is ``cpp/build/cpp_worker`` (cpp/src/worker.cpp
execution loop over the framed-pickle wire); this module spawns it,
scrapes its ``CPP_WORKER_ADDRESS`` announce line, and exposes each
registered C++ function as a ``.remote()``-able task. The submitted
ray_tpu_torch task is a thin transport shim (the cross-language boundary,
like the reference's core-worker RPC hop); the COMPUTE runs in the
native worker process.

    worker = start_cpp_worker()
    fib = worker.remote_function("fib")
    ray_tpu_torch.get(fib.remote(20))   # == 6765, computed in C++
"""

from __future__ import annotations

import os
import pickle
import socket
import struct
import subprocess
from typing import Any, List, Optional

import ray_tpu_torch

_LEN = struct.Struct("!Q")


def _rpc(address: str, request: dict) -> Any:
    """One round-trip on the native worker's wire."""
    host, _, port = address.rpartition(":")
    with socket.create_connection((host, int(port)), timeout=30.0) as s:
        payload = pickle.dumps(request)
        s.sendall(_LEN.pack(len(payload)) + payload)
        header = _recv_exact(s, 8)
        reply = pickle.loads(_recv_exact(s, _LEN.unpack(header)[0]))
    if not reply.get("ok"):
        raise CrossLanguageError(reply.get("error", "unknown error"))
    return reply.get("value")


def _call_cpp(address: str, func: str, args: List[Any]) -> Any:
    return _rpc(address, {"op": "execute", "func": func,
                          "args": list(args)})


def _recv_exact(sock: socket.socket, n: int) -> bytes:
    buf = b""
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            raise ConnectionError("cpp worker closed the connection")
        buf += chunk
    return buf


class CrossLanguageError(RuntimeError):
    pass


class CppFunction:
    """A registered C++ function as a remote-callable: ``.remote()``
    submits a ray_tpu_torch task that forwards to the native worker (so the
    call composes with refs/retries like any task), ``.call()`` invokes
    synchronously."""

    def __init__(self, address: str, name: str):
        self.address = address
        self.name = name
        self._remote_fn = ray_tpu_torch.remote(
            lambda address, func, args: _call_cpp(address, func, args))

    def call(self, *args):
        return _call_cpp(self.address, self.name, list(args))

    def remote(self, *args):
        return self._remote_fn.remote(self.address, self.name, list(args))


class CppWorkerHandle:
    def __init__(self, proc: Optional[subprocess.Popen], address: str):
        self.proc = proc
        self.address = address

    def remote_function(self, name: str) -> CppFunction:
        return CppFunction(self.address, name)

    def list_functions(self) -> List[str]:
        return list(_rpc(self.address, {"op": "list"}))

    def ping(self) -> bool:
        return _rpc(self.address, {"op": "ping"}) == "pong"

    def close(self) -> None:
        try:
            _rpc(self.address, {"op": "shutdown"})
        except Exception:  # noqa: BLE001 — already gone
            pass
        if self.proc is not None:
            try:
                self.proc.wait(timeout=10)
            except subprocess.TimeoutExpired:
                self.proc.kill()


def default_worker_binary() -> str:
    repo = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    return os.path.join(repo, "cpp", "build", "cpp_worker")


def start_cpp_worker(binary: Optional[str] = None,
                     timeout_s: float = 30.0) -> CppWorkerHandle:
    """Spawn the native worker and scrape its announce line (the same
    contract every server process in this framework uses)."""
    import select
    import time

    binary = binary or default_worker_binary()
    proc = subprocess.Popen([binary], stdout=subprocess.PIPE, text=True)
    deadline = time.monotonic() + timeout_s
    os.set_blocking(proc.stdout.fileno(), False)
    buf = ""
    try:
        while time.monotonic() < deadline:
            # select-bounded read: a worker that never prints must FAIL
            # at the deadline, not park the caller in readline()
            ready, _, _ = select.select(
                [proc.stdout], [], [],
                max(0.0, deadline - time.monotonic()))
            if not ready:
                continue
            chunk = proc.stdout.read()
            if chunk == "" and proc.poll() is not None:
                raise RuntimeError(
                    f"cpp worker exited rc={proc.poll()} before "
                    "announcing")
            buf += chunk or ""
            for line in buf.splitlines():
                if line.startswith("CPP_WORKER_ADDRESS"):
                    return CppWorkerHandle(proc, line.split()[1])
        raise RuntimeError("cpp worker never announced its address")
    except BaseException:
        proc.kill()
        raise


def connect_cpp_worker(address: str) -> CppWorkerHandle:
    """Attach to an already-running native worker."""
    return CppWorkerHandle(None, address)
