"""The port's ray:// client (ray_tpu_torch.util.client) against the JAX
package's, on the CPU.

- Every scenario of tests/test_client.py runs on both packages: each
  side's runtime (the port's on ``init(device="cpu")``) behind its own
  ClientServer, one after the other; each side keeps that test's
  assertions and the values that come back are compared equal.
- Client mode: ``ray_tpu_torch.init(address="ray://...")`` against a
  ``python -m ray_tpu_torch.util.client.server`` process (its runtime on
  the CPU through ``--init-kwargs``); a function decorated before the
  connection runs on the server; mixing a local runtime with a ray://
  connection raises, both ways; without ``"device": "cpu"`` the server
  wants CUDA.
- The frames are the JAX package's bytes, and a tensor sent in one comes
  back on the device it left.
- Every scenario of tests/test_cpp_client.py against the port's server
  and ``util.cpp_worker`` (skipped without g++, as there).

A test that drives the JAX package first ends the JAX runtime and serve
controllers an earlier test in this process may have left running
(ROADMAP Queue C), as tests/test_torch_serve_model.py does.
"""

import contextlib
import gc
import importlib
import json
import os
import shutil
import socket
import subprocess
import sys
import time

import pytest
import torch

import ray_tpu
import ray_tpu_torch

SIDES = (("jax", ray_tpu), ("torch", ray_tpu_torch))
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPP_DIR = os.path.join(REPO, "cpp")
CPU_SERVER = '{"num_cpus": 4, "device": "cpu"}'


def _end_jax_leftovers() -> None:
    """Ends the loops of any JAX serve controller left in this process
    and the runtime they may have started (ROADMAP Queue C): the parity
    tests of the new test files call it before each JAX runtime."""
    from ray_tpu.serve.controller import ServeController

    for obj in gc.get_objects():
        if isinstance(obj, ServeController):
            obj._stopped = True
            obj._health_thread.join(timeout=10)
            obj._autoscale_thread.join(timeout=10)
    if ray_tpu.is_initialized():
        ray_tpu.shutdown()


def _client_mod(core, name="client"):
    return importlib.import_module(f"{core.__name__}.util.client.{name}")


@contextlib.contextmanager
def _served(core, num_cpus: int = 4):
    """``core``'s runtime behind its ClientServer, and a connected
    client."""
    if core is ray_tpu_torch:
        core.init(num_cpus=num_cpus, device="cpu")
    else:
        core.init(num_cpus=num_cpus)
    server = _client_mod(core, "server").ClientServer()
    ctx = _client_mod(core).connect(server.address)
    try:
        yield ctx
    finally:
        ctx.disconnect()
        server.stop()
        core.shutdown()


def _on_both(scenario):
    """``scenario(client, core)`` through each package's server ->
    the port's result, after asserting it equals the JAX one."""
    _end_jax_leftovers()
    out = []
    for _, core in SIDES:
        with _served(core) as client:
            out.append(scenario(client, core))
    assert out[1] == out[0]
    return out[1]


# ----------------------------------------- tests/test_client.py on both


def test_task_roundtrip():
    def scenario(client, core):
        @client.remote
        def add(a, b):
            return a + b

        return client.get(add.remote(2, 3))

    assert _on_both(scenario) == 5


def test_put_get_and_ref_args():
    def scenario(client, core):
        ref = client.put([1, 2, 3])
        got = client.get(ref)

        @client.remote
        def total(xs):
            return sum(xs)

        return got, client.get(total.remote(ref))

    assert _on_both(scenario) == ([1, 2, 3], 6)


def test_wait():
    def scenario(client, core):
        @client.remote
        def fast():
            return 1

        refs = [fast.remote() for _ in range(4)]
        ready, unready = client.wait(refs, num_returns=4, timeout=10)
        return len(ready), len(unready), client.get(ready)

    assert _on_both(scenario) == (4, 0, [1, 1, 1, 1])


def test_multi_returns_and_options():
    def scenario(client, core):
        @client.remote
        def pair():
            return 1, 2

        a, b = pair.options(num_returns=2).remote()
        return client.get([a, b])

    assert _on_both(scenario) == [1, 2]


def test_actor_roundtrip():
    def scenario(client, core):
        @client.remote
        class Counter:
            def __init__(self, start):
                self.n = start

            def incr(self, by=1):
                self.n += by
                return self.n

        c = Counter.remote(10)
        out = [client.get(c.incr.remote()), client.get(c.incr.remote(5))]
        client.kill(c)
        return out

    assert _on_both(scenario) == [11, 16]


def test_task_error_propagates():
    def scenario(client, core):
        @client.remote
        def boom():
            raise ValueError("sad trombone")

        with pytest.raises(ValueError, match="sad trombone") as err:
            client.get(boom.remote())
        return type(err.value).__name__

    assert _on_both(scenario) == "RayTaskError(ValueError)"


def test_server_version():
    def scenario(client, core):
        assert client.server_version == core.__version__
        return client.server_version

    assert _on_both(scenario) == ray_tpu.__version__


class _Counter:
    def __init__(self, start=0):
        self.n = start

    def bump(self):
        self.n += 1
        return self.n


def test_restartable_kill_client_server():
    """kill(no_restart=False) over the wire restarts the actor with its
    original arguments behind the same client handle; a later hard kill
    surfaces the package's RayActorError on the next call."""
    def scenario(client, core):
        errors = importlib.import_module(f"{core.__name__}.exceptions")
        C = client.remote(_Counter, max_restarts=2)
        c = C.remote(5)
        out = [client.get(c.bump.remote()), client.get(c.bump.remote())]

        client.kill(c, no_restart=False)
        deadline = time.monotonic() + 10.0
        value = None
        while time.monotonic() < deadline:
            try:
                value = client.get(c.bump.remote())
                break
            except Exception:
                time.sleep(0.05)  # restart still in flight
        # state reset to the ORIGINAL init args: first bump is 6 again
        out.append(value)
        client.kill(c, no_restart=True)
        time.sleep(0.1)
        with pytest.raises(errors.RayActorError):
            client.get(c.bump.remote())
        return out

    assert _on_both(scenario) == [6, 7, 6]


def _start_server(init_kwargs: str = CPU_SERVER):
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.Popen(
        [sys.executable, "-m", "ray_tpu_torch.util.client.server",
         "--init-kwargs", init_kwargs],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        cwd=REPO, env=env)
    line = proc.stdout.readline().strip()
    return proc, line


def test_init_ray_address_client_mode():
    """ray_tpu_torch.init(address='ray://...') proxies the module-level
    verbs over the wire. The server runs in its OWN process, on the CPU
    through --init-kwargs: this driver has no local runtime, the shape
    client mode exists for."""
    import ray_tpu_torch.core.api as api

    proc, line = _start_server()
    assert line.startswith("CLIENT_SERVER_ADDRESS "), line
    address = line.split()[1]

    # decoration happens BEFORE the client connects (the import-time
    # pattern) — binding to client mode is at call time
    @ray_tpu_torch.remote
    def double(x):
        return x * 2

    try:
        ray_tpu_torch.init(address=address)
        assert ray_tpu_torch.is_initialized()

        refs = [double.remote(i) for i in range(4)]
        ready, rest = ray_tpu_torch.wait(refs, num_returns=4, timeout=30)
        assert not rest
        assert ray_tpu_torch.get(refs) == [0, 2, 4, 6]
        r = ray_tpu_torch.put({"k": 1})
        assert ray_tpu_torch.get(r) == {"k": 1}

        @ray_tpu_torch.remote
        class Counter:
            def __init__(self):
                self.n = 0

            def add(self):
                self.n += 1
                return self.n

            def pid(self):
                return os.getpid()

        c = Counter.remote()
        assert ray_tpu_torch.get(c.add.remote()) == 1
        assert ray_tpu_torch.get(c.pid.remote()) == proc.pid
        ray_tpu_torch.kill(c)
        # client-mode shutdown only disconnects the proxy
        ray_tpu_torch.shutdown()
        assert api._client() is None
        assert not ray_tpu_torch.is_initialized()  # pure client
    finally:
        if api._client() is not None:
            ray_tpu_torch.shutdown()
        proc.terminate()
        proc.wait(timeout=10)


def test_client_mode_refuses_a_local_runtime_both_ways():
    import ray_tpu_torch.core.api as api

    proc, line = _start_server()
    address = line.split()[1]
    try:
        ray_tpu_torch.init(num_cpus=1, device="cpu")
        with pytest.raises(RuntimeError, match="local runtime is active"):
            ray_tpu_torch.init(address=address)
        ray_tpu_torch.shutdown()

        ctx = ray_tpu_torch.init(address=address)
        with pytest.raises(RuntimeError, match="client connection is active"):
            ray_tpu_torch.init(num_cpus=1, device="cpu")
        # refused before the device is resolved: never "no CUDA device"
        with pytest.raises(RuntimeError, match="client connection is active"):
            ray_tpu_torch.init(num_cpus=1)
        with pytest.raises(RuntimeError, match="called twice"):
            ray_tpu_torch.init(address=address)
        assert ray_tpu_torch.init(address=address,
                                  ignore_reinit_error=True) is ctx
        # an API the client does not proxy raises; it never starts a
        # local runtime (on the card) behind the connection
        with pytest.raises(RuntimeError, match="not proxied"):
            ray_tpu_torch.cluster_resources()
        assert api._client() is ctx
        ray_tpu_torch.shutdown()
        assert not ray_tpu_torch.is_initialized()
    finally:
        if api._client() is not None:
            ray_tpu_torch.shutdown()
        proc.terminate()
        proc.wait(timeout=10)


def test_client_server_wants_cuda_unless_told_the_cpu():
    """The server's runtime is on CUDA by default: with no card it
    exits before it announces an address."""
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA: the default device resolves")
    proc, line = _start_server('{"num_cpus": 1}')
    try:
        assert line == ""
        assert proc.wait(timeout=60) != 0
        assert "no CUDA device" in proc.stderr.read()
    finally:
        if proc.poll() is None:
            proc.kill()


# ------------------------------------------------------ frames and devices


def _frame(protocol, obj) -> bytes:
    a, b = socket.socketpair()
    try:
        protocol.send_msg(a, obj)
        a.shutdown(socket.SHUT_WR)
        chunks = []
        while chunk := b.recv(1 << 16):
            chunks.append(chunk)
        return b"".join(chunks)
    finally:
        a.close()
        b.close()


def test_frames_are_the_jax_package_bytes():
    from ray_tpu.util.client import protocol as jproto
    from ray_tpu_torch.util.client import protocol

    msg = {"op": "task_by_name", "name": "math:factorial", "args": (5,),
           "kwargs": {}, "options": {"num_returns": 1}}
    assert _frame(protocol, msg) == _frame(jproto, msg)
    assert protocol.MAX_FRAME == jproto.MAX_FRAME
    a, b = socket.socketpair()
    try:
        jproto.send_msg(a, msg)
        assert protocol.recv_msg(b) == msg
    finally:
        a.close()
        b.close()


def _echo(protocol, obj):
    a, b = socket.socketpair()
    try:
        protocol.send_msg(a, obj)
        return protocol.recv_msg(b)
    finally:
        a.close()
        b.close()


def test_a_tensor_comes_back_on_the_device_it_left():
    from ray_tpu_torch.util.client import protocol

    gen = torch.Generator().manual_seed(0)
    t = {"logits": torch.randn(2, 8, generator=gen),
         "ids": torch.arange(4, dtype=torch.int32),
         "half": torch.randn(3, generator=gen).to(torch.bfloat16)}
    back = _echo(protocol, {"ok": True, "values": [t]})["values"][0]
    for k, v in t.items():
        assert back[k].device == v.device and back[k].dtype == v.dtype
        assert torch.equal(back[k], v)
    if not torch.cuda.is_available():
        import torch.serialization as ser

        saved = ser.location_tag
        ser.location_tag = lambda storage: "cuda:0"
        try:
            a, b = socket.socketpair()
            protocol.send_msg(a, {"ok": True, "values": [torch.ones(2)]})
        finally:
            ser.location_tag = saved
        try:
            # a reader without CUDA raises; the tensor never lands on
            # the CPU in its stead
            with pytest.raises(RuntimeError, match="CUDA"):
                protocol.recv_msg(b)
        finally:
            a.close()
            b.close()


def test_a_tensor_through_the_server_keeps_device_and_bits():
    def scenario(client, core):
        @client.remote
        def scale(x, k):
            return x * k, str(x.device)

        x = torch.arange(6, dtype=torch.float32).reshape(2, 3)
        y, device = client.get(scale.remote(client.put(x), 2.0))
        return y.tolist(), str(y.device), y.dtype, device

    assert _on_both(scenario) == ([[0.0, 2.0, 4.0], [6.0, 8.0, 10.0]],
                                  "cpu", torch.float32, "cpu")


# ----------------------------------- tests/test_cpp_client.py on the port


def _make(target_name: str) -> str:
    if shutil.which("g++") is None:
        pytest.skip("g++ not available")
    build = subprocess.run(["make", "-C", CPP_DIR],
                           capture_output=True, text=True)
    assert build.returncode == 0, build.stderr
    return os.path.join(CPP_DIR, "build", target_name)


@pytest.fixture(scope="module")
def demo_binary():
    return _make("demo")


@pytest.fixture(scope="module")
def cpp_worker_binary():
    return _make("cpp_worker")


@pytest.fixture
def server():
    from ray_tpu_torch.util.client.server import ClientServer

    ray_tpu_torch.init(num_cpus=2, device="cpu")
    srv = ClientServer()
    try:
        yield srv
    finally:
        srv.stop()
        ray_tpu_torch.shutdown()


def test_cpp_demo_end_to_end(demo_binary, server):
    """The C++ client, unchanged, speaks to the port's server."""
    out = subprocess.run([demo_binary, "127.0.0.1", str(server.port)],
                         capture_output=True, text=True, timeout=60)
    assert out.returncode == 0, f"stdout={out.stdout}\nstderr={out.stderr}"
    lines = out.stdout.strip().splitlines()
    assert "get=hello from c++" in lines
    assert "dict n=7 blob_len=1024" in lines
    assert "math.pow=1024" in lines
    assert "len=3" in lines
    assert "ready=2 unready=0" in lines
    assert "error=caught" in lines
    assert "still_alive=hello from c++" in lines
    assert lines[-1] == "DEMO_OK"


def test_python_client_task_by_name(server):
    from ray_tpu_torch.util.client.protocol import recv_msg, send_msg

    sock = socket.create_connection(("127.0.0.1", server.port))
    try:
        send_msg(sock, {"op": "init"})
        assert recv_msg(sock)["ok"]
        send_msg(sock, {"op": "task_by_name", "name": "math:factorial",
                        "args": (5,), "kwargs": {}})
        reply = recv_msg(sock)
        assert reply["ok"]
        send_msg(sock, {"op": "get", "refs": reply["refs"]})
        assert recv_msg(sock)["values"] == [120]
    finally:
        sock.close()


def test_python_submits_to_cpp_worker(cpp_worker_binary):
    from ray_tpu_torch.util.cpp_worker import (
        default_worker_binary,
        start_cpp_worker,
    )

    assert default_worker_binary() == cpp_worker_binary
    worker = start_cpp_worker()
    try:
        assert worker.ping()
        assert worker.list_functions() == ["add", "fib", "upper",
                                           "vec_sum"]
        ray_tpu_torch.init(num_cpus=2, device="cpu")
        try:
            fib = worker.remote_function("fib")
            add = worker.remote_function("add")
            # .remote() composes with the task path; compute runs in
            # the native worker process
            assert ray_tpu_torch.get(fib.remote(30)) == 832040
            assert ray_tpu_torch.get(add.remote(2.5, 4)) == 6.5
            assert ray_tpu_torch.get(
                worker.remote_function("vec_sum").remote(
                    [1.0, 2.0, 3.5])) == 6.5
            assert ray_tpu_torch.get(
                worker.remote_function("upper").remote("abc")) == "ABC"
            refs = [fib.remote(i) for i in range(10)]
            assert ray_tpu_torch.get(refs) == [0, 1, 1, 2, 3, 5, 8, 13,
                                               21, 34]
        finally:
            ray_tpu_torch.shutdown()
    finally:
        worker.close()


def test_cpp_worker_error_propagates(cpp_worker_binary):
    from ray_tpu_torch.util.cpp_worker import (
        CrossLanguageError,
        start_cpp_worker,
    )

    worker = start_cpp_worker(cpp_worker_binary)
    try:
        fn = worker.remote_function("fib")
        with pytest.raises(CrossLanguageError, match="fib wants n >= 0"):
            fn.call(-1)
        with pytest.raises(CrossLanguageError, match="no registered"):
            worker.remote_function("missing").call()
    finally:
        worker.close()


def test_server_main_prints_its_address_and_serves_json_kwargs(tmp_path):
    """main()'s --init-kwargs reach the server's runtime."""
    proc, line = _start_server(json.dumps({"num_cpus": 3,
                                           "device": "cpu"}))
    try:
        from ray_tpu_torch.util.client import connect

        ctx = connect(line.split()[1])
        try:
            @ctx.remote
            def cpus():
                return ray_tpu_torch.cluster_resources()["CPU"]

            assert ctx.get(cpus.remote()) == 3
        finally:
            ctx.disconnect()
    finally:
        proc.terminate()
        proc.wait(timeout=10)


def test_a_view_crosses_the_wire_with_its_whole_storage():
    """Why the card's replies send ``logits[:, -1].clone()``: a pickled
    view carries the storage it views, here 64 times its own bytes."""
    import cloudpickle

    from ray_tpu_torch.util.client import protocol

    logits = torch.randn(2, 64, 256)
    view, copy = logits[:, -1], logits[:, -1].clone()
    assert len(cloudpickle.dumps(view)) > 64 * view.numel() * 4
    assert len(cloudpickle.dumps(copy)) < 2 * copy.numel() * 4
    back = _echo(protocol, {"ok": True, "values": [view]})["values"][0]
    assert torch.equal(back, view)
