"""The port's serving library on the CPU: the contracts of
tests/test_serve.py (modeled on python/ray/serve/tests/test_api.py,
test_autoscaling_policy.py, test_batching.py scenarios), run on
``ray_tpu_torch.serve`` over ``ray_tpu_torch.init(device="cpu")``.
"""

import json
import time
import urllib.request

import pytest

import ray_tpu_torch
from ray_tpu_torch import serve


@pytest.fixture
def serve_instance():
    ray_tpu_torch.init(num_cpus=8, device="cpu")
    try:
        serve.start()
        yield
    finally:
        serve.shutdown()
        ray_tpu_torch.shutdown()


def test_function_deployment(serve_instance):
    @serve.deployment
    def hello(name):
        return f"hello {name}"

    hello.deploy()
    h = hello.get_handle()
    assert ray_tpu_torch.get([h.remote("world")])[0] == "hello world"


def test_class_deployment_and_methods(serve_instance):
    @serve.deployment(num_replicas=2)
    class Counter:
        def __init__(self, start=0):
            self.count = start

        def __call__(self):
            return "called"

        def incr(self, by=1):
            self.count += by
            return self.count

    Counter.deploy(10)
    h = Counter.get_handle()
    assert ray_tpu_torch.get([h.remote()])[0] == "called"
    results = ray_tpu_torch.get([h.incr.remote() for _ in range(4)])
    # two replicas, round robin: each sees two increments from base 10
    assert sorted(results) == [11, 11, 12, 12]


def test_deploy_scale_up_down(serve_instance):
    @serve.deployment(num_replicas=1)
    def f():
        return 1

    f.deploy()
    controller = ray_tpu_torch.get_actor("SERVE_CONTROLLER")
    _, replicas = ray_tpu_torch.get(controller.get_replicas.remote("f"))
    assert len(replicas) == 1
    f.options(num_replicas=3).deploy()
    _, replicas = ray_tpu_torch.get(controller.get_replicas.remote("f"))
    assert len(replicas) == 3
    f.options(num_replicas=1).deploy()
    _, replicas = ray_tpu_torch.get(controller.get_replicas.remote("f"))
    assert len(replicas) == 1


def test_rolling_update_user_config(serve_instance):
    @serve.deployment(version="v1")
    class Model:
        def __init__(self):
            self.threshold = 0

        def reconfigure(self, config):
            self.threshold = config["threshold"]

        def __call__(self):
            return self.threshold

    Model.options(user_config={"threshold": 5}).deploy()
    h = Model.get_handle()
    assert ray_tpu_torch.get([h.remote()])[0] == 5
    Model.options(version="v2", user_config={"threshold": 9}).deploy()
    assert ray_tpu_torch.get([h.remote()])[0] == 9


def test_get_and_list_deployments(serve_instance):
    @serve.deployment(name="dep_a")
    def a():
        return "a"

    a.deploy()
    assert "dep_a" in serve.list_deployments()
    d = serve.get_deployment("dep_a")
    assert d.name == "dep_a"
    d.delete()
    assert "dep_a" not in serve.list_deployments()


def test_batching(serve_instance):
    @serve.deployment
    class BatchModel:
        def __init__(self):
            self.batch_sizes = []

        @serve.batch(max_batch_size=4, batch_wait_timeout_s=0.05)
        def handle_batch(self, xs):
            self.batch_sizes.append(len(xs))
            return [x * 2 for x in xs]

        def __call__(self, x):
            return self.handle_batch(x)

        def sizes(self):
            return self.batch_sizes

    BatchModel.deploy()
    h = BatchModel.get_handle()
    refs = [h.remote(i) for i in range(8)]
    assert sorted(ray_tpu_torch.get(refs)) == [0, 2, 4, 6, 8, 10, 12, 14]
    sizes = ray_tpu_torch.get([h.sizes.remote()])[0]
    assert max(sizes) > 1  # batching actually coalesced requests


def test_batching_queues_per_replica(serve_instance):
    """Two replicas share the process on the thread tier; a batch holds
    only its own replica's requests and is answered by that replica
    (the reference keeps one queue per decorated function, so a batch
    could mix both replicas' requests and one replica answered all)."""

    @serve.deployment(num_replicas=2)
    class Tagged:
        def __init__(self):
            self.sizes = []

        @serve.batch(max_batch_size=4, batch_wait_timeout_s=0.2)
        def __call__(self, items):
            self.sizes.append(len(items))
            return [(id(self), x) for x in items]

        def ident(self):
            return id(self)

        def seen(self):
            return self.sizes

    Tagged.deploy()
    controller = ray_tpu_torch.get_actor("SERVE_CONTROLLER")
    _, replicas = ray_tpu_torch.get(controller.get_replicas.remote("Tagged"))
    idents = ray_tpu_torch.get([r.handle_request.remote("ident", (), {})
                                for r in replicas])
    refs = [(r, i, r.handle_request.remote("__call__", (i,), {}))
            for i in range(4) for r in replicas]
    for replica, i, ref in refs:
        owner = idents[replicas.index(replica)]
        assert ray_tpu_torch.get(ref) == (owner, i)
    sizes = ray_tpu_torch.get([r.handle_request.remote("seen", (), {})
                               for r in replicas])
    assert [sum(s) for s in sizes] == [4, 4]
    assert all(n <= 4 for s in sizes for n in s)


def test_kv_stores_round_trip(serve_instance, tmp_path):
    """The controller's checkpoint stores: the runtime's internal KV and
    the filesystem store, whose files the JAX package's store reads."""
    from ray_tpu.serve.kv_store import LocalDiskKVStore as JaxDiskKV
    from ray_tpu_torch.serve.kv_store import KVStore, LocalDiskKVStore

    root = str(tmp_path / "kv")
    for store in (KVStore(), LocalDiskKVStore(root)):
        for key, value in ((b"a/1", b"x"), (b"a/2", b"y"), (b"b/1", b"z")):
            store.put(key, value)
        assert store.get(b"a/1") == b"x" and store.get(b"none") is None
        assert sorted(store.keys(b"a/")) == [b"a/1", b"a/2"]
        store.delete(b"a/1")
        store.delete(b"a/1")  # idempotent
        assert store.get(b"a/1") is None
    assert sorted(JaxDiskKV(root).keys()) == [b"a/2", b"b/1"]
    assert JaxDiskKV(root).get(b"b/1") == b"z"


def test_controller_loops_end_with_their_runtime():
    """A controller's health and autoscale loops end when the runtime it
    serves in shuts down, so a killed controller's threads cannot start
    a new runtime through a remote call (the JAX package's loops run on
    and restart one every few ticks)."""
    from ray_tpu_torch.serve.controller import ServeController

    ray_tpu_torch.init(num_cpus=2, device="cpu")
    try:
        controller = ServeController()
    finally:
        ray_tpu_torch.shutdown()
    for thread in (controller._health_thread, controller._autoscale_thread):
        thread.join(timeout=5)
        assert not thread.is_alive()
    assert not ray_tpu_torch.is_initialized()


def test_autoscaling_scales_up(serve_instance):
    @serve.deployment(autoscaling_config={
        "min_replicas": 1, "max_replicas": 3,
        "target_num_ongoing_requests_per_replica": 1,
    })
    class Slow:
        def __call__(self):
            time.sleep(0.6)
            return 1

    Slow.deploy()
    h = Slow.get_handle()
    refs = [h.remote() for _ in range(6)]
    controller = ray_tpu_torch.get_actor("SERVE_CONTROLLER")
    deadline = time.time() + 5
    scaled = False
    while time.time() < deadline:
        _, replicas = ray_tpu_torch.get(controller.get_replicas.remote("Slow"))
        if len(replicas) > 1:
            scaled = True
            break
        time.sleep(0.1)
    ray_tpu_torch.get(refs)
    assert scaled, "autoscaler never scaled up under load"


def test_http_proxy(serve_instance):
    @serve.deployment(route_prefix="/echo")
    def echo(payload=None):
        return {"got": payload}

    echo.deploy()
    controller = ray_tpu_torch.get_actor("SERVE_CONTROLLER")
    proxy = serve.start_http_proxy(controller)
    addr = ray_tpu_torch.get([proxy.address.remote()])[0]
    req = urllib.request.Request(
        addr + "/echo", data=json.dumps({"x": 1}).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=10) as resp:
        body = json.loads(resp.read())
    assert body == {"got": {"x": 1}}
    with pytest.raises(urllib.error.HTTPError):
        urllib.request.urlopen(addr + "/nope", timeout=10)


def test_serve_run_entrypoint(serve_instance):
    """serve.run deploys and returns a live handle (reference: 2.x
    serve.run entrypoint), for decorated and bare targets alike."""
    from ray_tpu_torch import serve

    @serve.deployment(num_replicas=1)
    def greeter(name):
        return f"hi {name}"

    handle = serve.run(greeter)
    assert ray_tpu_torch.get(handle.remote("ada")) == "hi ada"

    class Doubler:
        def __call__(self, x):
            return x * 2

    handle2 = serve.run(Doubler, name="doubler")
    assert ray_tpu_torch.get(handle2.remote(21)) == 42
    assert "doubler" in serve.list_deployments()


def test_controller_failover_recovers_deployments(serve_instance):
    """Kill the controller mid-serving: a restarted controller recovers
    every deployment from its KV checkpoint, re-attaches the replicas
    that survived (same actor names), and routing works again
    (reference: serve/controller.py checkpoint via storage/kv_store.py;
    deployment_state.py recovers replicas by name)."""
    from ray_tpu_torch.serve.api import _CONTROLLER_NAME

    @serve.deployment(num_replicas=2)
    def echo(x=None):
        return f"echo:{x}"

    echo.deploy()
    h = echo.get_handle()
    assert ray_tpu_torch.get([h.remote("a")])[0] == "echo:a"

    controller = ray_tpu_torch.get_actor(_CONTROLLER_NAME)
    old_replicas = ray_tpu_torch.get(
        controller.get_replicas.remote("echo"))[1]
    assert len(old_replicas) == 2
    ray_tpu_torch.kill(controller)  # CRASH the control plane

    # a fresh controller (same name) recovers from the checkpoint
    new_controller = serve.start()
    assert new_controller is not None
    deps = ray_tpu_torch.get(new_controller.list_deployments.remote())
    assert deps == ["echo"]
    version, replicas = ray_tpu_torch.get(
        new_controller.get_replicas.remote("echo"))
    assert len(replicas) == 2  # re-attached, not restarted

    # the OLD handle still routes (ControllerRef re-resolves the name)
    assert ray_tpu_torch.get([h.remote("b")])[0] == "echo:b"
    # and new handles work too
    h2 = echo.get_handle()
    assert ray_tpu_torch.get([h2.remote("c")])[0] == "echo:c"


def test_controller_failover_restarts_dead_replicas(serve_instance):
    """Controller AND one replica die: recovery re-attaches the
    survivor and starts a fresh replica to meet the target."""
    from ray_tpu_torch.serve.api import _CONTROLLER_NAME

    @serve.deployment(num_replicas=2)
    def pong(x=None):
        return "pong"

    pong.deploy()
    controller = ray_tpu_torch.get_actor(_CONTROLLER_NAME)
    replicas = ray_tpu_torch.get(controller.get_replicas.remote("pong"))[1]
    ray_tpu_torch.kill(replicas[0])
    ray_tpu_torch.kill(controller)

    new_controller = serve.start()
    deadline = time.monotonic() + 30.0
    while time.monotonic() < deadline:
        _, now = ray_tpu_torch.get(new_controller.get_replicas.remote("pong"))
        if len(now) == 2:
            break
        time.sleep(0.1)
    _, now = ray_tpu_torch.get(new_controller.get_replicas.remote("pong"))
    assert len(now) == 2
    h = pong.get_handle()
    assert ray_tpu_torch.get([h.remote()])[0] == "pong"
