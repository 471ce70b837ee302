"""The port's dashboards against the JAX package's, on the CPU.

Each scenario of tests/test_observability.py::test_dashboard_endpoints,
::test_dashboard_serves_web_ui and tests/test_pubsub.py::
test_dashboard_head_aggregates_cluster runs on both packages, one
runtime after the other, and the payloads are compared: the same
routes, the same actor names and states, the same node count with equal
alive flags and resource keys, LOG lines that carry the marker,
``/metrics`` naming ``ray_tpu``, 404 for an unknown route and ``?n=``
bounding ``/api/logs`` alike.

Then the slice as a whole: ``ModelConfig.debug()`` served by an actor on
each package's ``ProcessCluster`` (the port's with ``gcs_device="cpu"``)
with the JAX package's weights (``params_from_jax`` for the port), each
actor seen ALIVE in its own head's ``/api/actors`` and its marker lines
in ``/api/logs``, and the logits equal within 1e-4 absolute and
relative, the whole-model fp32 tolerance of tests/test_torch_model.py.
The thread roots the port's head reports for its raylet are labels that
the port's raycheck derives statically. Every cluster passes a small
``object_store_memory``: the port's segments are always prefaulted.
"""

import json
import os
import sys
import time
import urllib.error
import urllib.request

import cloudpickle
import numpy as np
import pytest

import ray_tpu
import ray_tpu_torch
from ray_tpu.cluster.process_cluster import ClusterClient as JaxClusterClient
from ray_tpu.cluster.process_cluster import ProcessCluster as JaxProcessCluster
from ray_tpu.observability.dashboard import (
    start_dashboard as jax_start_dashboard,
)
from ray_tpu.observability.dashboard_head import (
    DashboardHead as JaxDashboardHead,
)
from ray_tpu_torch.cluster.process_cluster import (
    ClusterClient,
    ProcessCluster,
)
from ray_tpu_torch.observability import DashboardHead
from ray_tpu_torch.observability.dashboard import start_dashboard

# the actors run in the raylets' workers, which cannot import tests/
cloudpickle.register_pickle_by_value(sys.modules[__name__])

STORE_BYTES = 64 << 20
MODEL_TOL = dict(atol=1e-4, rtol=1e-4)
MARKER = "hello-from-worker"
SERVE_MARKER = "served-debug-request"
THREAD_ROUTES = ("/api/cluster_status", "/api/nodes", "/api/actors",
                 "/api/placement_groups", "/api/objects", "/api/events")
HEAD_ROUTES = ("/healthz", "/api/cluster", "/api/nodes", "/api/actors",
               "/api/logs", "/api/jobs")


def _get(url, timeout=10):
    """(status, content type, body) of one GET; an HTTP error's status
    instead of a raise."""
    try:
        with urllib.request.urlopen(url, timeout=timeout) as r:
            return r.status, r.headers["Content-Type"], r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.headers.get("Content-Type"), e.read()


def _json(url):
    status, ctype, body = _get(url)
    assert status == 200 and ctype == "application/json", (url, status)
    return json.loads(body)


def _wait_for(pred, timeout=30.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(0.05)
    return False


# ------------------------------------------------- the thread-tier dashboard


def _thread_tier_payloads(rt, start):
    """Serve a named actor, start the package's dashboard and read every
    route of it, /metrics and an unknown route."""

    @rt.remote
    class D:
        def ping(self):
            return 1

    d = D.options(name="dash_actor").remote()
    assert rt.get([d.ping.remote()]) == [1]
    dash = start()
    try:
        out = {route: _get(dash.url + route) for route in THREAD_ROUTES}
        out["/metrics"] = _get(dash.url + "/metrics")
        out["/nope"] = _get(dash.url + "/nope")
        return out
    finally:
        dash.stop()


@pytest.fixture(scope="module")
def thread_tier():
    """{package: route -> (status, content type, body)}, the JAX
    runtime's first, then the port's on the CPU."""
    out = {}
    if ray_tpu.is_initialized():
        ray_tpu.shutdown()
    ray_tpu.init(num_cpus=8)
    try:
        out["jax"] = _thread_tier_payloads(ray_tpu, jax_start_dashboard)
    finally:
        ray_tpu.shutdown()
    ray_tpu_torch.init(num_cpus=8, device="cpu")
    try:
        out["torch"] = _thread_tier_payloads(ray_tpu_torch, start_dashboard)
    finally:
        ray_tpu_torch.shutdown()
    return out


def test_dashboard_endpoints_like_jax(thread_tier):
    jax, port = thread_tier["jax"], thread_tier["torch"]
    assert set(port) == set(jax)
    for route in THREAD_ROUTES:
        assert port[route][:2] == jax[route][:2] == \
            (200, "application/json"), route
        assert json.loads(port[route][2]) is not None
    assert port["/nope"][0] == jax["/nope"][0] == 404
    assert port["/metrics"][:2] == jax["/metrics"][:2]
    assert b"ray_tpu" in port["/metrics"][2]


def test_dashboard_actors_like_jax(thread_tier):
    def names_states(side):
        actors = json.loads(thread_tier[side]["/api/actors"][2])
        return sorted((a["Name"], a["State"]) for a in actors.values())

    assert names_states("torch") == names_states("jax")
    assert ("dash_actor", "ALIVE") in names_states("torch")


def test_dashboard_nodes_like_jax(thread_tier):
    def nodes(side, route):
        table = json.loads(thread_tier[side][route][2])
        rows = table["nodes"] if route == "/api/cluster_status" else table
        return sorted((n["Alive"], sorted(n["Resources"]))
                      for n in rows)

    for route in ("/api/nodes", "/api/cluster_status"):
        assert nodes("torch", route) == nodes("jax", route)
    status = {side: json.loads(thread_tier[side]["/api/cluster_status"][2])
              for side in ("jax", "torch")}
    for key in ("cluster_resources", "available_resources"):
        assert sorted(status["torch"][key]) == sorted(status["jax"][key])


# ------------------------------------------------- the process-tier head


class _Chatty:
    def speak(self):
        print(MARKER, file=sys.stderr, flush=True)
        return "spoke"


class _DebugServer:
    """The debug model behind an actor of either package; each request
    prints one marker line."""

    def __init__(self, side, params_np):
        self.side = side
        if side == "jax":
            from ray_tpu.models import transformer as jtfm
            from ray_tpu.models.training import build_forward as jfwd

            self.params = params_np
            self.fwd = jfwd(jtfm.ModelConfig.debug(remat=False))
        else:
            from ray_tpu_torch.models import transformer as ttfm
            from ray_tpu_torch.models.convert import params_from_jax
            from ray_tpu_torch.models.training import build_forward

            cfg = ttfm.ModelConfig.debug()
            self.params = params_from_jax(params_np, cfg, "cpu")
            self.fwd = build_forward(cfg, device="cpu")

    def forward(self, tokens, i):
        print(f"{SERVE_MARKER} {i}", file=sys.stderr, flush=True)
        out = self.fwd(self.params, tokens)
        return np.asarray(out) if self.side == "jax" else out.numpy()


@pytest.fixture(scope="module")
def model_inputs():
    import jax

    from ray_tpu.models import transformer as jtfm

    jcfg = jtfm.ModelConfig.debug(remat=False)
    params_np = jax.tree.map(
        np.asarray, jtfm.init_params(jcfg, jax.random.PRNGKey(4)))
    tokens = np.random.default_rng(9).integers(
        0, jcfg.vocab_size, size=(2, 32)).astype(np.int32)
    return params_np, tokens


def _head_scenario(side, cluster_cls, client_cls, head_cls, model_inputs,
                   cluster_kwargs):
    """One package's cluster and head: the chatty actor, the debug
    model's actor serving two requests, and every payload read back."""
    params_np, tokens = model_inputs
    cluster = cluster_cls(heartbeat_period_ms=50, num_heartbeats_timeout=10,
                          **cluster_kwargs)
    try:
        cluster.add_node(num_cpus=2, object_store_memory=STORE_BYTES)
        cluster.wait_for_nodes(1)
        client = client_cls(cluster.gcs_address)
        head = head_cls(cluster.gcs_address)
        try:
            url = head.url
            out = {"page": _get(url + "/"), "nope": _get(url + "/nope")}
            out["healthz"] = _json(url + "/healthz")
            chatty = client.create_actor(_Chatty)
            assert chatty.speak() == "spoke"
            server = client.create_actor(_DebugServer,
                                         args=(side, params_np))
            out["logits"] = [server.forward(tokens, i) for i in range(2)]
            assert _wait_for(lambda: sum(
                SERVE_MARKER in e["line"] or MARKER in e["line"]
                for e in _json(url + "/api/logs?n=500")) >= 3), \
                _json(url + "/api/logs?n=500")
            for route in HEAD_ROUTES:
                out[route] = _json(url + route)
            logs = _json(url + "/api/logs?n=500")
            out["logs"] = logs
            out["logs?n"] = {n: len(_json(url + f"/api/logs?n={n}"))
                             for n in (0, 1, 2, len(logs) + 10)}
            client.close()
            return out
        finally:
            head.stop()
    finally:
        cluster.shutdown()


@pytest.fixture(scope="module")
def heads(model_inputs):
    """{package: payloads}, the JAX package's cluster first, then the
    port's."""
    return {
        "jax": _head_scenario("jax", JaxProcessCluster, JaxClusterClient,
                              JaxDashboardHead, model_inputs, {}),
        "torch": _head_scenario("torch", ProcessCluster, ClusterClient,
                                DashboardHead, model_inputs,
                                {"gcs_device": "cpu"}),
    }


def test_dashboard_serves_web_ui_like_jax(heads):
    for side, title in (("jax", "ray_tpu dashboard"),
                        ("torch", "ray_tpu_torch dashboard")):
        status, ctype, body = heads[side]["page"]
        assert status == 200 and ctype.startswith("text/html")
        assert title in body.decode()
        assert "/api/nodes" in body.decode()  # consumes the REST surface
    assert heads["torch"]["nope"][0] == heads["jax"]["nope"][0] == 404


def test_dashboard_head_aggregates_cluster_like_jax(heads):
    jax, port = heads["jax"], heads["torch"]
    assert port["healthz"] == jax["healthz"] == {"ok": True}

    def view(side):
        nodes = heads[side]["/api/cluster"]["nodes"].values()
        return sorted((n["alive"], sorted(n["resources"])) for n in nodes)

    assert view("torch") == view("jax")
    assert any(alive for alive, _ in view("torch"))

    def agents(side):
        return [n["agent"] for n in heads[side]["/api/nodes"]
                if n["alive"] and "agent" in n]

    assert len(agents("torch")) == len(agents("jax")) == 1
    for agent in agents("torch") + agents("jax"):
        assert agent["pid"] != 0 and agent["rss_kb"] > 0
    assert sorted(heads["torch"]["/api/nodes"][0]) == \
        sorted(heads["jax"]["/api/nodes"][0])


def test_dashboard_head_actors_like_jax(heads):
    def states(side):
        return sorted((a["name"], a["state"])
                      for a in heads[side]["/api/actors"])

    assert states("torch") == states("jax") == [("", "ALIVE")] * 2
    assert sorted(heads["torch"]["/api/actors"][0]) == \
        sorted(heads["jax"]["/api/actors"][0])


def test_dashboard_head_logs_like_jax(heads):
    def marked(side):
        lines = [e["line"] for e in heads[side]["logs"]]
        return ([ln for ln in lines if MARKER in ln],
                sorted(ln for ln in lines if SERVE_MARKER in ln))

    assert marked("torch") == marked("jax")
    assert marked("torch") == ([MARKER], [f"{SERVE_MARKER} {i}"
                                          for i in range(2)])
    for side in ("jax", "torch"):
        assert all("node_id" in e for e in heads[side]["logs"])
    n = heads["torch"]["logs?n"]
    assert n[0] == 0 and n[1] == 1 and n[2] == 2
    assert [heads["jax"]["logs?n"][k] for k in (0, 1, 2)] == [0, 1, 2]
    # past the ring's contents ?n= gives every line, on both
    assert max(n.values()) == len(heads["torch"]["logs"])
    assert max(heads["jax"]["logs?n"].values()) == len(heads["jax"]["logs"])


def test_dashboard_head_jobs_route_is_empty_on_both(heads):
    assert heads["torch"]["/api/jobs"] == heads["jax"]["/api/jobs"] == []


def test_debug_model_served_through_both_heads(heads, model_inputs):
    import jax.numpy as jnp

    from ray_tpu.models import transformer as jtfm
    from ray_tpu.models.training import build_forward as jfwd

    params_np, tokens = model_inputs
    ref = np.asarray(jfwd(jtfm.ModelConfig.debug(remat=False))(
        params_np, jnp.asarray(tokens)))
    for side in ("jax", "torch"):
        logits = heads[side]["logits"]
        assert len(logits) == 2
        for got in logits:
            assert got.shape == ref.shape and np.isfinite(got).all()
            np.testing.assert_allclose(got, ref, **MODEL_TOL)
    for a, b in zip(heads["torch"]["logits"], heads["jax"]["logits"]):
        np.testing.assert_allclose(a, b, **MODEL_TOL)


def test_head_thread_roots_are_raychecks_static_labels(heads):
    """Every named thread root the port's head reports for its raylet is
    a label the port's raycheck derives from ``ray_tpu_torch/``; lambda
    roots have no static name."""
    from ray_tpu_torch.tools import raycheck
    from ray_tpu_torch.tools.raycheck import facts

    pkg = os.path.dirname(os.path.abspath(ray_tpu_torch.__file__))
    static = {r.label for r in
              facts.Program(raycheck.load_tree(pkg), root=pkg).thread_roots}
    roots = heads["torch"]["/api/nodes"][0]["threads"]
    assert roots, "the raylet reported no thread"
    named = {label for label in roots.values() if "<lambda>" not in label}
    assert named and named <= static, sorted(named - static)
    assert "raylet_server.RayletServer._heartbeat_loop" in named
