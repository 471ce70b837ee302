"""The port's runtime on its thread-worker tier, on the CPU.

``ray_tpu_torch.init(device="cpu")`` brings up the in-process cluster;
tasks, actors, get/wait and multi-node clusters behave as ray_tpu's do.
The model-serving test is the slice's end-to-end path at a small size:
an actor holds the port's debug transformer (the JAX package's weights,
converted) and answers ``forward.remote(tokens)`` with logits equal to
JAX ``build_forward``'s within 1e-4 absolute and relative — the whole-
model fp32 tolerance of tests/test_torch_model.py. Every test tears the
port's runtime down in its own fixture; nothing here reads host uptime.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ray_tpu_torch
from ray_tpu_torch.cluster_utils import Cluster


@pytest.fixture(autouse=True)
def _no_tf32():
    """Full-fp32 matmuls for the comparison (the default, set here so the
    tolerances do not rest on a default)."""
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved


@pytest.fixture
def port_rt():
    rt = ray_tpu_torch.init(num_cpus=4, device="cpu")
    try:
        yield rt
    finally:
        ray_tpu_torch.shutdown()


@pytest.fixture
def port_cluster():
    cluster = Cluster(head_node_args={"num_cpus": 2, "device": "cpu"})
    try:
        yield cluster
    finally:
        cluster.shutdown()


def test_tasks_get_wait(port_rt):
    assert port_rt.device == torch.device("cpu")

    @ray_tpu_torch.remote
    def square(x):
        return x * x

    refs = [square.remote(i) for i in range(20)]
    assert ray_tpu_torch.get(refs, timeout=60) == [i * i for i in range(20)]
    ready, rest = ray_tpu_torch.wait(refs, num_returns=5, timeout=10)
    assert len(ready) == 5 and len(rest) == 15
    put = ray_tpu_torch.put(np.arange(4))
    assert ray_tpu_torch.get(square.remote(put), timeout=60).tolist() == [
        0, 1, 4, 9]


def test_actor_state_and_errors(port_rt):
    @ray_tpu_torch.remote
    class Counter:
        def __init__(self, start):
            self.n = start

        def add(self, k):
            self.n += k
            return self.n

        def boom(self):
            raise ValueError("bad")

    c = Counter.remote(10)
    assert ray_tpu_torch.get([c.add.remote(1) for _ in range(3)],
                             timeout=60) == [11, 12, 13]
    with pytest.raises(ValueError, match="bad"):
        ray_tpu_torch.get(c.boom.remote(), timeout=60)
    ray_tpu_torch.kill(c)
    with pytest.raises(ray_tpu_torch.exceptions.RayActorError):
        ray_tpu_torch.get(c.add.remote(1), timeout=10)


def test_killed_actor_lets_go_of_its_instance(port_rt):
    """kill() frees the actor's instance while the runtime runs on, as a
    killed worker process does: an actor holding tensors (an RLlib
    rollout worker's policy on the card) gives them back at kill(), not
    at shutdown. The dead actor stays listed."""
    import gc
    import weakref

    instances = []

    @ray_tpu_torch.remote
    class Holder:
        def __init__(self):
            self.weights = torch.zeros(4)
            instances.append(weakref.ref(self))

        def ping(self):
            return 1

    h = Holder.remote()
    assert ray_tpu_torch.get(h.ping.remote(), timeout=60) == 1
    assert instances[0]() is not None
    aid = h._actor_id
    ray_tpu_torch.kill(h)
    gc.collect()
    assert instances[0]() is None
    record = port_rt.actor_directory.get(aid)
    assert record is not None and record.state.name == "DEAD"


def test_cluster_add_node_spreads_work(port_cluster):
    for _ in range(3):
        port_cluster.add_node(num_cpus=2, resources={"pin": 1.0})

    @ray_tpu_torch.remote(resources={"pin": 1.0})
    def where():
        import time

        time.sleep(0.05)
        return ray_tpu_torch.get_runtime_context().get_node_id()

    nodes = set(ray_tpu_torch.get([where.remote() for _ in range(9)],
                                  timeout=60))
    workers = {n.node_id.hex() for n in port_cluster.worker_nodes}
    assert nodes <= workers and len(nodes) == 3
    assert ray_tpu_torch.cluster_resources()["CPU"] == 8.0


def test_cut_subsystems_raise(port_rt):
    """Runtime environments were cut from the port until they were
    ported: a thread-tier task now runs under its env_vars, and the
    caller's environment is restored after it."""
    @ray_tpu_torch.remote(runtime_env={"env_vars": {"RT_THREAD_VAR": "1"}})
    def f():
        return os.environ.get("RT_THREAD_VAR")

    assert ray_tpu_torch.get(f.remote(), timeout=30) == "1"
    assert os.environ.get("RT_THREAD_VAR") is None


def test_actor_serves_debug_model_like_jax(port_rt):
    from ray_tpu.models import transformer as jtfm
    from ray_tpu.models.training import build_forward as j_build_forward
    from ray_tpu_torch.models import transformer as ttfm
    from ray_tpu_torch.models.convert import params_from_jax
    from ray_tpu_torch.models.training import build_forward

    jcfg = jtfm.ModelConfig.debug(remat=False)
    jparams = jtfm.init_params(jcfg, jax.random.PRNGKey(4))
    params_np = jax.tree.map(np.asarray, jparams)
    tokens = np.random.default_rng(9).integers(
        0, jcfg.vocab_size, size=(2, 96)).astype(np.int32)
    ref = np.asarray(j_build_forward(jcfg)(jparams, jnp.asarray(tokens)))

    @ray_tpu_torch.remote
    class ModelServer:
        def __init__(self, params_np):
            self.cfg = ttfm.ModelConfig.debug()
            self.params = params_from_jax(params_np, self.cfg, "cpu")
            self.fwd = build_forward(self.cfg, device="cpu")

        def forward(self, tokens):
            return self.fwd(self.params, tokens)

    server = ModelServer.remote(params_np)
    logits = ray_tpu_torch.get([server.forward.remote(tokens)
                                for _ in range(2)], timeout=120)
    for out in logits:
        np.testing.assert_allclose(out.numpy(), ref, atol=1e-4, rtol=1e-4)


def test_pending_placement_group_is_placed_when_resources_free(port_rt,
                                                               monkeypatch):
    """A pending placement group is placed as soon as resources that fit
    it are freed, with no task finishing after: by another group's
    removal, and by a free that lands while the group is tried on a view
    taken before it. The JAX package's manager leaves the group pending
    in both cases until some task ends; a Tune trial whose Trainer waited
    so for a card share timed out (30 s) with the card free."""
    from ray_tpu_torch.util.placement_group import (
        placement_group,
        remove_placement_group,
    )

    hold = placement_group([{"CPU": 4}])
    assert hold.wait(5)
    waiting = placement_group([{"CPU": 2}])
    assert not waiting.wait(0.2)
    remove_placement_group(hold)
    assert waiting.wait(5)

    mgr = port_rt.pg_manager
    real = mgr._try_place
    armed = [True]

    def try_then_free(pg):
        placed = real(pg)  # 2 of 4 CPUs free: the 3-CPU group does not fit
        if armed and not placed:
            armed.clear()
            remove_placement_group(waiting)  # frees 2 during the try
        return placed

    monkeypatch.setattr(mgr, "_try_place", try_then_free)
    late = placement_group([{"CPU": 3}])
    assert not armed and late.wait(5)
    remove_placement_group(late)
