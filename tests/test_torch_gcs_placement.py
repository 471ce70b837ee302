"""The GCS actor-burst placer (A3) and the placement-group packer, held to
the JAX package on the CPU, and the device rule of a control-plane
process.

Seeded node views (8, 64 and 256 nodes with CPU, GPU, memory and a
custom resource, partly used) and bursts of 16 to 4,096 actors in 1, 4
and 32 demand classes go through the reference's
``GcsService._batch_assign_actors`` (JAX on the CPU) and the port's
(torch on the CPU), state-only, as tests/test_device_scheduler_live.py
builds the GCS. With ``scheduler_device_solve_min_cells`` 0 both take
their fused solve; at the default (8,192 cells) the smaller views take
numpy in both. The maps must be equal key for key (tolerance 0). The
same views go through ``_pack_bundles`` for every strategy.
"""

import os
import subprocess
import sys
import threading

import numpy as np
import pytest

from ray_tpu._private.config import Config as RefConfig
from ray_tpu.cluster import gcs_server as ref_gcs
from ray_tpu_torch._private.config import Config as PortConfig
from ray_tpu_torch.cluster import gcs_server as port_gcs


def _views(seed, num_nodes):
    """[(node_id, resources, available)]: every node has CPUs, a third
    have GPUs, a quarter a custom resource; availability is a seeded
    part of capacity."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(num_nodes):
        res = {"CPU": float(rng.choice([4, 8, 16, 32])),
               "memory": float(rng.choice([16, 32, 64])) * 2 ** 30}
        if i % 3 == 0:
            res["GPU"] = float(rng.choice([1, 2, 4, 8]))
        if i % 4 == 1:
            res["accel_slot"] = float(rng.integers(1, 5))
        avail = {k: float(np.floor(v * rng.uniform(0.3, 1.0)))
                 if k != "memory" else v * rng.uniform(0.3, 1.0)
                 for k, v in res.items()}
        out.append((f"node{i:04d}", res, avail))
    return out


def _demands(seed, num_classes):
    rng = np.random.default_rng(seed + 1)
    out = []
    for c in range(num_classes):
        d = {"CPU": float(rng.choice([0.25, 0.5, 1, 2]))}
        if c % 3 == 1:
            d["GPU"] = float(rng.choice([0.5, 1]))
        if c % 4 == 2:
            d["memory"] = float(rng.choice([1, 2, 4])) * 2 ** 30
        if c % 5 == 3:
            d["accel_slot"] = 1.0
        d["CPU"] += c * 1e-3  # distinct classes even where draws repeat
        out.append(d)
    return out


def _gcs(module, views):
    gcs = module.GcsService.__new__(module.GcsService)  # state-only
    gcs._lock = threading.RLock()
    gcs._nodes = {}
    for nid, res, avail in views:
        rec = module._NodeRecord(nid, f"127.0.0.1:{len(gcs._nodes)}", res)
        rec.available = dict(avail)
        gcs._nodes[nid] = rec
    return gcs


def _burst(module, demands, num_actors):
    return [module._ActorRecord(f"a{i:05d}", b"", b"",
                                demands[i % len(demands)], 0)
            for i in range(num_actors)]


@pytest.fixture
def min_cells(monkeypatch):
    """Set ``scheduler_device_solve_min_cells`` in both packages."""
    def set_(value):
        if value is None:
            monkeypatch.delenv("RAY_TPU_scheduler_device_solve_min_cells",
                               raising=False)
        else:
            monkeypatch.setenv("RAY_TPU_scheduler_device_solve_min_cells",
                               str(value))
        RefConfig.reset()
        PortConfig.reset()

    yield set_
    monkeypatch.delenv("RAY_TPU_scheduler_device_solve_min_cells",
                       raising=False)
    RefConfig.reset()
    PortConfig.reset()


CASES = [  # (seed, nodes, classes, actors)
    (0, 8, 1, 16),
    (1, 8, 4, 64),
    (2, 64, 4, 512),
    (3, 64, 32, 1024),
    (4, 256, 1, 4096),
    (5, 256, 32, 4096),
]


@pytest.mark.parametrize("route", ["fused", "default"])
@pytest.mark.parametrize("seed,num_nodes,num_classes,num_actors", CASES)
def test_batch_assign_actors_matches_reference(
        min_cells, route, seed, num_nodes, num_classes, num_actors):
    min_cells(0 if route == "fused" else None)
    views = _views(seed, num_nodes)
    demands = _demands(seed, num_classes)
    ref = _gcs(ref_gcs, views)._batch_assign_actors(
        _burst(ref_gcs, demands, num_actors))
    port_svc = _gcs(port_gcs, views)
    port_svc.device = "cpu"
    port = port_svc._batch_assign_actors(
        _burst(port_gcs, demands, num_actors))
    assert port == ref
    assert len(port) > 0
    # the solve never places past a node's availability
    used = {}
    by_id = {f"a{i:05d}": demands[i % len(demands)]
             for i in range(num_actors)}
    for aid, nid in port.items():
        for k, v in by_id[aid].items():
            used[(nid, k)] = used.get((nid, k), 0.0) + v
    avail = {nid: a for nid, _, a in views}
    for (nid, k), v in used.items():
        assert v <= avail[nid].get(k, 0.0) + 1e-6


def test_fused_route_runs_the_torch_solve(min_cells):
    """At threshold 0 the port's burst goes through
    ``schedule_tick_fused`` on the instance's device; under the default
    threshold (8 nodes x 1 class = 8 cells) it does not."""
    from ray_tpu_torch.scheduler.policy import shared_batched_policy

    policy = shared_batched_policy("cpu")
    views = _views(0, 8)
    demands = _demands(0, 1)
    svc = _gcs(port_gcs, views)
    svc.device = "cpu"
    min_cells(None)
    before = policy.device_solves
    svc._batch_assign_actors(_burst(port_gcs, demands, 16))
    assert policy.device_solves == before
    min_cells(0)
    svc._batch_assign_actors(_burst(port_gcs, demands, 16))
    assert policy.device_solves == before + 1
    # under the batch threshold (16) neither package solves at all
    assert svc._batch_assign_actors(_burst(port_gcs, demands, 15)) == {}


@pytest.mark.parametrize("strategy",
                         ["PACK", "SPREAD", "STRICT_PACK", "STRICT_SPREAD"])
@pytest.mark.parametrize("seed,num_nodes", [(0, 8), (2, 64), (4, 256)])
def test_pack_bundles_matches_reference(strategy, seed, num_nodes):
    views = _views(seed, num_nodes)
    rng = np.random.default_rng(seed + 7)
    for num_bundles in (1, 3, 8, 24):
        bundles = [{"CPU": float(rng.choice([1, 2, 4])),
                    **({"GPU": 1.0} if b % 3 == 0 else {})}
                   for b in range(num_bundles)]
        exclude = {views[0][0]} if num_bundles == 3 else None
        ref = _gcs(ref_gcs, views)._pack_bundles(bundles, strategy,
                                                 exclude)
        port = _gcs(port_gcs, views)._pack_bundles(bundles, strategy,
                                                   exclude)
        assert port == ref, (strategy, num_bundles)


# ------------------------------------------------------------- device rule

_RULE = ("import sys;"
         "from ray_tpu_torch._private.device import control_plane_device;"
         "print(control_plane_device(), 'torch' in sys.modules)")


def _run_rule(env_update):
    env = dict(os.environ)
    env.update(env_update)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env["PYTHONPATH"] = root
    return subprocess.run([sys.executable, "-c", _RULE], env=env,
                          capture_output=True, text=True, timeout=120)


def test_control_plane_without_a_card_solves_on_the_cpu():
    """``CUDA_VISIBLE_DEVICES=""`` (the spawner's ``gcs_device="cpu"``)
    is the CPU, and answering it imports no torch."""
    out = _run_rule({"CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["cpu", "False"]


def test_control_plane_given_a_card_it_cannot_reach_raises():
    """A card is named that CUDA cannot reach (no such UUID, on any
    host): the rule answers CUDA, and resolving it raises instead of
    dropping to the CPU."""
    out = _run_rule({
        "CUDA_VISIBLE_DEVICES": "GPU-00000000-0000-0000-0000-000000000000"})
    if out.returncode == 0:
        pytest.fail("a named card resolved without CUDA: "
                    f"{out.stdout.strip()}")
    assert "no CUDA device" in out.stderr


def test_gcs_sees_the_spawners_cards_unless_asked(monkeypatch):
    """``gcs_device="cpu"`` hides every card from the GCS; the default
    passes this process's own ``CUDA_VISIBLE_DEVICES`` on (unset: every
    card), and a process that hides every card must ask for the CPU."""
    from ray_tpu_torch.cluster.process_cluster import _gcs_visible_devices

    monkeypatch.delenv("CUDA_VISIBLE_DEVICES", raising=False)
    assert _gcs_visible_devices("cpu") == ""
    assert _gcs_visible_devices(None) is None
    assert _gcs_visible_devices("cuda") is None
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "1")
    assert _gcs_visible_devices(None) == "1"
    assert _gcs_visible_devices("cpu") == ""
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "")
    with pytest.raises(RuntimeError, match="gcs_device='cpu'"):
        _gcs_visible_devices(None)
    with pytest.raises(ValueError):
        _gcs_visible_devices("cuda:1")


def test_default_cluster_without_cuda_fails_to_start(monkeypatch):
    """``ProcessCluster()`` puts the GCS's solves on CUDA: on a host
    without it the GCS raises at start and the cluster does not come
    up, instead of solving on the host."""
    from ray_tpu_torch.cluster.process_cluster import ProcessCluster

    monkeypatch.delenv("CUDA_VISIBLE_DEVICES", raising=False)
    with pytest.raises(RuntimeError, match="exited during startup"):
        ProcessCluster()
