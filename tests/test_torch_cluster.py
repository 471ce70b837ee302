"""The port's multi-process cluster on the CPU: a GCS process and raylet
processes started by ``ray_tpu_torch.cluster.process_cluster``.

The scenarios of tests/test_multi_node.py on the port's
``ProcessCluster``, one GCS restart from sqlite storage after
tests/test_gcs_fault_tolerance.py, the check that no spawned process
loads the JAX package or JAX, the GCS's burst placer taking the torch
solve on the CPU in a live GCS, and a task's runtime environment.
Scenarios that kill no node and no GCS share one module-scoped cluster;
the others start their own. Every raylet gets a small object store:
the port's segments are always prefaulted.
"""

import os
import sys
import time

import cloudpickle
import numpy as np
import pytest

from ray_tpu_torch.cluster.process_cluster import (
    ClusterClient,
    ProcessCluster,
)
from ray_tpu_torch.exceptions import ActorDiedError

# worker processes cannot import this test module (it lives outside the
# package): its functions and classes ship by value
cloudpickle.register_pickle_by_value(sys.modules[__name__])

STORE_BYTES = 64 << 20


def _start(num_nodes=2, num_cpus=2, heartbeat_period_ms=50,
           num_heartbeats_timeout=10, **cluster_kwargs):
    cluster = ProcessCluster(heartbeat_period_ms=heartbeat_period_ms,
                             num_heartbeats_timeout=num_heartbeats_timeout,
                             gcs_device="cpu", **cluster_kwargs)
    try:
        nodes = [cluster.add_node(num_cpus=num_cpus,
                                  object_store_memory=STORE_BYTES)
                 for _ in range(num_nodes)]
        cluster.wait_for_nodes(num_nodes)
        client = ClusterClient(cluster.gcs_address)
    except BaseException:
        cluster.shutdown()
        raise
    return cluster, client, nodes


@pytest.fixture(scope="module")
def shared():
    """Two nodes for every scenario that kills nothing."""
    cluster, client, (n1, n2) = _start()
    yield cluster, client, n1, n2
    client.close()
    cluster.shutdown()


@pytest.fixture
def cluster2():
    """Two nodes of its own, for a scenario that kills one."""
    cluster, client, (n1, n2) = _start()
    yield cluster, client, n1, n2
    client.close()
    cluster.shutdown()


def _sq(x):
    return x * x


def _node_marker():
    return os.getpid()


def _loaded_reference_modules():
    return sorted(m for m in sys.modules
                  if m.split(".")[0] in {"ray_tpu", "jax"})


class Counter:
    def __init__(self, start=0):
        self.value = start

    def add(self, n=1):
        self.value += n
        return self.value

    def pid(self):
        return os.getpid()

    def loaded(self):
        return _loaded_reference_modules()


def _wait(pred, timeout, what):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return
        time.sleep(0.1)
    pytest.fail(f"{what} within {timeout} s")


def _maps(pid):
    with open(f"/proc/{pid}/maps") as f:
        return f.read()


# ------------------------------------------------- shared-cluster scenarios


def test_tasks_run_in_separate_processes(shared):
    cluster, client, n1, n2 = shared
    refs = [client.submit(_sq, (i,)) for i in range(8)]
    assert [client.get(r) for r in refs] == [i * i for i in range(8)]
    pids = {client.get(client.submit(_node_marker)) for _ in range(4)}
    assert os.getpid() not in pids


def test_cross_node_object_transfer(shared):
    """An object made on node A is consumed by a task pinned to node B:
    the payload crosses a socket through the chunked transfer plane."""
    cluster, client, n1, n2 = shared
    ref_a = client.submit(lambda: np.arange(200_000), node_id=n1)
    assert client.get(ref_a).shape == (200_000,)
    consumed = client.submit(
        lambda arr: int(arr.sum()), (ref_a,), node_id=n2)
    assert client.get(consumed) == sum(range(200_000))


def test_put_and_task_error(shared):
    cluster, client, n1, n2 = shared
    ref = client.put({"k": [1, 2, 3]})
    assert client.get(ref) == {"k": [1, 2, 3]}

    def boom():
        raise ValueError("boom from the worker")

    with pytest.raises(ValueError, match="boom from the worker"):
        client.get(client.submit(boom))


def test_actor_lifecycle(shared):
    cluster, client, n1, n2 = shared
    handle = client.create_actor(Counter, (10,), name="counter")
    assert handle.add() == 11
    assert handle.add(5) == 16
    assert handle.pid() != os.getpid()
    again = client.get_actor("counter")
    assert again.add() == 17
    client.kill_actor(handle)
    with pytest.raises(ActorDiedError):
        handle.add()


def test_actor_process_crash_restarts_in_place(shared):
    """The actor's process (not its node) dies: the raylet reports it and
    the GCS restarts the actor."""
    cluster, client, n1, n2 = shared

    class Crasher:
        def crash(self):
            os._exit(1)

        def ok(self):
            return "ok"

    handle = client.create_actor(Crasher, max_restarts=1)
    assert handle.ok() == "ok"
    try:
        handle.crash()
    except Exception:
        pass
    deadline = time.monotonic() + 20
    while time.monotonic() < deadline:
        try:
            assert handle.ok() == "ok"
            return
        except ActorDiedError:
            pytest.fail("actor died despite restart budget")
        except Exception:
            time.sleep(0.2)
    pytest.fail("actor did not restart after process crash")


def test_pg_shadow_resources_schedule_tasks(shared):
    cluster, client, n1, n2 = shared
    pg_id = client.create_placement_group([{"CPU": 1.0}], strategy="PACK")
    assert client.pg_info(pg_id)["state"] == "CREATED"
    shadow = f"CPU_group_0_{pg_id}"
    ref = client.submit(_node_marker, resources={shadow: 1.0})
    assert isinstance(client.get(ref), int)
    client.remove_placement_group(pg_id)


def test_kv_store(shared):
    cluster, client, n1, n2 = shared
    client.kv_put(b"k1", b"v1")
    assert client.kv_get(b"k1") == b"v1"
    assert client.kv_get(b"nope") is None
    assert client.kv_del(b"k1") is True
    assert client.kv_get(b"k1") is None
    assert client.kv_del(b"k1") is False


def test_task_state_and_wait_task(shared):
    cluster, client, n1, n2 = shared
    ref = client.submit(lambda: time.sleep(0.3) or 41)
    assert client.wait_task(ref, timeout=30.0) == "done"
    assert client.task_state(ref) == "done"
    assert client.get(ref) == 41

    def boom():
        raise ValueError("kaputt")

    bad = client.submit(boom, max_retries=0)
    with pytest.raises(ValueError):
        client.get(bad)
    assert client.wait_task(bad, timeout=30.0) == "failed"


def test_free_drops_replicas_everywhere(shared):
    cluster, client, n1, n2 = shared
    ref = client.put(b"x" * 4096)
    assert client.get(ref) == b"x" * 4096
    assert client.free([ref]) >= 1

    def forgotten():
        reply = client.gcs.call("object_locations",
                                object_id=ref.object_id, timeout=10.0)
        return not reply["locations"]

    _wait(forgotten, 10.0, "freed object still has directory entries")


def test_job_view_summary(shared):
    cluster, client, n1, n2 = shared
    view = client.job_view()
    assert view["nodes"] == 2 and view["alive"] == 2
    client.get(client.put(b"payload"))
    assert client.job_view()["objects"] >= 1


def test_cluster_client_wait(shared):
    cluster, client, n1, n2 = shared
    fast = client.submit(lambda: "quick")
    slow = client.submit(lambda: __import__("time").sleep(2.0) or "late")
    ready, unready = client.wait([fast, slow], num_returns=1, timeout=10)
    assert ready and ready[0] is fast, (ready, unready)
    assert unready and unready[0] is slow
    ready2, unready2 = client.wait([fast, slow], num_returns=2,
                                   timeout=15)
    assert len(ready2) == 2 and not unready2
    assert client.get(slow) == "late"


def test_spawned_processes_load_no_reference_package(shared):
    """The GCS, raylets, task workers and actor processes import the port
    alone: a task and an actor see neither ``ray_tpu`` nor ``jax`` in
    their ``sys.modules``, and no server process maps a JAX library.
    The GCS maps libtorch, which it imported at start to warm its solve
    device; the raylets, which run no solve, do not."""
    cluster, client, n1, n2 = shared
    for node in (n1, n2):
        assert client.get(client.submit(_loaded_reference_modules,
                                        node_id=node)) == []
    handle = client.create_actor(Counter)
    assert handle.loaded() == []
    client.kill_actor(handle)
    for proc in [cluster.gcs_proc, *cluster.raylets.values()]:
        maps = _maps(proc.pid)
        assert "jaxlib" not in maps and "/jax/" not in maps
        assert ("libtorch" in maps) == (proc is cluster.gcs_proc)


def _read_env(name):
    return os.environ.get(name)


def test_runtime_env_raises(shared):
    """A cluster task runs under its runtime_env, in both packages; a
    cluster actor takes none: ``create_actor`` has the JAX package's
    signature, so the keyword is a TypeError."""
    cluster, client, n1, n2 = shared
    ref = client.submit(_read_env, ("RT_CLUSTER_VAR",),
                        runtime_env={"env_vars": {"RT_CLUSTER_VAR": "1"}})
    assert client.get(ref, timeout=60.0) == "1"
    assert client.get(client.submit(_read_env, ("RT_CLUSTER_VAR",)),
                      timeout=60.0) is None
    with pytest.raises(TypeError, match="runtime_env"):
        client.create_actor(Counter, runtime_env={"env_vars": {"A": "1"}})


# ---------------------------------------------- scenarios that kill a node


def test_node_death_detected_by_heartbeat(cluster2):
    """SIGKILL a raylet; the GCS heartbeat detector marks it dead with no
    drain call, and the survivor keeps serving."""
    cluster, client, n1, n2 = cluster2
    cluster.kill_node(n2)
    _wait(lambda: not client.cluster_view()["nodes"][n2]["alive"], 30.0,
          "node death not detected")
    assert client.get(client.submit(_sq, (7,))) == 49


def test_task_resubmit_after_node_death(cluster2):
    """A task lost to node death is resubmitted from driver lineage."""
    cluster, client, n1, n2 = cluster2

    def slow_square(x):
        time.sleep(3.0)
        return x * x

    ref = client.submit(slow_square, (6,), node_id=n2)
    time.sleep(0.5)
    cluster.kill_node(n2)
    assert client.get(ref, timeout=60.0) == 36


def test_actor_restart_after_node_death(cluster2):
    cluster, client, n1, n2 = cluster2
    handle = client.create_actor(Counter, (0,), max_restarts=2)
    first_pid = handle.pid()
    view = client.gcs.call("actor_get", actor_id=handle.actor_id)
    cluster.kill_node(view["node_id"])
    deadline = time.monotonic() + 20
    new_pid = None
    while time.monotonic() < deadline:
        try:
            new_pid = handle.pid()
            break
        except Exception:
            time.sleep(0.2)
    assert new_pid is not None and new_pid != first_pid
    assert handle.add() == 1  # the new incarnation re-ran __init__


def test_actor_out_of_restarts_dies(cluster2):
    cluster, client, n1, n2 = cluster2
    handle = client.create_actor(Counter, (0,), max_restarts=0)
    view = client.gcs.call("actor_get", actor_id=handle.actor_id)
    cluster.kill_node(view["node_id"])
    deadline = time.monotonic() + 15
    while time.monotonic() < deadline:
        try:
            handle.add()
            time.sleep(0.2)
        except ActorDiedError:
            return
    pytest.fail("actor with max_restarts=0 did not die")


def test_placement_group_2pc_and_reschedule(cluster2):
    cluster, client, n1, n2 = cluster2
    pg_id = client.create_placement_group(
        [{"CPU": 1.0}, {"CPU": 1.0}], strategy="STRICT_SPREAD")
    info = client.pg_info(pg_id)
    assert info["state"] == "CREATED"
    assert set(info["placements"].values()) == {n1, n2}
    victim = info["placements"][1]
    survivor = n1 if victim == n2 else n2
    cluster.kill_node(victim)

    def moved():
        now = client.pg_info(pg_id)
        return (now["state"] == "CREATED"
                and set(now["placements"].values()) == {survivor})

    _wait(moved, 45.0, "placement group not rescheduled")


def test_gcs_restart_from_sqlite_keeps_kv_and_named_actors(tmp_path):
    """Kill the GCS, restart it on the same address from its sqlite
    tables: KV and the named actor survive, and scheduling resumes."""
    cluster, client, (n1,) = _start(
        num_nodes=1, storage_path=str(tmp_path / "gcs.db"))
    try:
        client.kv_put(b"cfg", b"value-1")
        handle = client.create_actor(Counter, (10,), name="counter")
        assert handle.add(5) == 15
        cluster.kill_gcs()
        cluster.restart_gcs()
        assert client.kv_get(b"cfg") == b"value-1"
        assert client.get_actor("counter").add(1) == 16
        assert handle.add(1) == 17
        assert client.get(client.submit(_sq, (9,))) == 81
    finally:
        client.close()
        cluster.shutdown()


def test_live_gcs_burst_takes_the_torch_solve_on_the_cpu():
    """A GCS asked for the CPU, with the device-solve threshold at 0: a
    burst of 32 actors through ``actor_create_batch`` goes through the
    fused torch solve on the CPU (warmed at the GCS's start), every
    actor comes up, and no node holds more than its CPUs. The heartbeat
    settings are ``ProcessCluster``'s defaults (50 ms, 10 missed): no
    node is declared dead, and the longest gap between a node's
    heartbeats stays under the timeout."""
    cluster, client, (n1, n2) = _start(
        num_cpus=4,
        gcs_env={"RAY_TPU_scheduler_device_solve_min_cells": "0"})
    try:
        from ray_tpu_torch.cluster import protocol

        assert client.cluster_view()["actor_placement"]["warmup_ms"] > 0
        rows = [{"actor_id": f"burst{i:03d}",
                 "cls_bytes": protocol.dumps(Counter),
                 "args_bytes": protocol.dumps(
                     ([("v", protocol.dumps(i))], {})),
                 "resources": {"CPU": 0.25}, "max_restarts": 0,
                 "name": "", "token": f"row{i}"} for i in range(32)]
        reply = client.gcs.call("actor_create_batch", creates=rows,
                                token="burst", timeout=120.0)
        assert len(reply["results"]) == 32
        placement = client.cluster_view()["actor_placement"]
        assert placement["device"] == "cpu"
        assert placement["device_solves"] >= 1
        assert placement["device_ms"][0][0] > 0

        # the reply may still show an actor PENDING whose create RPC is in
        # flight (the JAX package's GCS answers the same way): every one
        # must reach ALIVE
        def views():
            return [client.gcs.call("actor_get", actor_id=r["actor_id"])
                    for r in rows]

        _wait(lambda: all(v["state"] == "ALIVE" for v in views()), 60.0,
              "burst actors not all ALIVE")
        placed = {}
        for v in views():
            placed[v["node_id"]] = placed.get(v["node_id"], 0) + 1
        assert set(placed) <= {n1, n2}
        assert max(placed.values()) * 0.25 <= 4.0
        nodes = client.cluster_view()["nodes"]
        assert all(nodes[n]["alive"] for n in (n1, n2)), nodes
        assert max(nodes[n]["heartbeat_max_gap_ms"] for n in (n1, n2)) \
            < 50 * 10
    finally:
        client.close()
        cluster.shutdown()
