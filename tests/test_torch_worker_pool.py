"""The port's worker pool and actor lifecycle on the CPU: the twin of
tests/test_worker_pool.py.

Without a warm pool (``warm_size`` 0, as on ``init(worker_mode=
"process")``): every actor create cold-forks a process of its own, a
kill ends it promptly even mid-call, leased-worker crashes restart the
actor, burst creates (one bad ``__init__``, one duplicate name) on
``init(device="cpu", worker_mode="process")``, and the pool's own lease,
crash and shutdown handling. With one (a raylet's pool, ``warm_size``
4 by default): the JAX package's warm-pool scenarios, on the port's
``ProcessCluster`` and on the pool alone. Every wait is bounded.
"""

import os
import signal
import sys
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import cloudpickle
import pytest

import ray_tpu_torch
from ray_tpu_torch.cluster.process_pool import ProcessWorkerPool
from ray_tpu_torch.exceptions import (
    ActorDiedError,
    RayActorError,
    WorkerCrashedError,
)

# worker processes cannot import this test module (it lives outside the
# package): its functions and classes ship by value
cloudpickle.register_pickle_by_value(sys.modules[__name__])

pytestmark = pytest.mark.worker_pool
GET_TIMEOUT_S = 60


class Echo:
    def __init__(self, x=0):
        self.x = x

    def get(self):
        return self.x

    def pid(self):
        return os.getpid()

    def crash(self):
        os.kill(os.getpid(), signal.SIGKILL)

    def spin(self, seconds):
        time.sleep(seconds)
        return "done"


class BadInit:
    def __init__(self):
        raise RuntimeError("bad init boom")

    def get(self):
        return None


def _alive(pid) -> bool:
    try:
        os.kill(pid, 0)
        return True
    except ProcessLookupError:
        return False


def _wait_gone(pid, timeout=10.0) -> bool:
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if not _alive(pid):
            return True
        time.sleep(0.05)
    return False


@pytest.fixture
def proc_runtime():
    rt = ray_tpu_torch.init(num_cpus=8, worker_mode="process",
                            num_process_workers=1, device="cpu")
    try:
        yield rt
    finally:
        ray_tpu_torch.shutdown()


def _swallow(fn, *args):
    try:
        fn(*args)
    except Exception:
        pass


# --------------------------------------------- the cluster scenarios


def test_pool_disabled_restores_cold_fork():
    """A pool without a warm pool (warm_size 0): every create
    cold-forks a process of its own, and a kill ends the actor's
    process."""
    pool = ProcessWorkerPool(size=1)
    try:
        proxies = [pool.create_actor_process(Echo, (i,), {})
                   for i in (7, 8)]
        assert [p.get() for p in proxies] == [7, 8]
        pids = [p.pid() for p in proxies]
        assert len(set(pids)) == 2 and os.getpid() not in pids
        assert not set(pids) & set(pool.pids())
        assert pool.stats()["actors"] == 2
        proxies[0].__ray_on_kill__()
        assert _wait_gone(pids[0])
        with pytest.raises(WorkerCrashedError):
            proxies[0].get()
        assert proxies[1].get() == 8
        assert pool.stats()["actors"] == 1
        proxies[1].__ray_on_kill__()
    finally:
        pool.shutdown()


def test_leased_worker_crash_restarts_on_fresh_worker(proc_runtime):
    """SIGKILL of an actor's worker mid-call surfaces as an actor death;
    the restart lands on a different process and re-runs __init__."""
    handle = ray_tpu_torch.remote(max_restarts=1)(Echo).remote(1)
    first_pid = ray_tpu_torch.get(handle.pid.remote(),
                                  timeout=GET_TIMEOUT_S)
    with pytest.raises((RayActorError, ActorDiedError)):
        ray_tpu_torch.get(handle.crash.remote(), timeout=GET_TIMEOUT_S)
    deadline = time.monotonic() + 30
    new_pid = None
    while time.monotonic() < deadline:
        try:
            new_pid = ray_tpu_torch.get(handle.pid.remote(), timeout=30)
            break
        except Exception:
            time.sleep(0.2)
    assert new_pid is not None and new_pid != first_pid
    assert ray_tpu_torch.get(handle.get.remote(),
                             timeout=GET_TIMEOUT_S) == 1


def test_clean_kill_returns_worker_busy_kill_reaps():
    """With no warm pool to return to, an idle actor's kill ends its
    process; a busy actor's kill does not wait for the call in flight
    and SIGKILLs promptly."""
    pool = ProcessWorkerPool(size=1)
    try:
        proxy = pool.create_actor_process(Echo, (5,), {})
        assert proxy.get() == 5
        pid = proxy.pid()
        proxy.__ray_on_kill__()
        assert _wait_gone(pid)

        busy = pool.create_actor_process(Echo, (6,), {})
        busy_pid = busy.pid()
        t = threading.Thread(target=_swallow, args=(busy.spin, 30),
                             daemon=True)
        t.start()
        time.sleep(0.5)  # the spin call is in flight on the worker
        start = time.monotonic()
        busy.__ray_on_kill__()
        assert time.monotonic() - start < 5
        assert _wait_gone(busy_pid), "busy actor's worker was not SIGKILLed"
        t.join(timeout=10)
    finally:
        pool.shutdown()


def test_batch_create_with_per_row_failure(proc_runtime):
    """A burst of concurrent creates: the one bad row fails typed with
    its __init__ error while every other actor comes up callable, and
    the burst of kills ends promptly."""
    def make(i):
        if i == 3:
            return ray_tpu_torch.remote(BadInit).remote()
        return ray_tpu_torch.remote(Echo).remote(i)

    with ThreadPoolExecutor(max_workers=8) as ex:
        handles = list(ex.map(make, range(8)))
    good = [h for i, h in enumerate(handles) if i != 3]
    assert sorted(ray_tpu_torch.get([h.get.remote() for h in good],
                                    timeout=GET_TIMEOUT_S)) == \
        [0, 1, 2, 4, 5, 6, 7]
    with pytest.raises((ActorDiedError, RayActorError)):
        ray_tpu_torch.get(handles[3].get.remote(), timeout=GET_TIMEOUT_S)
    pids = ray_tpu_torch.get([h.pid.remote() for h in good],
                             timeout=GET_TIMEOUT_S)
    t0 = time.monotonic()
    with ThreadPoolExecutor(max_workers=8) as ex:
        list(ex.map(ray_tpu_torch.kill, good))
    assert time.monotonic() - t0 < 20.0
    assert all(_wait_gone(p) for p in pids)


def test_batch_create_duplicate_name_raises(proc_runtime):
    """A name conflict surfaces as ValueError, and the first holder of
    the name keeps working."""
    actor = ray_tpu_torch.remote(Echo)
    h1 = actor.options(name="singleton").remote(1)
    assert ray_tpu_torch.get(h1.get.remote(), timeout=GET_TIMEOUT_S) == 1
    with pytest.raises(ValueError, match="already"):
        actor.options(name="singleton").remote(2)
    assert ray_tpu_torch.get(h1.get.remote(), timeout=GET_TIMEOUT_S) == 1


def _wait_pool_warm(pool, count, timeout=30.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pool.stats()["warm_idle"] >= count:
            return
        time.sleep(0.05)
    pytest.fail(f"pool never pre-forked {count} warm workers")


# ------------------------------------------------------- pool level
# ProcessWorkerPool on its own: no runtime, the pool's leases, crashes
# and shutdown asserted against its pids and stats.


def _pid():
    return os.getpid()


def _die():
    os.kill(os.getpid(), signal.SIGKILL)


def test_pool_level_concurrent_runs_share_the_fixed_pool():
    """More concurrent tasks than workers: each waits for a lease, every
    result comes back, and all ran on the pool's own processes."""
    pool = ProcessWorkerPool(size=2)
    try:
        pool_pids = set(pool.pids())
        assert len(pool_pids) == 2 and os.getpid() not in pool_pids
        with ThreadPoolExecutor(max_workers=6) as ex:
            out = list(ex.map(lambda i: (pool.run(pow, (i, 2), {}),
                                         pool.run(_pid, (), {})),
                              range(6)))
        assert [sq for sq, _ in out] == [i * i for i in range(6)]
        assert {p for _, p in out} <= pool_pids
        stats = pool.stats()
        assert {k: stats[k] for k in ("size", "alive", "idle",
                                      "actors")} == \
            {"size": 2, "alive": 2, "idle": 2, "actors": 0}
        assert stats["warm_size"] == 0 and stats["warm_idle"] == 0
    finally:
        pool.shutdown()


def test_pool_level_task_crash_raises_and_respawns():
    """A task that kills its worker surfaces as WorkerCrashedError naming
    the pid; the pool replaces the worker and the next task runs."""
    pool = ProcessWorkerPool(size=1)
    try:
        (pid,) = pool.pids()
        with pytest.raises(WorkerCrashedError, match=str(pid)):
            pool.run(_die, (), {})
        assert _wait_gone(pid)
        (new_pid,) = pool.pids()
        assert new_pid != pid
        assert pool.run(_pid, (), {}) == new_pid
    finally:
        pool.shutdown()


def test_pool_level_dead_idle_worker_is_replaced():
    """A worker that dies while idle is replaced at the next lease."""
    pool = ProcessWorkerPool(size=1)
    try:
        (pid,) = pool.pids()
        os.kill(pid, signal.SIGKILL)
        # wait for the exit without reaping it: the pool's poll() must
        os.waitid(os.P_PID, pid, os.WEXITED | os.WNOWAIT)
        new_pid = pool.run(_pid, (), {})
        assert new_pid != pid
        assert pool.pids() == [new_pid]
        assert _wait_gone(pid)  # reaped by the lease's liveness check
    finally:
        pool.shutdown()


def test_pool_level_actor_init_error_ends_its_process():
    """A failing ``__init__`` re-raises in the caller with its own type
    and message, and leaves no actor process behind."""
    pool = ProcessWorkerPool(size=1)
    try:
        with pytest.raises(RuntimeError, match="bad init boom"):
            pool.create_actor_process(BadInit, (), {})
        assert pool.stats()["actors"] == 0
    finally:
        pool.shutdown()


@pytest.mark.parametrize("warm_size", [0, 2])
def test_pool_level_shutdown_reaps_warm_workers(warm_size):
    """Shutdown ends every process the pool started: its task workers,
    its actors' processes (cold-forked, or leased from the warm pool)
    and the idle warm workers the replenisher forked after those
    leases."""
    pool = ProcessWorkerPool(size=2, warm_size=warm_size)
    _wait_pool_warm(pool, warm_size)
    actors = [pool.create_actor_process(Echo, (i,), {}) for i in range(2)]
    assert pool.stats()["warm_hits"] == warm_size
    _wait_pool_warm(pool, warm_size)
    with pool._warm_cv:
        warm_pids = [w.pid for w in pool._warm]
    pids = pool.pids() + [a.pid() for a in actors] + warm_pids
    assert len(set(pids)) == 4 + warm_size
    pool.shutdown()
    for pid in pids:
        assert _wait_gone(pid), f"worker {pid} survived pool shutdown"
    with pytest.raises(RuntimeError, match="shut down"):
        pool.run(_pid, (), {})


def test_pool_level_clean_return_and_reuse():
    pool = ProcessWorkerPool(size=1, warm_size=1)
    try:
        _wait_pool_warm(pool, 1)
        proxy = pool.create_actor_process(Echo, (11,), {})
        assert proxy.get() == 11
        pid = proxy.__ray_proxy_pid__()
        proxy.__ray_on_kill__()
        assert pool.stats()["warm_returned"] == 1
        assert _alive(pid)  # parked in the pool
        again = pool.create_actor_process(Echo, (12,), {})
        assert again.get() == 12
        assert pool.stats()["warm_hits"] >= 2
        again.__ray_on_kill__()
    finally:
        pool.shutdown()


def test_pool_level_exhausted_lease_misses_deterministically():
    pool = ProcessWorkerPool(size=1, warm_size=1)
    try:
        _wait_pool_warm(pool, 1)
        # the first lease wakes the replenisher, which appends a fresh
        # worker within milliseconds; holding the pool's condition (an
        # RLock, which _warm_lease re-enters) keeps it from appending
        # between the two leases
        with pool._warm_cv:
            leased = pool._warm_lease()
            assert leased is not None
            assert pool.stats()["warm_hits"] == 1
            assert pool._warm_lease() is None  # drained: a miss
            assert pool.stats()["warm_misses"] == 1
        leased.terminate()
    finally:
        pool.shutdown()


def test_pool_level_warm_worker_dies_during_specialization():
    """A warm worker that dies after the lease's liveness check: the
    create falls back to a cold fork without an error, and only the
    counters show the burned lease."""
    pool = ProcessWorkerPool(size=1, warm_size=1)
    try:
        _wait_pool_warm(pool, 1)
        real_lease = pool._warm_lease

        def dying_lease():
            worker = real_lease()
            if worker is not None:
                os.kill(worker.pid, signal.SIGKILL)
                worker._proc.wait(timeout=10)
            return worker

        pool._warm_lease = dying_lease
        try:
            proxy = pool.create_actor_process(Echo, (42,), {})
        finally:
            pool._warm_lease = real_lease
        assert proxy.get() == 42
        stats = pool.stats()
        assert stats["warm_specialize_crashes"] == 1
        assert stats["warm_reaped"] >= 1
        proxy.__ray_on_kill__()
    finally:
        pool.shutdown()


# -------------------------------------- the warm pool on a live cluster
# A raylet's pool keeps worker_pool_warm_size (4) pre-forked workers.


@pytest.fixture(scope="module")
def warm_cluster():
    from ray_tpu_torch.cluster.process_cluster import (
        ClusterClient,
        ProcessCluster,
    )

    cluster = ProcessCluster(heartbeat_period_ms=100,
                             num_heartbeats_timeout=20, gcs_device="cpu")
    try:
        nid = cluster.add_node(num_cpus=8, object_store_memory=64 << 20)
        cluster.wait_for_nodes(1)
        client = ClusterClient(cluster.gcs_address)
    except BaseException:
        cluster.shutdown()
        raise
    yield cluster, client, nid
    client.close()
    cluster.shutdown()


def _node_pool(cluster, node_id):
    return cluster.node_stats(node_id)["pool"]


def _wait_node_warm(cluster, node_id, count, timeout=30.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if _node_pool(cluster, node_id)["warm_idle"] >= count:
            return
        time.sleep(0.1)
    pytest.fail(f"warm pool never reached {count} idle workers")


def test_cluster_warm_lease_parity_and_hit_counters(warm_cluster):
    cluster, client, nid = warm_cluster
    _wait_node_warm(cluster, nid, 1)
    hits = _node_pool(cluster, nid)["warm_hits"]
    handle = client.create_actor(Echo, (42,))
    assert handle.get() == 42
    assert handle.pid() != os.getpid()
    assert _node_pool(cluster, nid)["warm_hits"] >= hits + 1
    client.kill_actor(handle)
    with pytest.raises(ActorDiedError):
        handle.get()


def test_cluster_pool_disabled_and_exhausted_pools(warm_cluster):
    """A node with worker_pool_enabled=0 cold-forks every create (the
    serial client path too); a node with a warm pool of one serves four
    simultaneous creates, each a hit or a cold-fork miss."""
    cluster, client, nid = warm_cluster
    cold = cluster.add_node(
        num_cpus=2, resources={"cold": 2.0}, object_store_memory=32 << 20,
        extra_env={"RAY_TPU_worker_pool_enabled": "0"})
    small = cluster.add_node(
        num_cpus=4, resources={"small": 4.0}, object_store_memory=32 << 20,
        extra_env={"RAY_TPU_worker_pool_warm_size": "1"})
    cluster.wait_for_nodes(3)
    client._batching = False  # the serial actor_create / actor_kill RPCs
    try:
        handle = client.create_actor(Echo, (7,),
                                     resources={"CPU": 1.0, "cold": 1.0})
        assert handle.get() == 7
        stats = _node_pool(cluster, cold)
        assert stats["warm_size"] == 0 and stats["warm_hits"] == 0
        client.kill_actor(handle)
        with pytest.raises(ActorDiedError):
            handle.get()
    finally:
        client._batching = True
    _wait_node_warm(cluster, small, 1)
    with ThreadPoolExecutor(max_workers=4) as ex:
        handles = list(ex.map(
            lambda i: client.create_actor(
                Echo, (i,), resources={"CPU": 1.0, "small": 1.0}),
            range(4)))
    assert sorted(h.get() for h in handles) == [0, 1, 2, 3]
    stats = _node_pool(cluster, small)
    assert stats["warm_hits"] >= 1
    assert stats["warm_hits"] + stats["warm_misses"] == 4
    for h in handles:
        client.kill_actor(h)


def test_cluster_leased_worker_crash_restarts_on_fresh_worker(
        warm_cluster):
    cluster, client, nid = warm_cluster
    _wait_node_warm(cluster, nid, 1)
    handle = client.create_actor(Echo, (1,), max_restarts=1,
                                 resources={"CPU": 1.0})
    first_pid = handle.pid()
    with pytest.raises((RayActorError, ActorDiedError)):
        handle.crash()
    deadline = time.monotonic() + 30
    new_pid = None
    while time.monotonic() < deadline:
        try:
            new_pid = handle.pid()
            break
        except Exception:
            time.sleep(0.2)
    assert new_pid is not None and new_pid != first_pid
    assert handle.get() == 1
    client.kill_actor(handle)


def test_cluster_clean_kill_returns_worker_busy_kill_reaps(warm_cluster):
    cluster, client, nid = warm_cluster
    _wait_node_warm(cluster, nid, 1)
    handle = client.create_actor(Echo, (5,), resources={"CPU": 1.0})
    assert handle.get() == 5
    pid = handle.pid()
    before = _node_pool(cluster, nid)["warm_returned"]
    client.kill_actor(handle)
    deadline = time.monotonic() + 15
    while _node_pool(cluster, nid)["warm_returned"] <= before:
        if time.monotonic() > deadline:
            pytest.fail("clean kill never returned the worker to the pool")
        time.sleep(0.1)
    assert _alive(pid)

    busy = client.create_actor(Echo, (6,), resources={"CPU": 1.0})
    busy_pid = busy.pid()
    t = threading.Thread(target=_swallow, args=(busy.spin, 30),
                         daemon=True)
    t.start()
    time.sleep(0.5)  # the spin call is in flight on the worker
    client.kill_actor(busy)
    assert _wait_gone(busy_pid), "busy actor's worker was not SIGKILLed"


def test_cluster_batch_create_per_row_failure_and_duplicate_name(
        warm_cluster):
    """Concurrent creates coalesce into batch frames: the bad row fails
    typed with its __init__ error, every other actor comes up, a taken
    name raises ValueError, and the kills ride batch frames too."""
    cluster, client, nid = warm_cluster

    def make(i):
        if i == 3:
            return client.create_actor(BadInit, (),
                                       resources={"CPU": 0.5})
        return client.create_actor(Echo, (i,), resources={"CPU": 0.5})

    with ThreadPoolExecutor(max_workers=8) as ex:
        handles = list(ex.map(make, range(8)))
    good = [h for i, h in enumerate(handles) if i != 3]
    assert sorted(h.get() for h in good) == [0, 1, 2, 4, 5, 6, 7]
    with pytest.raises(ActorDiedError, match="bad init boom"):
        handles[3].get()
    assert client.cluster_view()["actor_batch"]["creates_batched"] >= 8
    h1 = client.create_actor(Echo, (1,), name="singleton",
                             resources={"CPU": 0.5})
    assert h1.get() == 1
    with pytest.raises(ValueError, match="already taken"):
        client.create_actor(Echo, (2,), name="singleton")
    t0 = time.monotonic()
    with ThreadPoolExecutor(max_workers=8) as ex:
        list(ex.map(client.kill_actor, good + [h1]))
    assert time.monotonic() - t0 < 20.0
    assert client.cluster_view()["actor_batch"]["kills_batched"] >= 7
