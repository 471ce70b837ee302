"""Parity of the port's placement solve with the JAX package's.

The torch solve (``ray_tpu_torch.scheduler.policy``) runs here on the
CPU; the JAX solve runs on JAX's CPU backend; both get the same numpy
inputs. The device solve is float32 in both packages and the counts it
produces are integers, so the counts must be EQUAL, not close: every
comparison below is exact.
"""

import numpy as np
import pytest

from ray_tpu._private.config import Config as JConfig
from ray_tpu.core import raylet as jraylet
from ray_tpu.core import task_spec as jtask_spec
from ray_tpu._private import ids as jids
from ray_tpu.scheduler.policy import (
    BatchedHybridPolicy as JBatched,
    SchedulingOptions as JOpts,
)
from ray_tpu_torch._private.config import Config as TConfig
from ray_tpu_torch._private import ids as tids
from ray_tpu_torch.core import raylet as traylet
from ray_tpu_torch.core import task_spec as ttask_spec
from ray_tpu_torch.scheduler.policy import (
    BatchedHybridPolicy,
    DeviceMatrixMirror,
    SchedulingOptions,
    shared_batched_policy,
)
from ray_tpu_torch.scheduler.resources import to_fixed

F = to_fixed
CPU = "cpu"


def _seeded_instance(seed, n_nodes=12, n_res=3, n_classes=4):
    rng = np.random.default_rng(seed)
    total = rng.integers(1, 16, size=(n_nodes, n_res)) * F(1)
    avail = total // rng.integers(1, 4, size=(n_nodes, n_res))
    alive = rng.random(n_nodes) > 0.2
    reqs = rng.integers(0, 3, size=(n_classes, n_res)) * F(1)
    reqs[:, 0] = np.maximum(reqs[:, 0], F(1))
    ks = rng.integers(5, 60, size=n_classes)
    return total, avail, alive, reqs.astype(np.int64), ks.astype(np.int64)


@pytest.mark.parametrize("seed", range(5))
def test_class_solve_matches_jax_and_numpy(seed):
    """One class at a time, the seeds of test_scheduling_policy.py:
    torch per-class device path == JAX per-class device path == numpy
    host solve, all exactly."""
    total, avail, alive, reqs, ks = _seeded_instance(seed)
    local = seed % total.shape[0]
    t = BatchedHybridPolicy(CPU).schedule_classes(
        reqs, ks, total, avail, alive, local, SchedulingOptions())
    j = JBatched(use_jax=True).schedule_classes(
        reqs, ks, total, avail, alive, local, JOpts())
    n = BatchedHybridPolicy().schedule_classes(
        reqs, ks, total, avail, alive, local, SchedulingOptions())
    np.testing.assert_array_equal(t, j)
    np.testing.assert_array_equal(t, n)


@pytest.mark.parametrize("seed", range(5))
@pytest.mark.parametrize("threshold", [0.5, 0.0, 0.3])
def test_fused_tick_matches_jax(seed, threshold):
    """The whole-tick loop over classes against the JAX lax.scan, with
    the spread threshold moved so both the packing and the spreading
    orders are exercised."""
    total, avail, alive, reqs, ks = _seeded_instance(seed, n_nodes=16,
                                                     n_res=4,
                                                     n_classes=6)
    reqs = reqs[:, :4]
    local = (3 * seed) % 16
    t = BatchedHybridPolicy(CPU).schedule_tick_fused(
        reqs, ks, total, avail, alive, local,
        SchedulingOptions(spread_threshold=threshold)).pull()
    j = np.asarray(JBatched(use_jax=True).schedule_tick_fused(
        reqs, ks, total, avail, alive, local,
        JOpts(spread_threshold=threshold)))
    assert t.dtype == np.int32
    np.testing.assert_array_equal(t, j)


def test_fused_tick_huge_magnitudes_repair_equal():
    """Fixed-point magnitudes far past 2^24 (memory in bytes): the f32
    solves may round a capacity, but the counts after the exact int64
    repair must be equal between the packages and never oversubscribe."""
    total = np.array([[2 ** 31, F(8)], [2 ** 33 + 12345, F(3)],
                      [(2 ** 24) + 1, F(5)]], dtype=np.int64)
    avail = total - np.array([[7, F(1)], [2 ** 20 + 3, 0], [1, F(2)]])
    alive = np.ones(3, dtype=bool)
    reqs = np.array([[2 ** 24 + 1, F(1)], [F(1), 0], [3, F(1)]],
                    dtype=np.int64)
    ks = np.array([100, 1000, 7], dtype=np.int64)
    t_raw = BatchedHybridPolicy(CPU) \
        .schedule_tick_fused(reqs, ks, total, avail, alive, 0,
                             SchedulingOptions()).pull()
    j_raw = np.asarray(JBatched(use_jax=True).schedule_tick_fused(
        reqs, ks, total, avail, alive, 0, JOpts()))
    np.testing.assert_array_equal(t_raw, j_raw)
    t = BatchedHybridPolicy.repair_oversubscription(reqs, t_raw, avail)
    j = JBatched.repair_oversubscription(reqs, j_raw, avail)
    np.testing.assert_array_equal(t, j)
    usage = t.T.astype(np.int64) @ reqs
    assert np.all(avail - usage >= 0)
    # per-class device path: f32 off-by-ones repaired by the host solve
    tc = BatchedHybridPolicy(CPU).schedule_classes(
        reqs, ks, total, avail, alive, 0, SchedulingOptions())
    jc = JBatched(use_jax=True).schedule_classes(
        reqs, ks, total, avail, alive, 0, JOpts())
    np.testing.assert_array_equal(tc, jc)


# ------------------------------------------------- mirror freshness protocol


class _FrozenDeps:
    """Dependency manager whose tasks never become ready: placements
    commit and hold resources, but nothing executes."""

    def wait_ready(self, spec, callback):
        pass


def _port_cluster(n_nodes, seed=0, with_tpu=False):
    rng = np.random.default_rng(seed)
    cluster = traylet.ClusterState(CPU)
    deps = _FrozenDeps()
    raylets = []
    for _ in range(n_nodes):
        resources = {"CPU": float(rng.integers(4, 32)),
                     "MEM": float(rng.integers(8, 64))}
        if with_tpu:
            resources["TPU"] = float(rng.integers(0, 4))
        raylets.append(traylet.Raylet(tids.NodeID.from_random(), resources,
                                      cluster, deps))
        cluster.register(raylets[-1])
    with cluster.lock:
        cluster.refresh_locked()
    return cluster, raylets


def _dirty(cluster, raylet, amount=1):
    raylet.local_resources.available[0] -= F(amount)
    cluster.sync(raylet)
    with cluster.lock:
        cluster.refresh_locked()


def test_mirror_full_then_delta_then_periodic_full():
    cluster, raylets = _port_cluster(4)
    matrix = cluster.matrix
    mirror = DeviceMatrixMirror(CPU)
    _, a, _, up = mirror.refresh(matrix, sync_period=2)
    assert (mirror.full_syncs, mirror.delta_syncs) == (1, 0) and up > 0
    assert np.array_equal(a.numpy(), matrix.available.astype(np.float32))
    _dirty(cluster, raylets[1])
    assert matrix.version == mirror._version
    _, a, _, up = mirror.refresh(matrix, sync_period=2)
    assert (mirror.full_syncs, mirror.delta_syncs) == (1, 1)
    assert 0 < up < matrix.available.nbytes
    assert np.array_equal(a.numpy(), matrix.available.astype(np.float32))
    _, _, _, up = mirror.refresh(matrix, sync_period=2)
    assert up == 0
    mirror.refresh(matrix, sync_period=2)
    assert mirror.full_syncs == 2


def test_mirror_version_jump_forces_full_resync():
    cluster, raylets = _port_cluster(4)
    mirror = DeviceMatrixMirror(CPU)
    mirror.refresh(cluster.matrix, sync_period=1000)
    cluster.register(traylet.Raylet(tids.NodeID.from_random(),
                                    {"CPU": 4.0}, cluster, _FrozenDeps()))
    with cluster.lock:
        cluster.refresh_locked()
    _, a, _, _ = mirror.refresh(cluster.matrix, sync_period=1000)
    assert mirror.full_syncs == 2
    assert a.shape[0] == cluster.matrix.available.shape[0]


def test_mirror_debug_check_catches_unreported_mutation():
    cluster, _ = _port_cluster(4)
    mirror = DeviceMatrixMirror(CPU)
    mirror.refresh(cluster.matrix, sync_period=1000, debug_check=True)
    cluster.matrix.available[2, 0] -= F(2)  # bypasses the dirty rows
    with pytest.raises(AssertionError, match="drifted"):
        mirror.refresh(cluster.matrix, sync_period=1000, debug_check=True)


def test_mirror_delta_bucket_padding_is_exact():
    """3 dirty rows pad to a bucket of 4 by repeating the last row; the
    in-place row copy must stay exact."""
    cluster, raylets = _port_cluster(8)
    mirror = DeviceMatrixMirror(CPU)
    mirror.refresh(cluster.matrix, sync_period=100)
    for slot in (1, 3, 6):
        raylets[slot].local_resources.available[0] -= F(1)
        cluster.sync(raylets[slot])
    with cluster.lock:
        cluster.refresh_locked()
    _, a, _, up = mirror.refresh(cluster.matrix, sync_period=100)
    assert mirror.delta_syncs == 1
    assert up == 4 * 2 * cluster.matrix.width * 4 + 4 * 8
    assert np.array_equal(a.numpy(),
                          cluster.matrix.available.astype(np.float32))


# ------------------------------------------------------------- live drives


def _make_specs(pkg_task_spec, pkg_ids, cluster, n_tasks, n_classes,
                seed=1):
    rng = np.random.default_rng(seed)
    demands = []
    for c in range(n_classes):
        d = {"CPU": float(rng.integers(1, 4))}
        if c % 3 == 0:
            d["MEM"] = float(rng.integers(1, 8))
        if c % 7 == 0:
            d["TPU"] = 1.0
        demands.append(d)
    job = pkg_ids.JobID.from_int(7)
    parent = pkg_ids.TaskID.for_task(None)
    specs = []
    for i in range(n_tasks):
        spec = pkg_task_spec.TaskSpec(
            kind=pkg_task_spec.TaskKind.NORMAL,
            task_id=pkg_ids.TaskID.for_task(None), job_id=job,
            parent_task_id=parent, name=f"t{i}",
            resources=dict(demands[i % n_classes]))
        spec.scheduling_class = pkg_task_spec.scheduling_class_of(
            spec.resource_request(cluster.ids))
        specs.append(spec)
    return specs


def _drive(pkg, n_nodes, n_tasks, n_classes, device_solve):
    """Drain a seeded queue through the head raylet's LIVE
    single-buffered tick (as tests/test_device_scheduler_live.py does)
    and return {task name: (state, node index)}."""
    raylet_mod, task_spec_mod, ids_mod, config_cls = pkg
    cfg = config_cls.instance()
    saved = (cfg.scheduler_device_solve_min_cells,
             cfg.scheduler_pipeline_enabled)
    cfg._set("scheduler_device_solve_min_cells", 0 if device_solve else -1)
    cfg._set("scheduler_pipeline_enabled", False)
    try:
        rng = np.random.default_rng(0)
        cluster = (raylet_mod.ClusterState(CPU) if raylet_mod is traylet
                   else raylet_mod.ClusterState())
        deps = _FrozenDeps()
        raylets = []
        for _ in range(n_nodes):
            resources = {"CPU": float(rng.integers(4, 32)),
                         "MEM": float(rng.integers(8, 64)),
                         "TPU": float(rng.integers(0, 4))}
            raylets.append(raylet_mod.Raylet(ids_mod.NodeID.from_random(),
                                             resources, cluster, deps))
            cluster.register(raylets[-1])
        head = raylets[0]
        specs = _make_specs(task_spec_mod, ids_mod, cluster, n_tasks,
                            n_classes)

        def on_dispatch(raylet, worker_id):
            raise AssertionError("frozen dispatch executed")

        with head._lock:
            for spec in specs:
                task = raylet_mod._PendingTask(spec, on_dispatch, 0)
                head._pending.append(task)
                head._by_task_id[spec.task_id] = task
        for _ in range(64):
            head.schedule_tick()
            with head._lock:
                if not head._pending:
                    break
        assert not head._pending, "pending queue failed to drain"
        name_of = {s.task_id: s.name for s in specs}
        placements = {}
        for slot, raylet in enumerate(raylets):
            with raylet._lock:
                for tid in raylet._running:
                    placements[name_of[tid]] = ("run", slot)
                for q in raylet._dispatch_queues.values():
                    for task in q:
                        placements[name_of[task.spec.task_id]] = (
                            "queued", slot)
                for task in raylet._infeasible:
                    placements[name_of[task.spec.task_id]] = (
                        "infeasible", -1)
        return placements
    finally:
        cfg._set("scheduler_device_solve_min_cells", saved[0])
        cfg._set("scheduler_pipeline_enabled", saved[1])


_PORT = (traylet, ttask_spec, tids, TConfig)
_JAX = (jraylet, jtask_spec, jids, JConfig)


def test_live_drive_matches_jax_device_and_numpy():
    """64 nodes x 10k tasks x 16 classes through the live tick: the
    port's device path places every task exactly where ray_tpu's device
    path and ray_tpu's numpy path do (and the port's own numpy path).
    The runtimes run one after the other."""
    solver = shared_batched_policy(CPU)
    before = solver.device_solves
    port_dev = _drive(_PORT, 64, 10_000, 16, device_solve=True)
    assert solver.device_solves > before, "the device path never ran"
    jax_dev = _drive(_JAX, 64, 10_000, 16, device_solve=True)
    jax_np = _drive(_JAX, 64, 10_000, 16, device_solve=False)
    port_np = _drive(_PORT, 64, 10_000, 16, device_solve=False)
    assert len(port_dev) == 10_000
    assert port_dev == jax_dev
    assert port_dev == jax_np
    assert port_dev == port_np


def test_pipelined_drain_with_debug_check():
    """The pipelined tick on the port's device path: the queue drains in
    one call, nothing is lost, the exact int64 availability never goes
    negative, and the mirror's drift check passes on every refresh."""
    cfg = TConfig.instance()
    saved = {k: getattr(cfg, k) for k in (
        "scheduler_device_solve_min_cells", "scheduler_pipeline_enabled",
        "scheduler_pipeline_debug_check", "scheduler_max_tasks_per_tick")}
    cfg._set("scheduler_device_solve_min_cells", 0)
    cfg._set("scheduler_pipeline_enabled", True)
    cfg._set("scheduler_pipeline_debug_check", True)
    cfg._set("scheduler_max_tasks_per_tick", 512)
    try:
        cluster, raylets = _port_cluster(16, with_tpu=True)
        specs = _make_specs(ttask_spec, tids, cluster, 4_000, 8)
        head = raylets[0]
        with head._lock:
            for spec in specs:
                task = traylet._PendingTask(spec, lambda r, w: None, 0)
                head._pending.append(task)
                head._by_task_id[spec.task_id] = task
        head.schedule_tick()
        with head._lock:
            assert not head._pending
        held = sum(len(r._running) + r._dispatch_len + len(r._infeasible)
                   for r in raylets)
        assert held == len(specs)
        with cluster.lock:
            cluster.refresh_locked()
            assert np.all(cluster.matrix.available >= 0)
        assert cluster.device_mirror is not None
        assert cluster.device_mirror.full_syncs >= 1
    finally:
        for k, v in saved.items():
            cfg._set(k, v)
