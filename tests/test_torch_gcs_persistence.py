"""The port's ray_tpu_torch.gcs.persistence against the JAX package's
ray_tpu.gcs.persistence, on the CPU.

Every scenario of tests/test_gcs_persistence.py runs on both packages,
one runtime after the other (the port's on ``init(device="cpu")``): each
side keeps that test's assertions, and the restore counts, what the
restored runtime answers, and the snapshot's contents by key (KV, the
detached actors' names and arguments, the placement groups' bundles and
strategies, the nodes' resources) are compared equal. On top: a
detached actor's tensor arguments survive the snapshot on their device
with their bits.
"""

import importlib
import re
import time

import pytest
import torch

import ray_tpu
import ray_tpu_torch
from test_torch_client import _end_jax_leftovers

SIDES = (("jax", ray_tpu), ("torch", ray_tpu_torch))


def _init(core, **kw):
    if core is ray_tpu_torch:
        return core.init(device="cpu", **kw)
    _end_jax_leftovers()
    return core.init(**kw)


def _persistence(core):
    return importlib.import_module(f"{core.__name__}.gcs.persistence")


def _pg(core):
    return importlib.import_module(f"{core.__name__}.util.placement_group")


def _contents(data: dict) -> dict:
    """A snapshot's contents by key, without the ids the runtimes draw
    at random (placement groups', also in their bundles' resource
    names)."""
    return {
        "version": data["version"], "namespace_set": bool(data["namespace"]),
        "kv": data["kv"],
        "detached_actors": sorted(
            (a["name"], a["cls"].__name__, a["init_args"],
             sorted(a["init_kwargs"].items()), a["options"].lifetime)
            for a in data["detached_actors"]),
        "placement_groups": sorted(
            (p["name"], p["strategy"], [sorted(b.items())
                                        for b in p["bundles"]])
            for p in data["placement_groups"]),
        "nodes": sorted((n["is_head"], sorted(
            (re.sub(r"_[0-9a-f]{20,}$", "_<pg id>", k), v)
            for k, v in n["resources"].items())) for n in data["nodes"]),
    }


def _on_both(tmp_path, scenario):
    """``scenario(core, persistence, snapshot path)`` on each package in
    turn -> (JAX result, port result), each with the snapshot's contents
    by key."""
    out = []
    for name, core in SIDES:
        path = str(tmp_path / f"{name}_snapshot.bin")
        persistence = _persistence(core)
        try:
            result = scenario(core, persistence, path)
        finally:
            core.shutdown()
        out.append((result, _contents(persistence.load_snapshot(path))))
    assert out[1] == out[0]
    return out[1]


# ------------------------------- tests/test_gcs_persistence.py on both


def test_kv_survives_restart(tmp_path):
    def scenario(core, persistence, path):
        rt = _init(core, num_cpus=2)
        rt.kv_put("ns", b"key1", b"value1")
        rt.kv_put("other", b"key2", b"value2")
        persistence.save_snapshot(path)
        core.shutdown()

        rt2 = _init(core, num_cpus=2)
        counts = persistence.restore_snapshot(path)
        assert counts["kv"] == 2
        return counts, rt2.kv_get("ns", b"key1"), rt2.kv_get("other",
                                                             b"key2")

    (counts, v1, v2), contents = _on_both(tmp_path, scenario)
    assert (v1, v2) == (b"value1", b"value2")
    assert len(contents["kv"]) == 2


class Registry:
    def __init__(self):
        self.entries = {}

    def put(self, k, v):
        self.entries[k] = v
        return len(self.entries)

    def size(self):
        return len(self.entries)


def test_detached_actor_recreated(tmp_path):
    def scenario(core, persistence, path):
        _init(core, num_cpus=2)
        reg = core.remote(Registry).options(
            name="registry", lifetime="detached").remote()
        first = core.get(reg.put.remote("a", 1))
        persistence.save_snapshot(path)
        core.shutdown()

        _init(core, num_cpus=2)
        counts = persistence.restore_snapshot(path)
        assert counts["actors"] == 1
        reg2 = core.get_actor("registry")
        # fresh state, like the reference's restart-from-GCS
        return (first, counts, core.get(reg2.size.remote()),
                core.get(reg2.put.remote("x", 9)))

    (first, counts, size, after), contents = _on_both(tmp_path, scenario)
    assert (first, size, after) == (1, 0, 1)
    assert [a[0] for a in contents["detached_actors"]] == ["registry"]


class Pinger:
    def ping(self):
        return 1


def test_non_detached_actor_not_restored(tmp_path):
    def scenario(core, persistence, path):
        _init(core, num_cpus=2)
        a = core.remote(Pinger).options(name="ephemeral").remote()
        pinged = core.get(a.ping.remote())
        persistence.save_snapshot(path)
        core.shutdown()

        _init(core, num_cpus=2)
        counts = persistence.restore_snapshot(path)
        with pytest.raises(ValueError):
            core.get_actor("ephemeral")
        return pinged, counts

    (pinged, counts), contents = _on_both(tmp_path, scenario)
    assert pinged == 1 and counts["actors"] == 0
    assert contents["detached_actors"] == []


def test_placement_groups_replaced(tmp_path):
    def scenario(core, persistence, path):
        pgs = _pg(core)
        _init(core, num_cpus=4)
        pgs.placement_group([{"CPU": 1}, {"CPU": 1}], strategy="PACK",
                            name="mypg")
        persistence.save_snapshot(path)
        core.shutdown()

        _init(core, num_cpus=4)
        counts = persistence.restore_snapshot(path)
        pg = pgs.get_placement_group("mypg")
        ready = pg.wait(timeout_seconds=5)
        table = pgs.placement_group_table()
        return counts, ready, sorted(
            (row.get("name"), row["state"], row["strategy"])
            for row in table.values())

    (counts, ready, table), contents = _on_both(tmp_path, scenario)
    assert counts["placement_groups"] == 1 and ready
    assert ("mypg", "CREATED", "PACK") in table
    assert contents["placement_groups"] == [
        ("mypg", "PACK", [[("CPU", 1)], [("CPU", 1)]])]


def test_restore_nodes(tmp_path):
    def scenario(core, persistence, path):
        rt = _init(core, num_cpus=2)
        rt.add_node({"CPU": 4, "accel": 2})
        persistence.save_snapshot(path)
        core.shutdown()

        _init(core, num_cpus=2)
        counts = persistence.restore_snapshot(path, restore_nodes=True)
        total = core.cluster_resources()
        assert total["CPU"] >= 6 and total.get("accel") == 2
        return counts, total["CPU"], total.get("accel")

    (counts, cpus, accel), contents = _on_both(tmp_path, scenario)
    assert counts["nodes"] == 1 and accel == 2
    assert len(contents["nodes"]) == 2


def test_restore_idempotent_for_pgs_and_kv_counts(tmp_path):
    def scenario(core, persistence, path):
        rt = _init(core, num_cpus=4)
        _pg(core).placement_group([{"CPU": 1}], name="pg_idem")
        rt.kv_put("ns", b"k", b"v")
        persistence.save_snapshot(path)
        core.shutdown()

        _init(core, num_cpus=4)
        first = persistence.restore_snapshot(path)
        second = persistence.restore_snapshot(path)  # must not raise
        return first, second

    (first, second), _ = _on_both(tmp_path, scenario)
    assert first["placement_groups"] == 1 and first["kv"] == 1
    # counts report what was actually applied
    assert second["placement_groups"] == 0 and second["kv"] == 0


def test_periodic_snapshotter(tmp_path):
    def scenario(core, persistence, path):
        rt = _init(core, num_cpus=2)
        rt.kv_put("ns", b"k", b"v")
        snapper = persistence.PeriodicSnapshotter(path, interval_s=0.1)
        time.sleep(0.35)
        snapper.stop()
        core.shutdown()

        _init(core, num_cpus=2)
        return persistence.restore_snapshot(path)

    counts, contents = _on_both(tmp_path, scenario)
    assert counts["kv"] == 1


def test_idempotent_restore(tmp_path):
    def scenario(core, persistence, path):
        rt = _init(core, num_cpus=2)
        rt.kv_put("ns", b"k", b"v")
        core.remote(Pinger).options(name="d", lifetime="detached").remote()
        persistence.save_snapshot(path)
        core.shutdown()

        _init(core, num_cpus=2)
        persistence.restore_snapshot(path)
        counts = persistence.restore_snapshot(path)  # second apply
        return counts, core.get(core.get_actor("d").ping.remote())

    (counts, pinged), _ = _on_both(tmp_path, scenario)
    assert counts["actors"] == 0  # named actor already exists; skipped
    assert pinged == 1


# ----------------------------------------------------------- the port's own


class Holder:
    def __init__(self, weights, scale=1.0):
        self.weights = weights * scale

    def device_and_sum(self):
        return str(self.weights.device), self.weights.dtype, \
            self.weights.sum().item()


def test_detached_actor_tensor_args_keep_device_and_bits(tmp_path):
    """A detached actor built from tensors comes back from the snapshot
    built from the same tensors, on the device they left."""
    from ray_tpu_torch.gcs import persistence

    path = str(tmp_path / "snap.bin")
    weights = torch.randn(16, 8, generator=torch.Generator().manual_seed(0)
                          ).to(torch.bfloat16)
    ray_tpu_torch.init(num_cpus=2, device="cpu")
    try:
        h = ray_tpu_torch.remote(Holder).options(
            name="holder", lifetime="detached").remote(weights, scale=2.0)
        want = ray_tpu_torch.get(h.device_and_sum.remote())
        persistence.save_snapshot(path)
    finally:
        ray_tpu_torch.shutdown()
    [spec] = persistence.load_snapshot(path)["detached_actors"]
    assert torch.equal(spec["init_args"][0], weights)
    assert spec["init_args"][0].device == weights.device
    assert spec["init_kwargs"] == {"scale": 2.0}
    ray_tpu_torch.init(num_cpus=2, device="cpu")
    try:
        assert persistence.restore_snapshot(path)["actors"] == 1
        got = ray_tpu_torch.get(
            ray_tpu_torch.get_actor("holder").device_and_sum.remote())
    finally:
        ray_tpu_torch.shutdown()
    assert got == want and got[0] == "cpu"


def test_snapshot_refused_without_a_runtime_and_across_versions(tmp_path):
    import cloudpickle

    from ray_tpu.gcs import persistence as jpersistence
    from ray_tpu_torch.gcs import persistence

    with pytest.raises(RuntimeError, match="not initialized"):
        persistence.save_snapshot(str(tmp_path / "none.bin"))
    bad = tmp_path / "v2.bin"
    bad.write_bytes(cloudpickle.dumps({"version": 2}))
    with pytest.raises(ValueError) as got:
        persistence.load_snapshot(str(bad))
    with pytest.raises(ValueError) as want:
        jpersistence.load_snapshot(str(bad))
    assert str(got.value) == str(want.value)
    assert persistence.SNAPSHOT_VERSION == jpersistence.SNAPSHOT_VERSION
