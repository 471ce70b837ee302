"""The port's autoscaler against the JAX package's, on the CPU.

The 24 scenarios of tests/test_autoscaler.py on the port's runtime
(``init(device="cpu")``) and on its process clusters, whose provider
configs say ``gcs_device: "cpu"``. The planner's scenarios and the
in-process ones (the fake provider, the commands layer on it) run on
both packages and compare their values; the process, command and
inventory providers run the port's. Then ``get_nodes_to_launch`` on
both packages over 240 seeded random node-type, capacity and demand
sets (task and bundle demands both): the plans are equal. Last, the
card path's twin with ``"GPU"`` as a plain resource: a pending
``{"GPU": 1}`` bundle launches one ``gpu`` node, a ``py_modules`` task
runs there, the idle node is terminated, and ``down`` leaves no
process and no state file. Every wait is bounded.
"""

import importlib
import os
import sys
import time

import cloudpickle
import numpy as np
import pytest

import ray_tpu
import ray_tpu_torch
from test_torch_client import _end_jax_leftovers

cloudpickle.register_pickle_by_value(sys.modules[__name__])

SIDES = (("jax", ray_tpu), ("torch", ray_tpu_torch))

TYPES = {
    "small": {"resources": {"CPU": 2}, "min_workers": 0, "max_workers": 10},
    "big": {"resources": {"CPU": 16, "GPU": 4}, "min_workers": 0,
            "max_workers": 4},
}


def _as(core, module=""):
    """``core.autoscaler`` or one of its modules."""
    return importlib.import_module(
        f"{core.__name__}.autoscaler" + (f".{module}" if module else ""))


def _plan_both(*args, **kwargs):
    """get_nodes_to_launch on both packages -> the port's plan, after
    asserting it equals the JAX one."""
    plans = [_as(core).get_nodes_to_launch(*args, **kwargs)
             for _, core in SIDES]
    assert plans[1] == plans[0]
    return plans[1]


def _on_both(scenario, num_cpus: int):
    """``scenario(core)`` on a fresh JAX runtime, then on the port's ->
    the port's result, after asserting it equals the JAX one."""
    out = []
    for _, core in SIDES:
        if core is ray_tpu_torch:
            core.init(num_cpus=num_cpus, device="cpu")
        else:
            _end_jax_leftovers()
            core.init(num_cpus=num_cpus)
        try:
            out.append(scenario(core))
        finally:
            core.shutdown()
    assert out[1] == out[0]
    return out[1]


@pytest.fixture(autouse=True)
def _own_state_dir(tmp_path, monkeypatch):
    """``ray up``'s state files under this test's tmp_path, and a small
    object store for every raylet a provider starts (the port's
    segments are prefaulted). The port's cached Config is dropped after
    the test: built under this environment it holds the 64 MiB store,
    which would reach the next test file run in this process."""
    from ray_tpu_torch._private.config import Config

    monkeypatch.setenv("HOME", str(tmp_path))
    monkeypatch.setenv("RAY_TPU_object_store_memory", str(64 << 20))
    yield
    Config.reset()


# ------------------------------------------------ pure planning function
def test_no_demand_no_launch():
    assert _plan_both(TYPES, {}, [], []) == {}


def test_simple_demand_launches_fitting_type():
    # four 1-cpu demands pack onto two small (2-cpu) nodes
    assert _plan_both(TYPES, {}, [], [{"CPU": 1}] * 4) == {"small": 2}


def test_demand_prefers_tight_fit():
    assert _plan_both(TYPES, {}, [], [{"GPU": 1}]) == {"big": 1}


def test_existing_capacity_absorbs_demand():
    assert _plan_both(TYPES, {"small": 1}, [{"CPU": 2}],
                      [{"CPU": 1}, {"CPU": 1}]) == {}


def test_max_workers_per_type_respected():
    assert _plan_both(TYPES, {}, [], [{"GPU": 4}] * 10).get("big", 0) <= 4


def test_global_max_workers_respected():
    plan = _plan_both(TYPES, {}, [], [{"CPU": 2}] * 50, max_workers=5)
    assert sum(plan.values()) <= 5


def test_min_workers_topped_up():
    types = {"small": {"resources": {"CPU": 2}, "min_workers": 3,
                       "max_workers": 10}}
    assert _plan_both(types, {"small": 1}, [], []) == {"small": 2}


def test_infeasible_demand_ignored():
    assert _plan_both(TYPES, {}, [], [{"CPU": 999}]) == {}


def test_pg_bundle_demands():
    assert _plan_both(TYPES, {}, [], [],
                      pg_demands=[[{"CPU": 2}, {"CPU": 2}]]) == {"small": 2}


def test_pg_shadow_resources_stripped():
    assert _plan_both(
        TYPES, {}, [],
        [{"CPU_group_0_abcdef": 1.0, "bundle_group_abcdef": 1}]) == \
        {"small": 1}


# --------------------------------------------- fake-provider integration
def _fake_autoscaler(core, types, idle_timeout_minutes):
    a = _as(core)
    provider = a.FakeMultiNodeProvider({"head_node_type": "head"})
    return a.StandardAutoscaler(
        {"available_node_types": types, "max_workers": 8,
         "idle_timeout_minutes": idle_timeout_minutes}, provider)


def test_autoscaler_scales_up_for_pending_tasks():
    def scenario(core):
        autoscaler = _fake_autoscaler(core, TYPES, 999)

        @core.remote(num_cpus=2)
        def heavy():
            return 1

        refs = [heavy.remote() for _ in range(4)]
        # infeasible on the 1-CPU head until the autoscaler acts
        plan = autoscaler.update()
        assert sum(plan.values()) >= 1
        return plan, core.get(refs, timeout=10)

    assert _on_both(scenario, num_cpus=1)[1] == [1, 1, 1, 1]


def test_autoscaler_scales_down_idle():
    def scenario(core):
        autoscaler = _fake_autoscaler(core, TYPES, 0.2 / 60.0)  # 0.2 s

        @core.remote(num_cpus=2)
        def heavy():
            return 1

        ref = heavy.remote()
        autoscaler.update()
        assert core.get([ref], timeout=10) == [1]
        before = len(core.nodes())
        assert before >= 2
        autoscaler.update()  # observe the node as free; idle clock starts
        time.sleep(0.4)
        autoscaler.update()
        alive = [n for n in core.nodes() if n["Alive"]]
        assert len(alive) < before
        return before, len(alive), autoscaler.num_terminations

    before, alive, terminations = _on_both(scenario, num_cpus=1)
    assert terminations >= 1 and alive < before


def test_min_workers_launched_at_start():
    types = {"small": {"resources": {"CPU": 2}, "min_workers": 2,
                       "max_workers": 5}}

    def scenario(core):
        _fake_autoscaler(core, types, 999).update()
        return len([n for n in core.nodes() if n["Alive"]])

    assert _on_both(scenario, num_cpus=1) == 3  # head + 2 min workers


# ----------------------------------------------------------- commands layer


CLUSTER_YAML = """
cluster_name: cmdtest
provider:
  type: fake_multinode
head_node_type: head
available_node_types:
  head:
    resources: {CPU: 2}
    min_workers: 0
    max_workers: 0
  cpu_worker:
    resources: {CPU: 1}
    min_workers: 2
    max_workers: 4
idle_timeout_minutes: 1
"""


def _process_provider(**extra):
    return {"type": "process", "gcs_device": "cpu",
            "heartbeat_period_ms": 100, "num_heartbeats_timeout": 30,
            **extra}


def test_load_cluster_config_validates_and_defaults():
    configs = [_as(core, "commands").load_cluster_config(CLUSTER_YAML)
               for _, core in SIDES]
    assert configs[1] == configs[0]
    cfg = configs[1]
    assert cfg["cluster_name"] == "cmdtest"
    assert cfg["max_workers"] == 4  # summed from worker types
    assert cfg["available_node_types"]["cpu_worker"]["min_workers"] == 2
    for _, core in SIDES:
        load = _as(core, "commands").load_cluster_config
        with pytest.raises(ValueError):
            load({"head_node_type": "nope",
                  "provider": {"type": "fake_multinode"},
                  "available_node_types": {"a": {}}})
        with pytest.raises(ValueError):
            load({"provider": {}})


def test_ray_up_and_down_fake_provider():
    def scenario(core):
        commands = _as(core, "commands")
        before = len(core.nodes())
        handle = commands.create_or_update_cluster(CLUSTER_YAML)
        try:
            # min_workers came up as raylets in the runtime
            workers = len(handle.worker_ids())
            added = len(core.nodes()) - before
            assert commands.get_head_node_ip("cmdtest")
            ips = len(commands.get_worker_node_ips("cmdtest"))
            commands.create_or_update_cluster(CLUSTER_YAML)  # idempotent
            again = len(handle.worker_ids())
        finally:
            commands.teardown_cluster("cmdtest")
        return workers, added, ips, again, len(core.nodes()) - before

    assert _on_both(scenario, num_cpus=4) == (2, 2, 2, 2, 0)


def test_ray_up_process_provider_runs_real_processes():
    """provider type `process`: a GCS and raylet OS processes; tasks run
    on them."""
    from ray_tpu_torch.autoscaler.commands import (
        create_or_update_cluster,
        teardown_cluster,
    )
    from ray_tpu_torch.cluster.process_cluster import ClusterClient

    cfg = {
        "cluster_name": "proc-up",
        "provider": _process_provider(),
        "head_node_type": "head",
        "available_node_types": {
            "head": {"resources": {"CPU": 1}, "min_workers": 0,
                     "max_workers": 0},
            "worker": {"resources": {"CPU": 1}, "min_workers": 1,
                       "max_workers": 2},
        },
    }
    handle = create_or_update_cluster(cfg)
    try:
        assert len(handle.worker_ids()) == 1
        client = ClusterClient(handle.provider.gcs_address)
        try:
            ref = client.submit(lambda: os.getpid())
            assert client.get(ref, timeout=60.0) != os.getpid()
        finally:
            client.close()
    finally:
        teardown_cluster("proc-up")


def test_monitor_scales_up_on_demand():
    """The ray-up monitor loop launches nodes when demand queues."""
    from ray_tpu_torch.autoscaler.commands import (
        create_or_update_cluster,
        teardown_cluster,
    )

    cfg = {
        "cluster_name": "montest",
        "provider": {"type": "fake_multinode"},
        "head_node_type": "head",
        "available_node_types": {
            "head": {"resources": {"CPU": 2}, "min_workers": 0,
                     "max_workers": 0},
            "big": {"resources": {"CPU": 16}, "min_workers": 0,
                    "max_workers": 2},
        },
        "idle_timeout_minutes": 60,
    }
    ray_tpu_torch.init(num_cpus=4, device="cpu")
    try:
        handle = create_or_update_cluster(cfg)
        try:
            handle.start_monitor(interval_s=0.1)

            @ray_tpu_torch.remote(num_cpus=16)
            def big():
                return "scaled"

            ref = big.remote()  # infeasible until the monitor launches
            assert ray_tpu_torch.get([ref], timeout=30)[0] == "scaled"
            deadline = time.monotonic() + 10
            while time.monotonic() < deadline and not handle.worker_ids():
                time.sleep(0.05)
            assert len(handle.worker_ids()) >= 1
        finally:
            teardown_cluster("montest")
    finally:
        ray_tpu_torch.shutdown()


def test_process_cluster_scales_up_from_real_queued_demand():
    """Raylet-process queue depth (node_stats.queued_demands) drives
    LoadMetrics, so `ray up` scales a process cluster from queued
    demand, not only to min_workers."""
    from ray_tpu_torch.autoscaler.commands import (
        create_or_update_cluster,
        teardown_cluster,
    )
    from ray_tpu_torch.cluster.process_cluster import ClusterClient

    cfg = {
        "cluster_name": "proc-demand",
        "provider": _process_provider(),
        "head_node_type": "head",
        "idle_timeout_minutes": 60,
        "available_node_types": {
            "head": {"resources": {"CPU": 1}, "min_workers": 0,
                     "max_workers": 0},
            "worker": {"resources": {"CPU": 1}, "min_workers": 0,
                       "max_workers": 2},
        },
    }
    handle = create_or_update_cluster(cfg)
    try:
        assert len(handle.worker_ids()) == 0  # min_workers=0: no nodes
        client = ClusterClient(handle.provider.gcs_address)
        try:
            # 6 x 1-CPU sleep tasks swamp the 1-CPU head: they queue on
            # the head raylet process, seen only through its node_stats
            refs = [client.submit(
                lambda: __import__("time").sleep(1.5) or 1)
                for _ in range(6)]
            handle.start_monitor(interval_s=0.3)
            deadline = time.monotonic() + 60.0
            while time.monotonic() < deadline:
                if len(handle.worker_ids()) >= 1:
                    break
                time.sleep(0.2)
            assert len(handle.worker_ids()) >= 1, (
                "queued raylet-process demand never launched a worker")
            for r in refs:
                assert client.get(r, timeout=120.0) == 1
        finally:
            client.close()
    finally:
        teardown_cluster("proc-demand")


def test_command_provider_launches_nodes_by_running_commands():
    """provider type `command` (the SSH shape): a node comes up by
    running a shell command whose stdout announces the raylet; the
    default command starts the port's raylet server."""
    from ray_tpu_torch.autoscaler.commands import (
        CommandNodeProvider,
        create_or_update_cluster,
        teardown_cluster,
    )
    from ray_tpu_torch.cluster.process_cluster import ClusterClient

    assert "-m ray_tpu_torch.cluster.raylet_server" in \
        CommandNodeProvider.DEFAULT_CREATE
    cfg = {
        "cluster_name": "cmd-up",
        "provider": {"type": "command", "gcs_device": "cpu",
                     "heartbeat_period_ms": 100,
                     "num_heartbeats_timeout": 30},
        "head_node_type": "head",
        "available_node_types": {
            "head": {"resources": {"CPU": 1}, "min_workers": 0,
                     "max_workers": 0},
            "worker": {"resources": {"CPU": 1}, "min_workers": 1,
                       "max_workers": 2},
        },
    }
    handle = create_or_update_cluster(cfg)
    try:
        assert len(handle.worker_ids()) == 1
        assert handle.provider.gcs_address
        client = ClusterClient(handle.provider.gcs_address)
        try:
            ref = client.submit(lambda: 40 + 2)
            assert client.get(ref, timeout=60.0) == 42
        finally:
            client.close()
        # terminate through the provider: the node's process dies
        wid = handle.worker_ids()[0]
        handle.provider.terminate_node(wid)
        assert not handle.provider.is_running(wid)
    finally:
        teardown_cluster("cmd-up")


# ------------------------------------------------------ cloud provider tier
def test_aws_provider_create_terminate_tag_semantics():
    from ray_tpu_torch.autoscaler.aws_provider import (
        AwsNodeProvider,
        FakeEC2Client,
    )
    from ray_tpu_torch.autoscaler.node_provider import (
        NODE_KIND_WORKER,
        TAG_NODE_KIND,
        TAG_USER_NODE_TYPE,
    )

    ec2 = FakeEC2Client()
    provider = AwsNodeProvider({"type": "aws", "_client": ec2}, "c1")
    other = AwsNodeProvider({"type": "aws", "_client": ec2}, "c2")

    provider.create_node({"InstanceType": "m5.large"},
                         {TAG_NODE_KIND: NODE_KIND_WORKER,
                          TAG_USER_NODE_TYPE: "cpu"}, 3)
    other.create_node({}, {TAG_NODE_KIND: NODE_KIND_WORKER,
                           TAG_USER_NODE_TYPE: "cpu"}, 1)
    workers = provider.non_terminated_nodes(
        {TAG_NODE_KIND: NODE_KIND_WORKER})
    assert len(workers) == 3  # cluster-name scoping excludes c2's node
    assert provider.non_terminated_nodes({TAG_USER_NODE_TYPE: "gpu"}) == []
    nid = workers[0]
    assert provider.is_running(nid)
    assert provider.internal_ip(nid).startswith("10.0.0.")
    assert provider.node_tags(nid)[TAG_USER_NODE_TYPE] == "cpu"
    provider.set_node_tags(nid, {"ray-node-status": "up-to-date"})
    assert provider.node_tags(nid)["ray-node-status"] == "up-to-date"
    provider.terminate_node(nid)
    assert not provider.is_running(nid)
    assert len(provider.non_terminated_nodes({})) == 2


def test_aws_provider_drives_autoscaler_loop():
    def scenario(core):
        aws = _as(core, "aws_provider")
        np_mod = _as(core, "node_provider")
        ec2 = aws.FakeEC2Client()
        provider = aws.AwsNodeProvider({"type": "aws", "_client": ec2},
                                       "asg")
        provider.create_node({}, {np_mod.TAG_NODE_KIND: np_mod.NODE_KIND_HEAD,
                                  np_mod.TAG_USER_NODE_TYPE: "head"}, 1)
        config = {
            "cluster_name": "asg",
            "provider": {"type": "aws", "_client": ec2},
            "head_node_type": "head",
            "idle_timeout_minutes": 0,
            "available_node_types": {
                "head": {"resources": {"CPU": 0}, "min_workers": 0,
                         "max_workers": 0},
                "cpu": {"resources": {"CPU": 4}, "min_workers": 2,
                        "max_workers": 4},
            },
        }
        autoscaler = _as(core).StandardAutoscaler(config, provider)
        plan = autoscaler.update()
        autoscaler.load_metrics.close()
        return plan, len(provider.non_terminated_nodes(
            {np_mod.TAG_NODE_KIND: np_mod.NODE_KIND_WORKER}))

    assert _on_both(scenario, num_cpus=2) == ({"cpu": 2}, 2)  # min_workers


def test_ssh_command_runner_argv_contract(tmp_path):
    """SSHCommandRunner builds the standard ssh/rsync vectors, equal on
    both packages but for the control socket, which lies under each
    package's own root."""
    argvs = []
    for side, core in SIDES:
        calls = []

        def fake_exec(argv, calls=calls):
            calls.append(argv)
            return 0, "ok", ""

        runner = _as(core, "command_runner").SSHCommandRunner(
            "10.0.0.7", user="ubuntu", port=2222, ssh_key="/k.pem",
            exec_fn=fake_exec)
        assert runner.run("echo hi && uptime") == (0, "ok")
        runner.run_rsync_up("/src/dir", "/dst/dir")
        root = os.path.join(str(tmp_path), ".ray_tpu" if side == "jax"
                            else ".ray_tpu_torch", "ssh_sockets")
        assert runner.control_path.startswith(root + os.sep)
        argvs.append([[a.replace(runner.control_path, "<socket>")
                       for a in argv] for argv in calls])
    assert argvs[1] == argvs[0]
    argv, rsync = argvs[1]
    assert argv[0] == "ssh" and "BatchMode=yes" in argv
    assert ["-p", "2222"] == argv[argv.index("-p"):argv.index("-p") + 2]
    assert ["-i", "/k.pem"] == argv[argv.index("-i"):argv.index("-i") + 2]
    assert "ubuntu@10.0.0.7" in argv
    assert argv[-1].startswith("bash -lc ")
    assert rsync[0] == "rsync" and rsync[1] == "-az"
    assert rsync[-1] == "ubuntu@10.0.0.7:/dst/dir"


def test_node_updater_bootstrap_and_failure_tagging(tmp_path):
    from ray_tpu_torch.autoscaler.command_runner import LocalCommandRunner
    from ray_tpu_torch.autoscaler.updater import NodeUpdater, NodeUpdaterError

    class TagSink:
        def __init__(self):
            self.tags = {}

        def set_node_tags(self, nid, tags):
            self.tags.setdefault(nid, {}).update(tags)

    (tmp_path / "payload.txt").write_text("cargo")
    sink = TagSink()
    marker = tmp_path / "order.txt"
    updater = NodeUpdater(
        "n1", sink, LocalCommandRunner(),
        initialization_commands=[f"echo init >> {marker}"],
        setup_commands=[f"echo setup >> {marker}"],
        start_commands=[f"echo start >> {marker}"],
        file_mounts={str(tmp_path / "mounted.txt"):
                     str(tmp_path / "payload.txt")})
    updater.run()
    assert marker.read_text().split() == ["init", "setup", "start"]
    assert (tmp_path / "mounted.txt").read_text() == "cargo"
    assert sink.tags["n1"]["ray-node-status"] == "up-to-date"

    bad = NodeUpdater("n2", sink, LocalCommandRunner(),
                      setup_commands=["exit 7"])
    with pytest.raises(NodeUpdaterError, match="rc=7"):
        bad.run()
    assert sink.tags["n2"]["ray-node-status"] == "update-failed"


def test_ray_up_inventory_of_local_machines():
    """`ray up` against an inventory of local machines: head and workers
    bootstrap through NodeUpdater and start the port's raylet processes,
    which run tasks."""
    from ray_tpu_torch.autoscaler.commands import (
        create_or_update_cluster,
        teardown_cluster,
    )
    from ray_tpu_torch.autoscaler.node_provider import TAG_NODE_STATUS
    from ray_tpu_torch.cluster.process_cluster import ClusterClient

    cfg = {
        "cluster_name": "inv-up",
        "provider": {
            "type": "inventory", "gcs_device": "cpu",
            "machines": [{"host": "127.0.0.1", "local": True}
                         for _ in range(3)],
            "setup_commands": ["true"],
        },
        "head_node_type": "head",
        "available_node_types": {
            "head": {"resources": {"CPU": 1}, "min_workers": 0,
                     "max_workers": 0},
            "worker": {"resources": {"CPU": 1}, "min_workers": 2,
                       "max_workers": 2},
        },
    }
    handle = create_or_update_cluster(cfg)
    try:
        assert len(handle.worker_ids()) == 2
        for nid in handle.worker_ids():
            assert handle.provider.node_tags(nid)[
                TAG_NODE_STATUS] == "up-to-date"
            assert handle.provider._nodes[nid]["log"].startswith(
                "/tmp/ray_tpu_torch_inv-up_")
        client = ClusterClient(handle.provider.gcs_address)
        try:
            ref = client.submit(lambda: os.getpid())
            assert client.get(ref, timeout=60.0) != os.getpid()
        finally:
            client.close()
    finally:
        teardown_cluster("inv-up")


# ----------------------------------------------------------------- parity


def _random_case(rng):
    names = ["CPU", "GPU", "memory", "accel"]
    types = {}
    for t in range(int(rng.integers(1, 5))):
        res = {n: float(rng.integers(1, 17)) for n in names
               if n == "CPU" or rng.random() < 0.4}
        lo = int(rng.integers(0, 3))
        types[f"t{t}"] = {"resources": res, "min_workers": lo,
                          "max_workers": lo + int(rng.integers(0, 6))}

    def demand():
        d = {n: float(rng.integers(1, 9)) / float(rng.choice([1, 2, 4]))
             for n in names if rng.random() < 0.5}
        if rng.random() < 0.2:  # a placement group's shadow resources
            d = {f"{k}_group_0_{'ab' * 8}": v for k, v in d.items()}
            d[f"bundle_group_{'ab' * 8}"] = 0.001
        return d

    existing = {t: int(rng.integers(0, 3)) for t in types
                if rng.random() < 0.5}
    capacity = [{n: float(rng.integers(0, 9)) for n in names
                 if rng.random() < 0.6}
                for _ in range(int(rng.integers(0, 4)))]
    tasks = [demand() for _ in range(int(rng.integers(0, 12)))]
    bundles = [[demand() for _ in range(int(rng.integers(1, 4)))]
               for _ in range(int(rng.integers(0, 4)))]
    max_workers = int(rng.integers(1, 30))
    return types, existing, capacity, tasks, bundles, max_workers


def test_get_nodes_to_launch_equal_on_both_packages():
    rng = np.random.default_rng(0)
    launched = 0
    for case in range(240):
        types, existing, capacity, tasks, bundles, max_workers = \
            _random_case(rng)
        plan = _plan_both(types, existing, capacity, tasks,
                          pg_demands=bundles, max_workers=max_workers)
        launched += sum(plan.values())
    assert launched > 240  # the sets launch nodes, not only empty plans


# ------------------------------------------------- the card path's twin


_GPU_CFG = {
    "cluster_name": "gpu-twin",
    "provider": _process_provider(),
    "head_node_type": "head",
    "idle_timeout_minutes": 1.5 / 60.0,
    "available_node_types": {
        "head": {"resources": {"CPU": 2}, "min_workers": 0,
                 "max_workers": 0},
        "gpu": {"resources": {"CPU": 2, "GPU": 1}, "min_workers": 0,
                "max_workers": 1},
    },
}


def _until(predicate, timeout, what):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if predicate():
            return
        time.sleep(0.05)
    pytest.fail(f"timed out waiting for {what}")


def test_pending_gpu_bundle_launches_node_for_py_modules_task(tmp_path):
    from ray_tpu_torch._private.runtime_env import normalize
    from ray_tpu_torch._private.runtime_env_packaging import KV_NAMESPACE
    from ray_tpu_torch.autoscaler.commands import (
        _state_path,
        create_or_update_cluster,
        teardown_cluster,
    )
    from ray_tpu_torch.cluster.process_cluster import ClusterClient

    pkg = tmp_path / "twin_pkg"
    pkg.mkdir()
    (pkg / "twin_serving.py").write_text(
        "import os\n\ndef serve(x):\n"
        "    return x * 2, os.environ.get('TWIN_TAG')\n")
    handle = create_or_update_cluster(dict(_GPU_CFG))
    client = ClusterClient(handle.provider.gcs_address)
    pids = list(handle.provider.state()["pids"])
    try:
        assert handle.worker_ids() == []
        pg = client.create_placement_group([{"GPU": 1, "CPU": 1}])
        assert client.pg_info(pg)["state"] == "PENDING"
        handle.start_monitor(interval_s=0.3)
        _until(lambda: client.pg_info(pg)["state"] == "CREATED", 60,
               "the group to be placed on a launched node")
        assert len(handle.worker_ids()) == 1
        assert handle.autoscaler.num_launches == 1
        client.remove_placement_group(pg)
        pids = list(handle.provider.state()["pids"])

        env = {"py_modules": [str(pkg)], "env_vars": {"TWIN_TAG": "t1"}}
        uri = normalize(dict(env))["py_modules"][0]

        def task(x):
            import twin_serving

            return twin_serving.serve(x)

        ref = client.submit(task, (21,), resources={"GPU": 1},
                            runtime_env=env)
        assert client.get(ref, timeout=60.0) == (42, "t1")
        assert client.kv_get(uri.encode(), ns=KV_NAMESPACE) is not None
        assert handle.autoscaler.num_launches == 1

        _until(lambda: handle.autoscaler.num_terminations == 1, 60,
               "the idle gpu node to be terminated")
        assert handle.worker_ids() == []
    finally:
        client.close()
        teardown_cluster("gpu-twin")
    assert not os.path.exists(_state_path("gpu-twin"))

    def gone(pid):
        try:
            os.kill(pid, 0)
        except ProcessLookupError:
            return True
        with open(f"/proc/{pid}/stat") as f:  # a zombie is gone too
            return f.read().split()[2] == "Z"

    _until(lambda: all(gone(p) for p in pids), 30,
           "every cluster process to exit")
