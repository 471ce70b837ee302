"""The 3 scenarios of tests/test_chaos.py on the port's runtime: random
node kills by the port's ``NodeKiller`` (``_private/test_utils.py``)
while tasks retry and a restartable actor keeps serving, on
``init(device="cpu")`` with three 2-CPU worker nodes, with the
reference test's inputs and thresholds."""

import time

import pytest

import ray_tpu_torch
from ray_tpu_torch._private.test_utils import NodeKiller, wait_for_condition

pytestmark = pytest.mark.chaos


@pytest.fixture
def chaos_cluster():
    rt = ray_tpu_torch.init(num_cpus=1, device="cpu")  # work runs on workers
    try:
        for _ in range(3):
            rt.add_node({"CPU": 2})
        yield rt
    finally:
        ray_tpu_torch.shutdown()


def test_chaos_task_retry(chaos_cluster):
    killer = NodeKiller(kill_interval_s=0.1, replace=True,
                        node_resources={"CPU": 2})

    @ray_tpu_torch.remote(num_cpus=2, max_retries=20, retry_exceptions=True)
    def work(i):
        time.sleep(0.02)
        return i * 2

    killer.start()
    try:
        results = ray_tpu_torch.get([work.remote(i) for i in range(40)],
                                    timeout=60)
    finally:
        killer.stop()
    assert results == [i * 2 for i in range(40)]
    assert killer.num_killed > 0


def test_chaos_actor_restart(chaos_cluster):
    @ray_tpu_torch.remote(num_cpus=2, max_restarts=-1, max_task_retries=20)
    class Counter:
        def __init__(self):
            self.n = 0

        def incr(self):
            self.n += 1
            return self.n

    counter = Counter.remote()
    assert ray_tpu_torch.get([counter.incr.remote()], timeout=10) == [1]
    killer = NodeKiller(kill_interval_s=0.15, replace=True,
                        node_resources={"CPU": 2})
    killer.start()
    try:
        ok = 0
        for _ in range(20):
            try:
                ray_tpu_torch.get([counter.incr.remote()], timeout=30)
                ok += 1
            except Exception:
                pass
        # the actor kept serving across kills (its state resets on
        # restart, as the reference's non-checkpointed actors' does)
        assert ok >= 15
    finally:
        killer.stop()


def test_node_killer_replaces_nodes(chaos_cluster):
    killer = NodeKiller(kill_interval_s=999, replace=True)
    before = len([n for n in ray_tpu_torch.nodes() if n["Alive"]])
    assert killer.kill_one()
    assert wait_for_condition(
        lambda: len([n for n in ray_tpu_torch.nodes()
                     if n["Alive"]]) == before)
    assert killer.num_killed == 1 and killer.num_added == 1
