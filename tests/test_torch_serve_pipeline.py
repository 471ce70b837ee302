"""The port's deployment-graph pipelines (ray_tpu_torch/serve/pipeline.py)
on the CPU: the contracts of tests/test_serve_pipeline.py.

Reference shape: python/ray/serve/pipeline/tests — step decorator,
INPUT wiring, fan-out/fan-in DAGs, class steps with constructor args,
replica pools."""

import time

import pytest

import ray_tpu_torch
from ray_tpu_torch.serve import pipeline


@pytest.fixture(autouse=True)
def _rt():
    ray_tpu_torch.init(num_cpus=8, device="cpu")
    try:
        yield
    finally:
        ray_tpu_torch.shutdown()


def test_linear_pipeline():
    @pipeline.step
    def double(x):
        return x * 2

    @pipeline.step
    def inc(x):
        return x + 1

    graph = inc(double(pipeline.INPUT))
    p = graph.deploy("linear")
    try:
        assert p.call(5) == 11
        assert p.call_many([1, 2, 3]) == [3, 5, 7]
    finally:
        p.shutdown()


def test_fan_out_fan_in():
    @pipeline.step
    def pre(x):
        return x + 1

    @pipeline.step
    def branch_a(x):
        return x * 10

    @pipeline.step
    def branch_b(x):
        return x * 100

    @pipeline.step
    def combine(a, b):
        return a + b

    shared = pre(pipeline.INPUT)
    graph = combine(branch_a(shared), branch_b(shared))
    p = graph.deploy("fanout")
    try:
        # (x+1)*10 + (x+1)*100
        assert p.call(1) == 220
    finally:
        p.shutdown()


def test_shared_node_evaluates_once(tmp_path):
    marker = str(tmp_path / "count")

    @pipeline.step
    class Counting:
        def __init__(self, path):
            self.path = path

        def __call__(self, x):
            with open(self.path, "a") as f:
                f.write("x\n")
            return ("mark", x)

    @pipeline.step
    def join(a, b):
        assert a == b
        return a

    shared = Counting(marker)(pipeline.INPUT)
    graph = join(shared, shared)
    p = graph.deploy("shared")
    try:
        assert p.call(3) == ("mark", 3)
        # both join inputs came from ONE evaluation of the shared node
        assert open(marker).read().count("x") == 1
    finally:
        p.shutdown()


def test_zero_arg_class_step_with_constant_arg():
    @pipeline.step
    class Gen:
        def __call__(self, n):
            return list(range(n))

    graph = Gen()(3)  # constant-only wiring must produce a node
    p = graph.deploy("gen")
    try:
        assert p.call("unused-input") == [0, 1, 2]
    finally:
        p.shutdown()


def test_class_step_with_constructor_args():
    @pipeline.step
    class Scaler:
        def __init__(self, factor):
            self.factor = factor

        def __call__(self, x):
            return x * self.factor

    graph = Scaler(7)(pipeline.INPUT)
    p = graph.deploy("scaler")
    try:
        assert p.call(6) == 42
    finally:
        p.shutdown()


def test_parallel_branches_run_concurrently():
    @pipeline.step
    def slow_a(x):
        time.sleep(0.5)
        return x

    @pipeline.step
    def slow_b(x):
        time.sleep(0.5)
        return x

    @pipeline.step
    def join(a, b):
        return a + b

    graph = join(slow_a(pipeline.INPUT), slow_b(pipeline.INPUT))
    p = graph.deploy("parallel")
    try:
        start = time.monotonic()
        assert p.call(1) == 2
        elapsed = time.monotonic() - start
        # branches overlap: well under the 1.0s serial time
        assert elapsed < 0.95
    finally:
        p.shutdown()


def test_replica_pool_round_robin():
    @pipeline.step(num_replicas=3)
    class WhichReplica:
        def __init__(self):
            self.ident = id(self)

        def __call__(self, _x):
            return self.ident

    graph = WhichReplica()(pipeline.INPUT)
    p = graph.deploy("rr")
    try:
        idents = set(p.call_many(list(range(6))))
        assert len(idents) == 3  # all replicas took traffic
    finally:
        p.shutdown()


def test_constant_args():
    @pipeline.step
    def add(x, y):
        return x + y

    graph = add(pipeline.INPUT, 100)
    p = graph.deploy("const")
    try:
        assert p.call(1) == 101
    finally:
        p.shutdown()
