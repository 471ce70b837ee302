"""The port's ray_tpu_torch.util adapters against the JAX package's
ray_tpu.util, on the CPU: Queue, the parallel iterators, the
multiprocessing Pool, the Dask scheduler shim, the joblib backend and
the user metrics.

Every scenario of tests/test_util.py outside ``ActorPool`` (which
tests/test_torch_data.py holds) runs on both packages, one runtime after
the other (the port's on ``init(device="cpu")``); each side keeps that
test's assertions, and the values (queue order, iterator items in the
order they arrive, pool results, graph results) are compared equal.
"""

import importlib

import numpy as np
import pytest
import torch

import ray_tpu
import ray_tpu_torch
from test_torch_client import _end_jax_leftovers

SIDES = (("jax", ray_tpu), ("torch", ray_tpu_torch))


def _mod(core, name):
    return importlib.import_module(f"{core.__name__}.util.{name}")


def _on_both(scenario, num_cpus: int = 4):
    """``scenario(core)`` on the JAX runtime, then on the port's ->
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


# ------------------------------------------------------------------ Queue


class TestQueue:
    def test_put_get(self):
        def scenario(core):
            q = _mod(core, "queue").Queue()
            q.put(1)
            q.put(2)
            size = q.size()
            got = [q.get(), q.get()]
            return size, got, q.empty()

        assert _on_both(scenario) == (2, [1, 2], True)

    def test_nowait_and_batch(self):
        def scenario(core):
            queue = _mod(core, "queue")
            q = queue.Queue(maxsize=2)
            q.put_nowait(1)
            q.put_nowait(2)
            full = q.full()
            with pytest.raises(queue.Full):
                q.put(3, timeout=0.05)
            first = q.get_nowait()
            q2 = queue.Queue()
            q2.put_nowait_batch([1, 2, 3])
            batch = q2.get_nowait_batch(2)
            with pytest.raises(queue.Empty):
                q2.get_nowait_batch(5)
            return full, first, batch, q2.qsize()

        assert _on_both(scenario) == (True, 1, [1, 2], 1)

    def test_get_timeout(self):
        def scenario(core):
            queue = _mod(core, "queue")
            q = queue.Queue()
            with pytest.raises(queue.Empty):
                q.get(timeout=0.05)
            with pytest.raises(queue.Empty):
                q.get_nowait()
            return q.empty()

        assert _on_both(scenario) is True

    def test_tensors_keep_order_device_and_bits(self):
        """The util phase's feed on the CPU: seeded prompt rows through
        from_items(..., num_shards=2).gather_sync() into a Queue, drained
        in batches of up to 4."""
        rows = np.random.default_rng(0).integers(0, 32000, size=(10, 16))

        def scenario(core):
            it = _mod(core, "iter").from_items(
                [torch.as_tensor(r) for r in rows], num_shards=2)
            q = _mod(core, "queue").Queue()
            q.put_nowait_batch(list(it.gather_sync()))
            drained = []
            while not q.empty():
                drained.append(q.get_nowait_batch(min(4, q.qsize())))
            return [[t.tolist() for t in b] for b in drained], \
                {str(t.device) for b in drained for t in b}

        batches, devices = _on_both(scenario)
        assert [len(b) for b in batches] == [4, 4, 2]
        assert devices == {"cpu"}
        assert sorted(r for b in batches for r in b) == sorted(
            rows.tolist())


# ------------------------------------------------------ parallel iterators


class TestParallelIterator:
    def test_from_items_gather_sync(self):
        def scenario(core):
            it = _mod(core, "iter").from_items(list(range(8)), num_shards=2)
            return it.gather_sync().take(8)

        assert sorted(_on_both(scenario)) == list(range(8))

    def test_for_each_filter_batch(self):
        def scenario(core):
            it = _mod(core, "iter").from_range(10, num_shards=2) \
                .for_each(lambda x: x * 2) \
                .filter(lambda x: x % 4 == 0)
            return it.gather_sync().take(100)

        assert sorted(_on_both(scenario)) == [0, 4, 8, 12, 16]

    def test_batch_flatten(self):
        def scenario(core):
            it = _mod(core, "iter").from_range(6, num_shards=2) \
                .batch(2).flatten()
            return it.take(10)

        assert sorted(_on_both(scenario)) == list(range(6))

    def test_gather_async(self):
        def scenario(core):
            it = _mod(core, "iter").from_range(8, num_shards=4)
            return sorted(it.gather_async().take(8))

        assert _on_both(scenario) == list(range(8))

    def test_local_shuffle_preserves_items(self):
        def scenario(core):
            it = _mod(core, "iter").from_range(20, num_shards=2) \
                .local_shuffle(5, seed=1)
            return it.gather_sync().take(100)

        assert sorted(_on_both(scenario)) == list(range(20))

    def test_shards_union_and_local_ops(self):
        def scenario(core):
            rti = _mod(core, "iter")
            a = rti.from_items(list(range(6)), num_shards=3)
            b = rti.from_iterators([[10, 11], [12]])
            both = a.union(b)
            shards = [s.take(10) for s in a.shards()]
            local = a.gather_sync().for_each(lambda x: x + 1) \
                .filter(lambda x: x % 2).batch(2).take(10)
            kept = a.select_shards([0, 2]).gather_sync().take(10)
            return (both.num_shards(), sorted(both.gather_sync().take(20)),
                    shards, local, kept, str(a))

        got = _on_both(scenario)
        assert got[0] == 5 and got[1] == [0, 1, 2, 3, 4, 5, 10, 11, 12]


# ------------------------------------------------------ multiprocessing


def _square(x):
    return x * x


def _add(a, b):
    return a + b


def _boom(x):
    raise ValueError("boom")


class TestMultiprocessingPool:
    def test_map(self):
        def scenario(core):
            with _mod(core, "multiprocessing").Pool(2) as p:
                return p.map(_square, range(10))

        assert _on_both(scenario) == [x * x for x in range(10)]

    def test_apply_async(self):
        def scenario(core):
            with _mod(core, "multiprocessing").Pool(2) as p:
                r = p.apply_async(_add, (2, 3))
                return r.get(), p.apply(_add, (4, 5))

        assert _on_both(scenario) == (5, 9)

    def test_starmap_imap(self):
        def scenario(core):
            with _mod(core, "multiprocessing").Pool(2) as p:
                return (p.starmap(_add, [(1, 2), (3, 4)]),
                        list(p.imap(_square, range(5))),
                        sorted(p.imap_unordered(_square, range(5))))

        assert _on_both(scenario) == ([3, 7], [0, 1, 4, 9, 16],
                                      [0, 1, 4, 9, 16])

    def test_async_error(self):
        def scenario(core):
            with _mod(core, "multiprocessing").Pool(1) as p:
                r = p.apply_async(_boom, (1,))
                with pytest.raises(ValueError) as err:
                    r.get()
                # the message names each package's own actor class
                return str(err.value).splitlines()[-1]

        assert _on_both(scenario) == "ValueError: boom"


# ---------------------------------------------------------------- dask shim


class TestDaskOnRayTpu:
    """ray_dask_get on plain graph dicts: no dask on either machine."""

    def test_basic_graph(self):
        from operator import add, mul

        dsk = {
            "a": 1,
            "b": (add, "a", 2),            # 3
            "c": (mul, "b", "b"),          # 9
            "alias": "c",
        }

        def scenario(core):
            get = _mod(core, "dask").ray_dask_get
            return get(dsk, "c"), get(dsk, ["a", "b", ["c", "alias"]])

        assert _on_both(scenario) == (9, [1, 3, [9, 9]])

    def test_nested_subtasks_and_tuple_keys(self):
        from operator import add

        def total(values):
            return sum(values)

        # dask-style tuple keys (collection chunks) + nested task args
        dsk = {
            ("x", 0): 10,
            ("x", 1): (add, ("x", 0), 5),
            "sum": (total, [("x", 0), ("x", 1), (add, 1, 2)]),
        }

        def scenario(core):
            return _mod(core, "dask").ray_dask_get(dsk, "sum")

        assert _on_both(scenario) == 28

    def test_tasks_run_on_cluster(self):
        import threading

        def ident():
            return threading.get_ident()

        dsk = {"t%d" % i: (ident,) for i in range(4)}

        def scenario(core):
            idents = _mod(core, "dask").ray_dask_get(
                dsk, ["t%d" % i for i in range(4)])
            # executed via the task path: worker threads, not this one
            return len(idents), threading.get_ident() in idents

        assert _on_both(scenario) == (4, False)


# ------------------------------------------------------- joblib and metrics


def test_joblib_backend_registers_and_sizes_its_pool():
    """register_ray installs a "ray" backend whose pool is the package's
    Pool. (A whole joblib.Parallel run on it never returns on the JAX
    package, with joblib 1.5: joblib waits for apply_async's callback,
    which its AsyncResult fires only inside get(); the port's run is the
    next test.)"""
    joblib = pytest.importorskip("joblib")
    from joblib.parallel import BACKENDS

    def scenario(core):
        _mod(core, "joblib").register_ray()
        backend = BACKENDS["ray"]()
        n_all = backend.effective_n_jobs(-1)
        n = backend.configure(n_jobs=2)
        pool = backend._pool
        out = (n_all, n, type(pool).__name__, len(pool._actors),
               pool.map(_square, range(4)))
        backend.terminate()
        return out

    assert _on_both(scenario) == (4, 2, "Pool", 2, [0, 1, 4, 9])
    assert joblib.parallel_backend  # the seam the README's example uses


def test_joblib_parallel_returns_on_the_ray_backend():
    """A whole joblib.Parallel run on the port's "ray" backend returns
    the right list: AsyncResult fires apply_async's callback when the
    result lands, as multiprocessing does, so joblib (which waits for
    the callback before it collects) gets its results. The JAX package
    keeps the hang (ROADMAP Queue C); the run has a bounded wait here, so
    a regression fails instead of hanging the suite."""
    import threading

    joblib = pytest.importorskip("joblib")

    _end_jax_leftovers()
    ray_tpu_torch.init(num_cpus=4, device="cpu")
    try:
        _mod(ray_tpu_torch, "joblib").register_ray()
        out = []

        def run():
            out.append(joblib.Parallel(n_jobs=2, backend="ray")(
                joblib.delayed(_square)(i) for i in range(6)))

        worker = threading.Thread(target=run, daemon=True)
        worker.start()
        worker.join(60)
        assert out == [[0, 1, 4, 9, 16, 25]], "joblib.Parallel never returned"
    finally:
        ray_tpu_torch.shutdown()


def test_metrics_are_the_observability_registry_types():
    from ray_tpu_torch.observability import metrics as obs
    from ray_tpu_torch.util import metrics

    assert (metrics.Counter, metrics.Gauge, metrics.Histogram) == (
        obs.Counter, obs.Gauge, obs.Histogram)
    assert metrics.__all__ == _mod(ray_tpu, "metrics").__all__
    c = metrics.Counter("util_requests_port", description="requests",
                        tag_keys=("route",))
    c.inc(tags={"route": "/predict"})
    c.inc(2, tags={"route": "/predict"})
    assert sum(c._series.values()) == 3


def test_util_exports_what_the_jax_package_exports():
    import ray_tpu.util as jutil
    import ray_tpu_torch.util as tutil

    import types

    def exported(pkg):  # submodules become attributes once imported
        return sorted(n for n, v in vars(pkg).items()
                      if not n.startswith("_")
                      and not isinstance(v, types.ModuleType))

    assert exported(tutil) == exported(jutil)
