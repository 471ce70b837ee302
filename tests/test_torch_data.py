"""The port's ray_tpu_torch.data against the JAX package's ray_tpu.data on
the CPU.

- Every scenario of tests/test_data.py runs on both packages from the
  same inputs and seeds: each side keeps that test's assertions, and the
  results are compared equal, in order wherever the operation defines
  one (the two packages' seeded shuffles give one order).
- ``random_shuffle``, ``split``, ``groupby``/``sort`` and the aggregates
  on more inputs; files written by one package read back by the other.
- ``Dataset.to_device(device="cpu")`` against ``Dataset.to_jax``: the
  same batches with the same values and dtypes (JAX's x64-off rule),
  tolerance 0, as both are copies; ``device_put=False``; ``TypeError``
  on non-numeric columns.
"""

import ast
import contextlib
import importlib
import os
from dataclasses import dataclass
from typing import Any

import numpy as np
import pytest
import torch

import ray_tpu
import ray_tpu.cluster_utils
import ray_tpu.util.scheduling_strategies
import ray_tpu_torch
import ray_tpu_torch.cluster_utils
import ray_tpu_torch.util.scheduling_strategies
from ray_tpu import data as jdata
from ray_tpu_torch import data as tdata


# the shuffle-spill scenario of tests/test_data.py: its 48 rows carry
# PAYLOAD bytes here (1 MiB there), its runtime's object_store_memory
PAYLOAD = 128 * 1024
SMALL_STORE = 16 * 1024 * 1024


@dataclass
class Side:
    name: str
    pkg: Any
    data: Any
    tmp: Any
    rt: Any = None  # the runtime, or the Cluster of a cluster scenario


def _init(side_name: str, **kw):
    if side_name == "jax":
        return ray_tpu.init(**kw)
    return ray_tpu_torch.init(device="cpu", **kw)


@contextlib.contextmanager
def _runtime(side_name: str, kind: str):
    """The runtime a scenario of tests/test_data.py runs on: the
    ``ray_init`` fixture, ``ray_start_cluster``, or a small store."""
    pkg = ray_tpu if side_name == "jax" else ray_tpu_torch
    if kind == "cluster":
        head = {} if side_name == "jax" else {"device": "cpu"}
        cluster = pkg.cluster_utils.Cluster(head_node_args=head)
        try:
            yield cluster
        finally:
            cluster.shutdown()
        return
    if kind == "small_store":
        rt = _init(side_name, num_cpus=4, object_store_memory=SMALL_STORE)
    else:
        rt = _init(side_name, num_cpus=8)
    try:
        yield rt
    finally:
        pkg.shutdown()


@pytest.fixture
def both():
    """Both runtimes up at once, for tests that pass data between them."""
    ray_tpu.init(num_cpus=8)
    ray_tpu_torch.init(num_cpus=8, device="cpu")
    try:
        yield
    finally:
        ray_tpu_torch.shutdown()
        ray_tpu.shutdown()


def _np(x):
    """A fed batch (jax array or torch tensor) -> numpy, dtype kept."""
    if isinstance(x, torch.Tensor):
        assert x.device.type == "cpu"
        return x.numpy()
    return np.asarray(x)


def _tree_np(batch):
    if isinstance(batch, tuple):
        return tuple(_tree_np(b) for b in batch)
    if isinstance(batch, dict):
        return {k: _np(v) for k, v in batch.items()}
    return _np(batch)


def _feed(side, ds, **kw):
    """to_jax on the JAX side, to_device(device="cpu") on the port's."""
    if side.name == "jax":
        return [_tree_np(b) for b in ds.to_jax(**kw)]
    return [_tree_np(b) for b in ds.to_device(device="cpu", **kw)]


def _assert_same(got, want, path="result"):
    """Equal structure, values and dtypes; numpy arrays compared exactly."""
    if isinstance(want, np.ndarray):
        assert isinstance(got, np.ndarray), path
        assert got.dtype == want.dtype, (path, got.dtype, want.dtype)
        np.testing.assert_array_equal(got, want, err_msg=path)
    elif isinstance(want, dict):
        assert isinstance(got, dict) and set(got) == set(want), path
        for k in want:
            _assert_same(got[k], want[k], f"{path}[{k!r}]")
    elif isinstance(want, (list, tuple)):
        assert type(got) is type(want) and len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _assert_same(g, w, f"{path}[{i}]")
    elif isinstance(want, float) and np.isnan(want):
        assert isinstance(got, float) and np.isnan(got), path
    else:
        assert got == want, (path, got, want)


# --------------------------------------------------------------------------
# The 25 scenarios of tests/test_data.py. Each runs on one side and
# returns what is compared with the other side's run.


def s_from_items_and_count(s):
    ds = s.data.from_items(list(range(100)))
    assert ds.count() == 100 and ds.num_blocks() >= 1
    assert ds.take(5) == [0, 1, 2, 3, 4]
    return [ds.count(), ds.num_blocks(), ds.take_all()]


def s_range_and_map(s):
    ds = s.data.range(50, parallelism=5).map(lambda x: x * 2)
    assert ds.count() == 50 and ds.take(3) == [0, 2, 4]
    assert ds.sum() == sum(x * 2 for x in range(50))
    return [ds.num_blocks(), ds.take_all(), ds.sum()]


def s_filter_flat_map(s):
    ds = s.data.range(20).filter(lambda x: x % 2 == 0)
    assert ds.take_all() == list(range(0, 20, 2))
    ds2 = s.data.from_items([1, 2]).flat_map(lambda x: [x, x * 10])
    assert sorted(ds2.take_all()) == [1, 2, 10, 20]
    return [ds.take_all(), ds2.take_all()]


def s_map_batches_numpy(s):
    ds = s.data.range_table(32, parallelism=4)
    out = ds.map_batches(lambda df: {"value": df["value"] * 3},
                         batch_format="numpy")
    assert out.sum("value") == 3 * sum(range(32))
    return out.take_all()


def s_repartition(s):
    ds = s.data.range(100, parallelism=10)
    ds2 = ds.repartition(3)
    assert ds2.num_blocks() == 3 and ds2.count() == 100
    ds3 = ds.repartition(5, shuffle=True)
    assert ds3.num_blocks() == 5
    assert sorted(ds3.take_all()) == list(range(100))
    return [[b.count() for b in ds2.split(3)], ds2.take_all(),
            ds3.take_all()]


def s_random_shuffle(s):
    ds = s.data.range(200, parallelism=8).random_shuffle(seed=7)
    vals = ds.take_all()
    assert sorted(vals) == list(range(200)) and vals != list(range(200))
    return vals


def s_sort_simple_and_key(s):
    ds = s.data.from_items([5, 3, 9, 1, 7, 2, 8], parallelism=3).sort()
    assert ds.take_all() == [1, 2, 3, 5, 7, 8, 9]
    ds2 = s.data.from_items(
        [{"a": i % 5, "b": i} for i in range(40)], parallelism=4
    ).sort(key="a", descending=True)
    a_vals = [r["a"] for r in ds2.take_all()]
    assert a_vals == sorted(a_vals, reverse=True)
    return [ds.take_all(), ds2.take_all()]


def s_groupby_aggregates(s):
    ds = s.data.from_items(
        [{"k": i % 3, "v": i} for i in range(30)], parallelism=4)
    out = ds.groupby("k").sum("v").take_all()
    expect = {k: sum(i for i in range(30) if i % 3 == k) for k in range(3)}
    assert {r["k"]: r["sum(v)"] for r in out} == expect
    means = ds.groupby("k").mean("v").take_all()
    for r in means:
        assert r["mean(v)"] == pytest.approx(expect[r["k"]] / 10)
    return [out, means]


def s_global_aggregates(s):
    ds = s.data.from_items([{"x": float(i)} for i in range(10)])
    assert ds.mean("x") == pytest.approx(4.5)
    assert ds.min("x") == 0 and ds.max("x") == 9
    assert ds.std("x") == pytest.approx(np.std(np.arange(10), ddof=1))
    return [ds.mean("x"), ds.min("x"), ds.max("x"), ds.std("x"),
            ds.sum("x")]


def s_split_and_zip_union(s):
    ds = s.data.range(30, parallelism=6)
    shards = ds.split(3)
    assert sum(sh.count() for sh in shards) == 30
    eq = ds.split(3, equal=True)
    assert all(sh.count() == 10 for sh in eq)
    z = s.data.from_items([1, 2, 3]).zip(s.data.from_items(["a", "b", "c"]))
    assert z.take_all() == [(1, "a"), (2, "b"), (3, "c")]
    u = s.data.range(5).union(s.data.range(5))
    assert u.count() == 10
    return [[sh.take_all() for sh in shards], [sh.take_all() for sh in eq],
            z.take_all(), u.take_all()]


def s_limit_take_schema(s):
    ds = s.data.range_table(100, parallelism=4)
    assert ds.limit(17).count() == 17
    assert "value" in str(ds.schema())
    return [ds.limit(17).take_all(), str(ds.schema())]


def s_iter_batches(s):
    ds = s.data.range(25, parallelism=3)
    batches = list(ds.iter_batches(batch_size=10))
    sizes = [len(b) for b in batches]
    assert sum(sizes) == 25 and sizes[:-1] == [10, 10]
    dropped = list(ds.iter_batches(batch_size=10, drop_last=True))
    assert sum(len(b) for b in dropped) == 20
    return [batches, dropped, list(ds.iter_batches())]


def s_to_jax(s):
    """tests/test_data.py::test_to_jax; the port's side is to_device."""
    ds = s.data.from_items(
        [{"x": float(i), "y": float(i % 2)} for i in range(16)])
    batches = _feed(s, ds, batch_size=8, label_column="y",
                    device_put=False)
    assert len(batches) == 2
    feats, labels = batches[0]
    assert feats["x"].shape == (8,) and labels.shape == (8,)
    return batches


def s_pipeline_window_repeat(s):
    ds = s.data.range(40, parallelism=8)
    pipe = ds.window(blocks_per_window=2).map(lambda x: x + 1)
    assert pipe.count() == 40
    assert sorted(pipe.iter_rows())[:3] == [1, 2, 3]
    rep = ds.repeat(2)
    assert rep.count() == 80
    shards = ds.window(blocks_per_window=4).split(2)
    assert sum(sh.count() for sh in shards) == 40
    return [list(pipe.iter_rows()), list(rep.iter_rows()),
            [list(sh.iter_rows()) for sh in shards], repr(pipe)]


def s_read_write_roundtrip(s):
    ds = s.data.from_items([{"a": i, "b": i * 2} for i in range(20)],
                           parallelism=2)
    out = []
    for fmt, read in (("parquet", s.data.read_parquet),
                      ("csv", s.data.read_csv),
                      ("json", s.data.read_json)):
        path = str(s.tmp / fmt)
        getattr(ds, f"write_{fmt}")(path)
        back = read(path)
        assert back.count() == 20
        assert back.sum("a") == sum(range(20))
        assert back.sum("b") == 2 * sum(range(20))
        out.append([sorted(os.listdir(path)), back.take_all()])
    return out


def s_read_text_binary(s):
    p = s.tmp / "f.txt"
    p.write_text("hello\nworld\n")
    ds = s.data.read_text(str(p))
    assert ds.take_all() == ["hello", "world"]
    binary = s.data.read_binary_files(str(p))
    assert binary.count() == 1
    return [ds.take_all(), binary.take_all()]


def s_from_numpy_pandas_arrow(s):
    import pandas as pd
    import pyarrow as pa

    ds = s.data.from_numpy(np.arange(12))
    assert ds.count() == 12
    df = pd.DataFrame({"c": [1, 2, 3]})
    assert s.data.from_pandas(df).sum("c") == 6
    t = pa.table({"z": [5, 6]})
    assert s.data.from_arrow(t).count() == 2
    return [ds.take_all(), s.data.from_pandas(df).take_all(),
            s.data.from_arrow(t).take_all()]


def s_actor_pool_compute(s):
    ds = s.data.range(20, parallelism=4).map(
        lambda x: x + 1, compute=s.data.ActorPoolStrategy(1, 2))
    assert sorted(ds.take_all()) == list(range(1, 21))
    return ds.take_all()


def s_stats_and_repr(s):
    ds = s.data.range(10).map(lambda x: x)
    assert "map" in ds.stats()
    assert "Dataset" in repr(ds)
    return [[line.split(":")[0] + line.split(",")[1]
             for line in ds.stats().splitlines()], repr(ds)]


def s_column_ops(s):
    ds = s.data.from_items([{"a": i, "b": i * 10} for i in range(6)])
    with_c = ds.add_column("c", lambda df: df["a"] + df["b"])
    rows = with_c.take(6)
    assert rows[2] == {"a": 2, "b": 20, "c": 22}
    only_ab = with_c.drop_columns(["c"])
    assert only_ab.take(1) == [{"a": 0, "b": 0}]
    just_b = with_c.select_columns(["b"])
    assert just_b.take(2) == [{"b": 0}, {"b": 10}]
    return [rows, only_ab.take_all(), just_b.take_all()]


def s_column_ops_survive_empty_blocks(s):
    ds = s.data.from_items([{"a": i, "b": i} for i in range(4)],
                           parallelism=2)
    emptied = ds.filter(lambda r: r["a"] >= 2)  # first block empties
    assert emptied.drop_columns(["b"]).take(4) == [{"a": 2}, {"a": 3}]
    assert emptied.select_columns(["b"]).take(4) == [{"b": 2}, {"b": 3}]
    with_c = emptied.add_column("c", lambda df: df["a"] + 1)
    assert with_c.take(4) == [{"a": 2, "b": 2, "c": 3},
                              {"a": 3, "b": 3, "c": 4}]
    return [emptied.drop_columns(["b"]).take_all(),
            emptied.select_columns(["b"]).take_all(), with_c.take_all()]


def s_split_locality_hints_follow_block_nodes(s):
    """Node ids are random, so the two sides agree on the balance, the
    locality property and the rows, not on which node is which."""
    pkg, cluster = s.pkg, s.rt
    cluster.add_node(num_cpus=2)
    cluster.add_node(num_cpus=2)
    strategies = pkg.util.scheduling_strategies
    node_ids = [n["NodeID"] for n in pkg.nodes()]

    @pkg.remote(num_cpus=1)
    class Consumer:
        def node(self):
            return pkg.get_runtime_context().get_node_id()

    c1 = Consumer.options(
        scheduling_strategy=strategies.NodeAffinitySchedulingStrategy(
            node_ids[0], soft=False)).remote()
    c2 = Consumer.options(
        scheduling_strategy=strategies.NodeAffinitySchedulingStrategy(
            node_ids[1], soft=False)).remote()
    pkg.get([c1.node.remote(), c2.node.remote()])
    ds = s.data.range(64, parallelism=8).map(lambda x: x + 1)
    metas = ds._ensure_metadata()
    assert any(m.node_id for m in metas)
    splits = ds.split(2, locality_hints=[c1, c2])
    assert len(splits) == 2
    assert all(len(sp._blocks) <= 4 for sp in splits)
    assert sum(len(sp._blocks) for sp in splits) == 8
    actor_node_of = importlib.import_module(
        f"{pkg.__name__}.gcs.state").actor_node_of
    hint_nodes = [actor_node_of(c) for c in (c1, c2)]
    assert all(hint_nodes), hint_nodes
    local = []
    for split, hnode in zip(splits, hint_nodes):
        here = [m for m in split._ensure_metadata() if m.node_id == hnode]
        total = [m for m in metas if m.node_id == hnode]
        assert len(here) == min(len(total), 4), (hnode, len(here),
                                                 len(total))
        local.append(len(here) == min(len(total), 4))
    return [[len(sp._blocks) for sp in splits], local,
            sorted(r for sp in splits for r in sp.take_all())]


def s_to_tf(s):
    tf = pytest.importorskip("tensorflow")

    ds = s.data.from_items(
        [{"x": float(i), "y": float(i % 2)} for i in range(16)])
    tfds = ds.to_tf(batch_size=8, label_column="y")
    batches = list(tfds)
    assert len(batches) == 2
    feats, labels = batches[0]
    assert feats["x"].shape == (8,) and labels.shape == (8,)
    total = sum(float(tf.reduce_sum(b[0]["x"])) for b in batches)
    assert total == sum(range(16))
    return [({k: v.numpy() for k, v in f.items()}, lab.numpy())
            for f, lab in batches]


def s_shuffle_larger_than_object_store(s):
    """test_data.py's scenario at 128 KiB a row, not 1 MiB: row
    iteration turns each payload into a Python list (``as_py``) in both
    packages, ~95 s a side at 1 MiB. Neither side spills at either size:
    ``init(object_store_memory=...)`` sizes the node's resource, while
    the in-process store's capacity is ``Config.object_store_memory``
    (2 GiB)."""
    n_rows = 48
    ds = s.data.from_items(
        [{"i": i, "payload": np.full(PAYLOAD, i % 251, dtype=np.uint8)}
         for i in range(n_rows)], parallelism=12)
    shuffled = ds.random_shuffle(seed=3)
    seen = []
    for row in shuffled.iter_rows():
        assert row["payload"][0] == row["i"] % 251
        seen.append(row["i"])
    assert sorted(seen) == list(range(n_rows)) and seen != list(range(n_rows))
    return seen


def s_to_tf_short_dataset_drop_last(s):
    pytest.importorskip("tensorflow")

    ds = s.data.from_items([{"x": 1.0}] * 4)
    return list(ds.to_tf(batch_size=8, drop_last=True))


SCENARIOS = {
    "from_items_and_count": ("init", s_from_items_and_count),
    "range_and_map": ("init", s_range_and_map),
    "filter_flat_map": ("init", s_filter_flat_map),
    "map_batches_numpy": ("init", s_map_batches_numpy),
    "repartition": ("init", s_repartition),
    "random_shuffle": ("init", s_random_shuffle),
    "sort_simple_and_key": ("init", s_sort_simple_and_key),
    "groupby_aggregates": ("init", s_groupby_aggregates),
    "global_aggregates": ("init", s_global_aggregates),
    "split_and_zip_union": ("init", s_split_and_zip_union),
    "limit_take_schema": ("init", s_limit_take_schema),
    "iter_batches": ("init", s_iter_batches),
    "to_jax": ("init", s_to_jax),
    "pipeline_window_repeat": ("init", s_pipeline_window_repeat),
    "read_write_roundtrip": ("init", s_read_write_roundtrip),
    "read_text_binary": ("init", s_read_text_binary),
    "from_numpy_pandas_arrow": ("init", s_from_numpy_pandas_arrow),
    "actor_pool_compute": ("init", s_actor_pool_compute),
    "stats_and_repr": ("init", s_stats_and_repr),
    "column_ops": ("init", s_column_ops),
    "column_ops_survive_empty_blocks": (
        "init", s_column_ops_survive_empty_blocks),
    "split_locality_hints_follow_block_nodes": (
        "cluster", s_split_locality_hints_follow_block_nodes),
    "to_tf": ("init", s_to_tf),
    "shuffle_larger_than_object_store": (
        "small_store", s_shuffle_larger_than_object_store),
    "to_tf_short_dataset_drop_last": (
        "init", s_to_tf_short_dataset_drop_last),
}


def _run_both(fn, tmp_path, kind="init"):
    """fn on the JAX package, then on the port -> (jax result, port's)."""
    out = []
    for name, pkg, data in (("jax", ray_tpu, jdata),
                            ("port", ray_tpu_torch, tdata)):
        tmp = tmp_path / name
        tmp.mkdir()
        with _runtime(name, kind) as rt:
            out.append(fn(Side(name, pkg, data, tmp, rt)))
    return out


def test_every_test_data_scenario_is_here():
    tree = ast.parse(open(os.path.join(os.path.dirname(__file__),
                                       "test_data.py")).read())
    names = {n.name[len("test_"):] for n in tree.body
             if isinstance(n, ast.FunctionDef) and n.name.startswith("test_")}
    assert names == set(SCENARIOS)


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_scenario_matches_jax(name, tmp_path):
    kind, fn = SCENARIOS[name]
    want, got = _run_both(fn, tmp_path, kind)
    _assert_same(got, want)


# --------------------------------------------------------------------------
# Shuffle, split, sort, groupby and aggregates on more inputs


@pytest.mark.parametrize("seed,parallelism,num_blocks",
                         [(0, 4, None), (7, 8, 3), (123, 3, 6), (None, 1, 1)])
def test_random_shuffle_order_matches(seed, parallelism, num_blocks,
                                      tmp_path):
    def run(s):
        ds = s.data.from_items([{"i": i, "w": i * 0.5} for i in range(97)],
                               parallelism=parallelism)
        out = ds.random_shuffle(seed=seed, num_blocks=num_blocks)
        rows = out.take_all()
        assert sorted(r["i"] for r in rows) == list(range(97))
        return [out.num_blocks(), rows if seed is not None
                else sorted(rows, key=lambda r: r["i"])]

    want, got = _run_both(run, tmp_path)
    _assert_same(got, want)


@pytest.mark.parametrize("n", [1, 2, 3, 5])
@pytest.mark.parametrize("equal", [False, True])
def test_split_rows_per_shard_match(n, equal, tmp_path):
    def run(s):
        ds = s.data.range(47, parallelism=7).map(lambda x: x * 3)
        return [sh.take_all() for sh in ds.split(n, equal=equal)]

    want, got = _run_both(run, tmp_path)
    _assert_same(got, want)


@pytest.mark.parametrize("key", ["k", "callable", None])
def test_groupby_and_sort_match(key, tmp_path):
    items = [{"k": int(k), "v": float(v)} for k, v in zip(
        np.random.default_rng(5).integers(0, 7, 60),
        np.random.default_rng(6).standard_normal(60))]

    def run(s):
        d = s.data
        ds = d.from_items(items, parallelism=5)
        gkey = {"k": "k", "callable": (lambda r: r["k"] % 3),
                None: None}[key]
        grouped = ds.groupby(gkey)
        aggs = grouped.aggregate(d.Count(), d.Sum("v"), d.Min("v"),
                                 d.Max("v"), d.Mean("v"), d.Std("v"))
        groups = grouped.map_groups(lambda rows: len(rows)).take_all()
        skey = "k" if key == "k" else (lambda r: (r["k"], r["v"]))
        return [aggs.take_all(), groups,
                ds.sort(skey).take_all(),
                ds.sort(skey, descending=True).take_all(),
                [ds.sum("v"), ds.min("v"), ds.max("v"), ds.mean("v"),
                 ds.std("v"), ds.std("v", ddof=0)]]

    want, got = _run_both(run, tmp_path)
    _assert_same(got, want)


# --------------------------------------------------------------------------
# Files written by one package, read by the other


@pytest.mark.parametrize("fmt", ["parquet", "csv", "json"])
@pytest.mark.parametrize("writer", ["jax", "port"])
def test_files_cross_read(both, fmt, writer, tmp_path):
    rows = [{"a": i, "b": i * 0.25, "c": f"s{i}"} for i in range(30)]
    w, r = (jdata, tdata) if writer == "jax" else (tdata, jdata)
    getattr(w.from_items(rows, parallelism=3), f"write_{fmt}")(
        str(tmp_path))
    read = getattr(r, f"read_{fmt}")(str(tmp_path))
    back = getattr(w, f"read_{fmt}")(str(tmp_path))
    assert read.take_all() == back.take_all() == rows


def test_numpy_file_read_alike(both, tmp_path):
    arr = np.random.default_rng(2).integers(-5, 5, size=(6, 3))
    np.save(tmp_path / "a.npy", arr)
    np.save(tmp_path / "b.npy", arr * 2)
    want = jdata.read_numpy(str(tmp_path)).take_all()
    got = tdata.read_numpy(str(tmp_path)).take_all()
    assert got == want and len(got) == 12


# --------------------------------------------------------------------------
# to_device against to_jax

DTYPES = ["int64", "int32", "float64", "float32", "bool"]


def _typed_frames():
    """Two frames (two blocks) of 13 rows, one column per dtype; int64
    holds values past int32's range, which x64-off JAX wraps."""
    import pandas as pd

    rng = np.random.default_rng(11)
    frames = []
    for _ in range(2):
        frames.append(pd.DataFrame({
            "int64": rng.integers(-2**40, 2**40, 13),
            "int32": rng.integers(-2**31, 2**31 - 1, 13).astype(np.int32),
            "float64": rng.standard_normal(13) * 1e3,
            "float32": rng.standard_normal(13).astype(np.float32),
            "bool": rng.integers(0, 2, 13).astype(bool),
        }))
    return frames


@pytest.mark.parametrize("drop_last", [True, False])
@pytest.mark.parametrize("columns", [None, ["float64", "int32"]])
@pytest.mark.parametrize("label_column", [None] + DTYPES)
def test_to_device_matches_to_jax(both, label_column, columns, drop_last):
    frames = _typed_frames()
    assert [str(t) for t in frames[0].dtypes] == DTYPES
    kw = dict(batch_size=5, columns=columns, label_column=label_column,
              drop_last=drop_last)
    want = [_tree_np(b) for b in
            jdata.from_pandas(frames).to_jax(**kw)]
    got = [_tree_np(b) for b in
           tdata.from_pandas(frames).to_device(device="cpu", **kw)]
    assert len(want) == (5 if drop_last else 6)
    _assert_same(got, want)
    assert {str(v.dtype) for b in got
            for v in (list(b[0].values()) + [b[1]] if label_column
                      else b.values())} <= {"int32", "float32", "bool"}


@pytest.mark.parametrize("dtype", DTYPES)
def test_to_device_array_rows_match_to_jax(both, dtype):
    """Rows that are arrays (list blocks): one array a batch."""
    rng = np.random.default_rng(4)
    rows = [rng.integers(-2**34, 2**34, 7).astype(dtype) for _ in range(20)]
    want = [_tree_np(b) for b in
            jdata.from_items(rows, parallelism=3).to_jax(batch_size=6)]
    got = [_tree_np(b) for b in tdata.from_items(
        rows, parallelism=3).to_device(batch_size=6, device="cpu")]
    assert len(want) == 3 and want[0].shape == (6, 7)
    _assert_same(got, want)


def test_to_device_pipeline_matches_to_jax(both):
    rows = [np.arange(9) * i for i in range(16)]
    kw = dict(batch_size=8)
    want = [_tree_np(b) for b in jdata.from_items(rows, parallelism=4)
            .random_shuffle(seed=0).repeat(2).to_jax(**kw)]
    got = [_tree_np(b) for b in tdata.from_items(rows, parallelism=4)
           .random_shuffle(seed=0).repeat(2).to_device(device="cpu", **kw)]
    assert len(want) == 4
    _assert_same(got, want)


def test_to_device_put_false_yields_host_tensors(both):
    """device_put=False: host tensors of to_jax's dtypes, which equal
    to_jax(device_put=False)'s values; nothing is pinned."""
    frames = _typed_frames()
    want = [_tree_np(b) for b in jdata.from_pandas(frames).to_jax(
        batch_size=8, label_column="int64", device_put=False)]
    batches = list(tdata.from_pandas(frames).to_device(
        batch_size=8, label_column="int64", device_put=False,
        device="cpu"))
    for feats, labels in batches:
        for t in list(feats.values()) + [labels]:
            assert isinstance(t, torch.Tensor) and t.device.type == "cpu"
            assert not t.is_pinned()
        assert labels.dtype == torch.int32
    _assert_same([_tree_np(b) for b in batches], want)


@pytest.mark.parametrize("column", ["lists", "strings"])
def test_to_device_non_numeric_column_raises(both, column):
    rows = [{"x": float(i), "lists": [i, i + 1], "strings": f"r{i}"}
            for i in range(8)]
    with pytest.raises(TypeError):
        list(jdata.from_items(rows).to_jax(batch_size=4, columns=[column]))
    with pytest.raises(TypeError, match="not a valid array type"):
        list(tdata.from_items(rows).to_device(batch_size=4, device="cpu",
                                              columns=[column]))


# --------------------------------------------------------------------------
# The public surface, and util.ActorPool (the JAX package's
# tests/test_util.py TestActorPool scenarios on both packages)


def test_public_names_match():
    import ray_tpu.util as jutil
    import ray_tpu_torch.util as tutil

    assert set(tdata.__all__) == set(jdata.__all__)
    for name in jdata.__all__:
        assert getattr(tdata, name).__name__ == getattr(jdata, name).__name__
    assert tutil.ActorPool.__module__ == "ray_tpu_torch.util.actor_pool"
    public = {n for n in dir(jutil) if not n.startswith("_")
              and not isinstance(getattr(jutil, n), type(jutil))}
    assert public <= set(dir(tutil))


def _pool_scenarios(pkg):
    @pkg.remote
    class MathActor:
        def double(self, v):
            return 2 * v

    pool_cls = importlib.import_module(f"{pkg.__name__}.util").ActorPool
    double = lambda a, v: a.double.remote(v)  # noqa: E731
    out = {}
    pool = pool_cls([MathActor.remote() for _ in range(2)])
    for i in range(5):  # three wait for a free actor
        pool.submit(double, i)
    out["submit_get_next"] = [pool.get_next() for _ in range(5)]
    pool = pool_cls([MathActor.remote() for _ in range(3)])
    out["map"] = list(pool.map(double, range(6)))
    out["map_unordered"] = sorted(pool.map_unordered(double, range(6)))
    with pytest.raises(StopIteration):
        pool_cls([MathActor.remote()]).get_next()
    a = MathActor.remote()
    pool = pool_cls([a])
    out["pop_idle"] = [pool.pop_idle() is a, pool.pop_idle() is None]
    pool.push(a)
    out["push"] = pool.has_free()
    with pytest.raises(ValueError):
        pool.push(a)
    pool = pool_cls([MathActor.remote() for _ in range(2)])
    pool.submit(double, 1)
    pool.submit(double, 2)
    out["unordered"] = sorted(pool.get_next_unordered() for _ in range(2))
    out["drained"] = pool.has_next()
    return out


def test_actor_pool_matches_jax():
    ray_tpu.init(num_cpus=4)
    try:
        want = _pool_scenarios(ray_tpu)
    finally:
        ray_tpu.shutdown()
    ray_tpu_torch.init(num_cpus=4, device="cpu")
    try:
        got = _pool_scenarios(ray_tpu_torch)
    finally:
        ray_tpu_torch.shutdown()
    assert want["submit_get_next"] == [0, 2, 4, 6, 8]
    assert want["map"] == [0, 2, 4, 6, 8, 10] == want["map_unordered"]
    assert want["pop_idle"] == [True, True] and want["push"]
    assert want["unordered"] == [2, 4] and not want["drained"]
    assert got == want
