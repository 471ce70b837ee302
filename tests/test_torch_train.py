"""The port's ray_tpu_torch.train on the CPU (the twin of
tests/test_train.py): worker groups, report rounds, checkpoints,
callbacks and dataset shards through ``Trainer`` on the thread tier,
brought up with ``init(device="cpu")``; a ``ModelConfig.debug()`` train
step inside the train function, whose loss falls; and the ``"torch"``
(gloo) and ``"tensorflow"`` backends on the process tier
(``init(device="cpu", worker_mode="process")``). The data ingest path:
``ray_tpu_torch.data`` Datasets and pipelines sharded by ``Trainer`` and
fed through ``to_device``, against the JAX package's ``Trainer`` and
``to_jax`` on the same data, also without pyarrow and pandas, and
``ModelConfig.debug()`` trained from a shuffled, repeated pipeline on
both packages. A Trainer shut down mid-run ends its train threads; and
``Trainer.to_tune_trainable`` runs ``ModelConfig.debug()`` trials under
ASHA with the JAX train step's losses, giving every placement group and
CPU back."""

import json
import time

import numpy as np
import pytest
import torch

import ray_tpu_torch
from ray_tpu_torch import train
from ray_tpu_torch.train import (
    CheckpointStrategy,
    JsonLoggerCallback,
    Trainer,
    WorkerGroup,
)


STEP_RTOL = 1e-4  # tests/test_torch_training.py's step tolerance


@pytest.fixture
def port_rt():
    rt = ray_tpu_torch.init(num_cpus=4, device="cpu")
    try:
        yield rt
    finally:
        ray_tpu_torch.shutdown()


class TestWorkerGroup:
    def test_execute(self, port_rt):
        wg = WorkerGroup(num_workers=2, num_cpus_per_worker=1)
        assert wg.execute(lambda: 7) == [7, 7]
        assert wg.execute_single(1, lambda x: x * 2, 21) == 42
        wg.shutdown()


class TestTrainer:
    def test_run_reports(self, port_rt):
        def train_func():
            for i in range(3):
                train.report(loss=1.0 / (i + 1), step=i)
            return train.world_rank()

        trainer = Trainer(num_workers=2)
        trainer.start()
        results = trainer.run(train_func)
        assert sorted(results) == [0, 1]
        trainer.shutdown()

    def test_config_and_world_size(self, port_rt):
        def train_func(config):
            return config["x"] * train.world_size()

        trainer = Trainer(backend="topology", num_workers=2)
        out = trainer.run(train_func, config={"x": 10})
        assert out == [20, 20]
        trainer.shutdown()

    def test_checkpointing(self, port_rt, tmp_path):
        def train_func():
            ckpt = train.load_checkpoint()
            start = ckpt["step"] + 1 if ckpt else 0
            for i in range(start, start + 2):
                train.save_checkpoint(step=i, loss=float(i))
            return start

        trainer = Trainer(num_workers=2, logdir=str(tmp_path))
        out = trainer.run(train_func)
        assert out == [0, 0]
        assert trainer.latest_checkpoint["step"] == 1
        assert trainer.latest_checkpoint_path is not None
        # resume from latest checkpoint
        out2 = trainer.run(train_func,
                           checkpoint=trainer.latest_checkpoint)
        assert out2 == [2, 2]
        trainer.shutdown()

    def test_checkpoint_strategy_keeps_best(self, port_rt, tmp_path):
        def train_func():
            for loss in [3.0, 1.0, 2.0]:
                train.save_checkpoint(loss=loss)

        trainer = Trainer(num_workers=1, logdir=str(tmp_path))
        trainer.run(train_func, checkpoint_strategy=CheckpointStrategy(
            num_to_keep=1, checkpoint_score_attribute="loss",
            checkpoint_score_order="min"))
        best = trainer.checkpoint_manager.load_checkpoint_from_path(
            trainer.best_checkpoint_path)
        assert best["loss"] == 1.0
        trainer.shutdown()

    def test_callbacks(self, port_rt, tmp_path):
        def train_func():
            train.report(m=1)
            train.report(m=2)

        cb = JsonLoggerCallback()
        trainer = Trainer(num_workers=2, logdir=str(tmp_path))
        trainer.run(train_func, callbacks=[cb])
        rows = json.loads(cb.log_path.read_text())
        assert len(rows) == 2          # two rounds
        assert len(rows[0]) == 2       # two workers each
        assert rows[1][0]["m"] == 2
        trainer.shutdown()

    def test_mismatched_reports_error(self, port_rt):
        def train_func():
            if train.world_rank() == 0:
                train.report(x=1)

        trainer = Trainer(num_workers=2)
        with pytest.raises(RuntimeError, match="Some workers"):
            trainer.run(train_func)
        trainer.shutdown()

    def test_debug_model_train_step_in_train_func(self, port_rt):
        """The port's counterpart of test_spmd_step_in_train_func: rank
        0 takes optimizer steps on ModelConfig.debug() inside the train
        function and reports a falling loss."""
        def train_func():
            from ray_tpu_torch.models import transformer as tfm
            from ray_tpu_torch.models.training import build_train_step

            if train.world_rank() != 0:
                for _ in range(3):
                    train.report(loss=0.0)
                return None
            cfg = tfm.ModelConfig.debug()
            step, init_fn = build_train_step(cfg, device="cpu")
            params, opt_state = init_fn(torch.Generator().manual_seed(0))
            tokens = np.random.default_rng(0).integers(
                0, cfg.vocab_size, size=(4, 33))
            losses = []
            for _ in range(3):
                params, opt_state, m = step(params, opt_state, tokens)
                losses.append(m["loss"].item())
                train.report(loss=losses[-1])
            return losses

        trainer = Trainer(num_workers=2)
        out = trainer.run(train_func)
        losses = out[0]
        assert all(np.isfinite(losses)) and losses[-1] < losses[0]
        trainer.shutdown()


class TestDatasetSharding:
    def test_split_list_like(self, port_rt):
        class FakeDataset:
            def __init__(self, items):
                self.items = items

            def split(self, n):
                return [FakeDataset(self.items[i::n]) for i in range(n)]

        def train_func():
            shard = train.get_dataset_shard()
            return sum(shard.items)

        trainer = Trainer(num_workers=2)
        out = trainer.run(train_func, dataset=FakeDataset(list(range(10))))
        assert sum(out) == sum(range(10))
        trainer.shutdown()


def _token_rows(n: int, width: int, vocab: int):
    rng = np.random.default_rng(0)
    return [rng.integers(0, vocab, size=width) for _ in range(n)]


def _shards_through_trainer(pkg, data, rows, pipeline: bool):
    """Each rank's rows and fed batches (numpy) from ``pkg``'s Trainer
    with two workers over a shuffled Dataset, or that Dataset repeated
    twice; the JAX side feeds through to_jax, the port's through
    to_device."""
    from importlib import import_module

    port = pkg is ray_tpu_torch
    ds = data.from_items(rows, parallelism=4).random_shuffle(seed=0)
    ds = ds.repeat(2) if pipeline else ds

    def train_func():
        shard = import_module(f"{pkg.__name__}.train").get_dataset_shard()
        feed = (shard.to_device(batch_size=3, device="cpu") if port
                else shard.to_jax(batch_size=3))
        return ([r.tolist() for r in shard.iter_rows()],
                [np.asarray(b.numpy() if port else b) for b in feed])

    trainer = (Trainer(num_workers=2) if port else import_module(
        "ray_tpu.train").Trainer(backend="jax", num_workers=2))
    try:
        return trainer.run(train_func, dataset=ds)
    finally:
        trainer.shutdown()


@pytest.mark.parametrize("pipeline", [False, True])
def test_trainer_data_shards_match_jax(pipeline):
    """Trainer(num_workers=2) on both packages over the same Dataset or
    DatasetPipeline: each rank gets the same rows, and its to_device
    batches equal its to_jax batches in value and dtype."""
    import ray_tpu
    from ray_tpu import data as jdata
    from ray_tpu_torch import data as tdata

    rows = _token_rows(14, 5, 1000)
    ray_tpu.init(num_cpus=4)
    try:
        want = _shards_through_trainer(ray_tpu, jdata, rows, pipeline)
    finally:
        ray_tpu.shutdown()
    ray_tpu_torch.init(num_cpus=4, device="cpu")
    try:
        got = _shards_through_trainer(ray_tpu_torch, tdata, rows, pipeline)
    finally:
        ray_tpu_torch.shutdown()
    assert len(got) == len(want) == 2
    for (g_rows, g_fed), (w_rows, w_fed) in zip(got, want):
        assert g_rows == w_rows and len(w_rows) == (14 if pipeline else 7)
        assert len(g_fed) == len(w_fed) == len(w_rows) // 3
        for g, w in zip(g_fed, w_fed):
            assert g.dtype == w.dtype == np.int32
            np.testing.assert_array_equal(g, w)


def test_array_rows_feed_without_pyarrow(port_rt, monkeypatch):
    """The card machine has neither pyarrow nor pandas. With the port's
    block module seeing neither, rows that are arrays still go through
    shuffle, repeat, the Trainer's shard and to_device, batch for batch
    as the JAX package (with pyarrow) feeds them; dict rows become list
    blocks, whose object batches no feed converts."""
    import ray_tpu
    from ray_tpu import data as jdata
    from ray_tpu_torch import data as tdata
    from ray_tpu_torch.data import block

    rows = _token_rows(16, 9, 32000)
    ray_tpu.init(num_cpus=4)
    try:
        want = [np.asarray(b) for b in jdata.from_items(rows, parallelism=4)
                .random_shuffle(seed=0).repeat(2).to_jax(batch_size=8)]
    finally:
        ray_tpu.shutdown()

    monkeypatch.setattr(block, "pa", None)
    monkeypatch.setattr(block, "pd", None)
    pipe = tdata.from_items(rows, parallelism=4).random_shuffle(
        seed=0).repeat(2)

    def train_func():
        return [(b.dtype, b.device.type, b.numpy()) for b in
                train.get_dataset_shard().to_device(batch_size=8,
                                                    device="cpu")]

    trainer = Trainer(num_workers=1)
    [fed] = trainer.run(train_func, dataset=pipe)
    trainer.shutdown()
    assert len(fed) == len(want) == 4
    for (dtype, dev, got), w in zip(fed, want):
        assert dtype == torch.int32 and dev == "cpu"
        np.testing.assert_array_equal(got, w)
    dict_rows = tdata.from_items([{"x": 1.0}] * 4)
    assert isinstance(ray_tpu_torch.get(
        dict_rows.get_internal_block_refs()[0]), list)
    with pytest.raises(TypeError, match="not a valid array type"):
        next(dict_rows.to_device(batch_size=2, device="cpu"))


def test_to_device_without_device_raises():
    """to_device's device is None: CUDA, as every entry point's; on a
    host without CUDA it raises on the call, before any batch."""
    from ray_tpu_torch import data as tdata

    if torch.cuda.is_available():
        pytest.skip("this host has CUDA: the default device resolves")
    ray_tpu_torch.init(num_cpus=2, device="cpu")
    try:
        ds = tdata.range(8)
        for source in (ds, ds.repeat(2)):
            with pytest.raises(RuntimeError, match="no CUDA device"):
                source.to_device(batch_size=2)
    finally:
        ray_tpu_torch.shutdown()


def test_debug_model_trained_from_pipeline_matches_jax():
    """The slice on the CPU: ModelConfig.debug() trained through each
    package's Trainer from a shuffled, repeated pipeline of token rows,
    fed by to_jax on the JAX side and to_device on the port's, from the
    same initial weights: loss and grad norm per step within 1e-4
    relative (tests/test_torch_training.py's step tolerance)."""
    import jax

    import ray_tpu
    from ray_tpu import data as jdata
    from ray_tpu import train as jtrain
    from ray_tpu.models import transformer as jtfm
    from ray_tpu.models.training import build_train_step as j_build
    from ray_tpu.parallel.mesh import MeshSpec, build_mesh
    from ray_tpu_torch import data as tdata
    from ray_tpu_torch.models import transformer as ttfm
    from ray_tpu_torch.models.convert import params_from_jax
    from ray_tpu_torch.models.training import build_train_step, make_optimizer

    jcfg, tcfg = jtfm.ModelConfig.debug(), ttfm.ModelConfig.debug()
    rows = _token_rows(8, 33, tcfg.vocab_size)
    mesh = build_mesh(MeshSpec(dp=1, pp=1, sp=1, tp=1))
    j_step, j_init = j_build(jcfg, mesh)
    j_params0, _ = j_init(jax.random.PRNGKey(0))
    np_params = jax.tree.map(np.asarray, j_params0)

    def j_train():
        params, state = j_init(jax.random.PRNGKey(0))
        out = []
        for batch in jtrain.get_dataset_shard().to_jax(batch_size=4):
            params, state, m = j_step(params, state, batch)
            out.append((float(m["loss"]), float(m["grad_norm"])))
        return out

    def t_train():
        step, _ = build_train_step(tcfg, device="cpu")
        params = params_from_jax(np_params, tcfg, device="cpu")
        state = make_optimizer().init(params)
        out = []
        for batch in train.get_dataset_shard().to_device(batch_size=4,
                                                         device="cpu"):
            assert batch.dtype == torch.int32
            params, state, m = step(params, state, batch)
            out.append((m["loss"].item(), m["grad_norm"].item()))
        return out

    ray_tpu.init(num_cpus=4)
    try:
        pipe = jdata.from_items(rows, parallelism=4).random_shuffle(
            seed=0).repeat(2)
        trainer = jtrain.Trainer(backend="jax", num_workers=1)
        [want] = trainer.run(j_train, dataset=pipe)
        trainer.shutdown()
    finally:
        ray_tpu.shutdown()
    ray_tpu_torch.init(num_cpus=4, device="cpu")
    try:
        pipe = tdata.from_items(rows, parallelism=4).random_shuffle(
            seed=0).repeat(2)
        trainer = Trainer(num_workers=1)
        [got] = trainer.run(t_train, dataset=pipe)
        trainer.shutdown()
    finally:
        ray_tpu_torch.shutdown()
    assert len(got) == len(want) == 4
    np.testing.assert_allclose(np.array(got), np.array(want), rtol=1e-4)
    assert got[-1][0] < got[0][0]


def _wait_for(cond, timeout: float = 10.0) -> bool:
    deadline = time.monotonic() + timeout
    while not cond() and time.monotonic() < deadline:
        time.sleep(0.02)
    return cond()


def test_shutdown_mid_run_ends_the_train_threads(port_rt):
    """A Trainer shut down while its train functions still have reports
    to make ends them: their finally blocks run and their threads end
    before shutdown returns, and the workers' CPUs come back."""
    import itertools
    import threading

    ended = []

    def train_func():
        try:
            for i in range(100):
                train.report(step=i)
        finally:
            ended.append(threading.current_thread().name)

    trainer = Trainer(num_workers=2)
    rounds = itertools.islice(trainer.run_iterator(train_func), 3)
    assert [r[0]["step"] for r in rounds] == [0, 1, 2]
    trainer.shutdown()
    assert sorted(ended) == ["train-rank-0", "train-rank-1"]
    assert not [t.name for t in threading.enumerate()
                if t.name.startswith("train-rank-")]
    assert _wait_for(
        lambda: ray_tpu_torch.available_resources().get("CPU") == 4.0)


def test_to_tune_trainable_debug_model_matches_jax():
    """Trainer.to_tune_trainable on ModelConfig.debug(): three trials
    through the port's Trainer under ASHA (grace 2, two at a time), each
    from the JAX package's initial weights (params_from_jax). Each
    trial's losses equal the JAX build_train_step's at its learning rate
    within STEP_RTOL (1e-4, tests/test_torch_training.py's); the trial at
    learning rate 0, whose loss stays at the first, is stopped at rung 2;
    afterwards every placement group is removed and every CPU is free."""
    import jax

    from ray_tpu.models import transformer as jtfm
    from ray_tpu.models.training import build_train_step as j_build
    from ray_tpu.models.training import make_optimizer as j_make_optimizer
    from ray_tpu.parallel.mesh import MeshSpec, build_mesh
    from ray_tpu_torch import tune
    from ray_tpu_torch.models import transformer as ttfm
    from ray_tpu_torch.models.convert import params_from_jax
    from ray_tpu_torch.models.training import build_train_step, make_optimizer
    from ray_tpu_torch.util.placement_group import placement_group_table

    steps, lrs = 4, [1e-3, 3e-3, 0.0]
    jcfg, tcfg = jtfm.ModelConfig.debug(), ttfm.ModelConfig.debug()
    tokens = np.random.default_rng(0).integers(0, tcfg.vocab_size,
                                               size=(2, 33))
    mesh = build_mesh(MeshSpec(dp=1, pp=1, sp=1, tp=1))
    want, np_params = {}, None
    for lr in lrs:
        j_step, j_init = j_build(jcfg, mesh,
                                 optimizer=j_make_optimizer(learning_rate=lr))
        params, state = j_init(jax.random.PRNGKey(0))
        if np_params is None:
            np_params = jax.tree.map(np.asarray, params)
        want[lr] = []
        for _ in range(steps):
            params, state, m = j_step(params, state, tokens)
            want[lr].append(float(m["loss"]))

    def train_debug(config):
        opt = make_optimizer(learning_rate=config["lr"])
        step, _ = build_train_step(tcfg, device="cpu", optimizer=opt)
        params = params_from_jax(np_params, tcfg, device="cpu")
        state = opt.init(params)
        for _ in range(steps):
            params, state, m = step(params, state, tokens)
            train.report(loss=m["loss"].item())

    ray_tpu_torch.init(num_cpus=4, device="cpu")
    try:
        trainable = Trainer(num_workers=1).to_tune_trainable(train_debug)
        analysis = tune.run(
            trainable, config={"lr": tune.grid_search(lrs)},
            metric="loss", mode="min", max_concurrent_trials=2,
            scheduler=tune.AsyncHyperBandScheduler(
                max_t=steps, grace_period=2, reduction_factor=2))
        states = {pg["state"] for pg in placement_group_table().values()}
        cpus_back = _wait_for(
            lambda: ray_tpu_torch.available_resources().get("CPU") == 4.0)
    finally:
        ray_tpu_torch.shutdown()
    got = {t.config["lr"]: [r["loss"] for r in t.results]
           for t in analysis.trials}
    assert all(t.status == "TERMINATED" for t in analysis.trials)
    assert len(got[0.0]) == 2 and max(len(v) for v in got.values()) == steps
    for lr, losses in got.items():
        np.testing.assert_allclose(losses, want[lr][:len(losses)],
                                   rtol=STEP_RTOL)
    assert analysis.get_best_config()["lr"] in (1e-3, 3e-3)
    assert states == {"REMOVED"} and cpus_back


# The three backend tests of tests/test_train.py, on the port's process
# tier: the same train functions and expected results.


@pytest.fixture
def process_rt():
    rt = ray_tpu_torch.init(num_cpus=4, worker_mode="process",
                            num_process_workers=2, device="cpu")
    try:
        yield rt
    finally:
        ray_tpu_torch.shutdown()


def test_torch_backend_real_process_group(process_rt):
    """backend='torch' (reference train/torch.py setup_torch_process_group):
    each process-backed worker joins a gloo group; the train function
    does a REAL torch.distributed allreduce across worker processes."""
    def train_func():
        import torch
        import torch.distributed as dist

        rank = train.world_rank()
        t = torch.tensor([float(rank + 1)])
        dist.all_reduce(t)  # 1 + 2 = 3 across 2 ranks
        return float(t[0])

    trainer = Trainer(backend="torch", num_workers=2)
    results = trainer.run(train_func)
    trainer.shutdown()
    assert results == [3.0, 3.0]


@pytest.mark.parametrize("backend", ["torch", "tensorflow"])
def test_torch_backend_rejects_thread_workers(port_rt, backend):
    """gloo process groups and TF_CONFIG need one OS process per rank: on
    the thread tier, whose workers share one process, these backends
    refuse to start and name the process tier; an unknown name raises."""
    from ray_tpu_torch.train.backend import TrainBackendError

    trainer = Trainer(backend=backend, num_workers=2)
    with pytest.raises(TrainBackendError, match="worker_mode='process'"):
        trainer.run(lambda: 0)
    trainer.shutdown()
    with pytest.raises(ValueError, match="Invalid backend"):
        Trainer(backend="jax", num_workers=1)


def test_tensorflow_backend_sets_tf_config(process_rt):
    """backend='tensorflow' (reference train/tensorflow.py): every process
    worker gets a TF_CONFIG naming the full worker cluster and its own
    index, the MultiWorkerMirroredStrategy contract."""
    def train_func():
        import json
        import os

        cfg = json.loads(os.environ["TF_CONFIG"])
        return (cfg["task"]["index"], len(cfg["cluster"]["worker"]),
                train.world_size())

    trainer = Trainer(backend="tensorflow", num_workers=2)
    results = trainer.run(train_func)
    trainer.shutdown()
    assert sorted(r[0] for r in results) == [0, 1]
    assert all(r[1] == 2 and r[2] == 2 for r in results)
