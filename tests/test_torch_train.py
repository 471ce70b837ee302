"""The port's ray_tpu_torch.train on the CPU (the twin of
tests/test_train.py): worker groups, report rounds, checkpoints,
callbacks and dataset shards through ``Trainer`` on the thread tier,
brought up with ``init(device="cpu")``; and a ``ModelConfig.debug()``
train step inside the train function, whose loss falls."""

import json

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


@pytest.mark.parametrize("backend", ["torch", "tensorflow"])
def test_process_tier_backends_raise(port_rt, backend):
    """gloo process groups and TF_CONFIG need one OS process per rank:
    the process tier, which is not ported yet."""
    with pytest.raises(NotImplementedError, match="process tier"):
        Trainer(backend=backend, num_workers=2)
    with pytest.raises(ValueError, match="Invalid backend"):
        Trainer(backend="jax", num_workers=1)
