"""Trainer — the user-facing entry of ray_tpu_torch.train.

Mirrors the reference's ray.train Trainer (python/ray/train/trainer.py:94;
run:264, run_iterator:343): wraps a BackendExecutor, drives the result
loop through callbacks, persists checkpoints, and exposes an iterator
form. The default backend ``"topology"`` records each worker's rank and
world size; ``"torch"`` (a gloo process group) and ``"tensorflow"``
(TF_CONFIG) need one OS process per rank, the process tier
(``init(worker_mode="process")``), and refuse thread workers.
``to_tune_trainable`` wraps a train function into a ray_tpu_torch.tune
function trainable that runs its own Trainer per trial.
"""

from __future__ import annotations

import logging
import tempfile
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional, Union

from ray_tpu_torch.train.backend import (
    BackendConfig,
    BackendExecutor,
    TensorflowConfig,
    TopologyConfig,
    TorchConfig,
    TrainingWorkerError,
)
from ray_tpu_torch.train.callbacks import TrainingCallback
from ray_tpu_torch.train.checkpoint import (
    CheckpointManager,
    CheckpointStrategy,
)
from ray_tpu_torch.train.session import TrainingResultType

logger = logging.getLogger(__name__)

BACKEND_NAME_TO_CONFIG_CLS = {
    "topology": TopologyConfig,
    "torch": TorchConfig,
    "tensorflow": TensorflowConfig,
}


def _construct_backend_config(
        backend: Union[str, BackendConfig]) -> BackendConfig:
    if isinstance(backend, BackendConfig):
        return backend
    if isinstance(backend, str):
        cls = BACKEND_NAME_TO_CONFIG_CLS.get(backend)
        if cls is None:
            raise ValueError(
                f"Invalid backend {backend!r}; registered: "
                f"{sorted(BACKEND_NAME_TO_CONFIG_CLS)}")
        return cls()
    raise TypeError("backend must be a string or BackendConfig")


class Trainer:
    def __init__(self,
                 backend: Union[str, BackendConfig] = "topology",
                 num_workers: int = 1,
                 use_gpu: bool = False,
                 resources_per_worker: Optional[Dict[str, float]] = None,
                 logdir: Optional[str] = None,
                 max_retries: int = 3,
                 elastic_min_workers: Optional[int] = None):
        """elastic_min_workers < num_workers turns on elastic training:
        after a node loss the run continues on any group size down to
        the minimum, and grows back toward num_workers when capacity
        returns (always resuming from the latest checkpoint)."""
        import ray_tpu_torch

        if not ray_tpu_torch.is_initialized():
            ray_tpu_torch.init()
        if num_workers <= 0:
            raise ValueError("num_workers must be positive")
        resources = dict(resources_per_worker or {})
        num_cpus = resources.pop("CPU", 1)
        num_gpus = resources.pop("GPU", int(use_gpu))
        self._backend_config = _construct_backend_config(backend)
        self._executor = BackendExecutor(
            backend_config=self._backend_config,
            num_workers=num_workers,
            num_cpus_per_worker=num_cpus,
            num_gpus_per_worker=num_gpus,
            additional_resources_per_worker=resources or None,
            max_retries=max_retries,
            min_workers=elastic_min_workers)
        self._logdir = Path(logdir) if logdir else Path(
            tempfile.mkdtemp(prefix="ray_tpu_train_"))
        self._logdir.mkdir(parents=True, exist_ok=True)
        self.checkpoint_manager = CheckpointManager(run_dir=self._logdir)
        self._started = False

    # ------------------------------------------------------------ lifecycle
    @property
    def logdir(self) -> Path:
        return self._logdir

    @property
    def latest_checkpoint(self) -> Optional[Dict]:
        return self.checkpoint_manager.latest_checkpoint

    @property
    def latest_checkpoint_path(self) -> Optional[Path]:
        return self.checkpoint_manager.latest_checkpoint_path

    @property
    def best_checkpoint_path(self) -> Optional[Path]:
        return self.checkpoint_manager.best_checkpoint_path

    def start(self, initialization_hook: Optional[Callable] = None) -> None:
        try:
            self._executor.start(initialization_hook)
        except BaseException:
            # a failed backend on_start must not leak the already-created worker
            # group + placement group — their CPUs would stay reserved
            # for the rest of the session
            try:
                self._executor.shutdown()
            except Exception:
                pass
            raise
        self._started = True

    # -------------------------------------------------------------- running
    def run(self,
            train_func: Union[Callable[[], Any], Callable[[Dict], Any]],
            config: Optional[Dict] = None,
            callbacks: Optional[List[TrainingCallback]] = None,
            dataset: Any = None,
            checkpoint: Optional[Union[Dict, str, Path]] = None,
            checkpoint_strategy: Optional[CheckpointStrategy] = None
            ) -> List[Any]:
        if not self._started:
            self.start()
        callbacks = callbacks or []
        train_func = self._wrap_function(train_func, config)
        checkpoint = self._load_checkpoint_arg(checkpoint)
        self._executor.reset_checkpoint()
        self.checkpoint_manager.on_start_training(
            checkpoint_strategy=checkpoint_strategy)
        for cb in callbacks:
            cb.start_training(logdir=str(self._logdir), config=config)
        error = False
        try:
            iterator = TrainingIterator(
                self._executor, train_func, checkpoint,
                self.checkpoint_manager, shard_fn=self._shard_fn(dataset))
            for round_results in iterator:
                for cb in callbacks:
                    cb.handle_result(round_results)
            return iterator.latest_run_results
        except BaseException:
            error = True
            raise
        finally:
            for cb in callbacks:
                cb.finish_training(error=error)

    def run_iterator(self, train_func, config=None, dataset=None,
                     checkpoint=None, checkpoint_strategy=None
                     ) -> "TrainingIterator":
        if not self._started:
            self.start()
        train_func = self._wrap_function(train_func, config)
        checkpoint = self._load_checkpoint_arg(checkpoint)
        self._executor.reset_checkpoint()
        self.checkpoint_manager.on_start_training(
            checkpoint_strategy=checkpoint_strategy)
        return TrainingIterator(
            self._executor, train_func, checkpoint,
            self.checkpoint_manager, shard_fn=self._shard_fn(dataset))

    def _shard_fn(self, dataset) -> Optional[Callable[[int], List]]:
        """world size -> shards, re-invoked on every (elastic) group
        (re)start so shards always match the live worker count."""
        if dataset is None:
            return None
        return lambda n: self._shards_for(dataset, n)

    def _shards_for(self, dataset, n: int) -> Optional[List]:
        if dataset is None:
            return None
        if isinstance(dataset, dict):
            shard_dict = {
                name: self._split_dataset(ds, n)
                for name, ds in dataset.items()}
            return [{name: shards[i] for name, shards in shard_dict.items()}
                    for i in range(n)]
        return self._split_dataset(dataset, n)

    @staticmethod
    def _split_dataset(dataset, n: int) -> List:
        if hasattr(dataset, "split"):
            return dataset.split(n)
        raise TypeError(f"cannot shard dataset of type {type(dataset)}")

    @staticmethod
    def _wrap_function(train_func: Callable, config: Optional[Dict]
                       ) -> Callable[[], Any]:
        import inspect

        sig = inspect.signature(train_func)
        if len(sig.parameters) > 1:
            raise ValueError(
                "train_func must take 0 or 1 argument (the config dict)")
        if len(sig.parameters) == 1:
            cfg = config or {}
            return lambda: train_func(cfg)
        return train_func

    @staticmethod
    def _load_checkpoint_arg(checkpoint) -> Optional[Dict]:
        if checkpoint is None or isinstance(checkpoint, dict):
            return checkpoint
        return CheckpointManager.load_checkpoint_from_path(checkpoint)

    def shutdown(self) -> None:
        if self._started:
            self._executor.shutdown()
            self._started = False

    # ---------------------------------------------------- tune integration
    def to_tune_trainable(self, train_func: Callable,
                          dataset: Any = None) -> Callable:
        """Wrap into a function trainable for ray_tpu_torch.tune
        (reference trainer.py build_tune_trainable). Each trial builds
        its OWN Trainer — concurrent trials sharing one executor would
        overwrite each other's worker sessions. A stopped trial's
        tune.report raises, so the finally below gives its workers,
        placement group and device memory back."""
        backend_config = self._backend_config
        num_workers = self._executor._num_workers
        cpus = self._executor._num_cpus_per_worker
        gpus = self._executor._num_gpus_per_worker
        extra = self._executor._additional_resources_per_worker

        def trainable(config):
            from ray_tpu_torch import tune

            resources = dict(extra or {})
            resources["CPU"] = cpus
            if gpus:
                resources["GPU"] = gpus
            trial_trainer = Trainer(
                backend=backend_config, num_workers=num_workers,
                resources_per_worker=resources)
            try:
                iterator = trial_trainer.run_iterator(
                    train_func, config, dataset=dataset)
                for round_results in iterator:
                    if round_results:
                        tune.report(**round_results[0])
            finally:
                trial_trainer.shutdown()
        trainable.__name__ = getattr(train_func, "__name__", "train_func")
        return trainable


class TrainingIterator:
    """Yields one list of per-worker results per lock-step round; restarts
    the worker group on failure (reference trainer.py TrainingIterator).
    Elastic executors also resize here, at round boundaries: shrink is a
    failure-restart with whatever capacity remains; growth triggers when
    capacity returns and a checkpoint exists to resume from."""

    def __init__(self, backend_executor: BackendExecutor, train_func,
                 checkpoint, checkpoint_manager: CheckpointManager,
                 shard_fn=None):
        self._executor = backend_executor
        self._train_func = train_func
        self._checkpoint_manager = checkpoint_manager
        self._shard_fn = shard_fn  # n -> shards, re-split per (re)start
        # a failure before this run's FIRST checkpoint restarts from the
        # run's own starting checkpoint, never a previous run's
        self._initial_checkpoint = checkpoint
        self._run_complete = False
        self.latest_run_results: Optional[List[Any]] = None
        self._start(checkpoint)

    def _start(self, checkpoint) -> None:
        shards = None
        if self._shard_fn is not None:
            shards = self._shard_fn(len(self._executor.worker_group))
        self._executor.start_training(
            self._train_func, checkpoint=checkpoint,
            dataset_shards=shards)

    def _restart_from_checkpoint(self) -> None:
        self._executor.handle_failure(None)
        self._start(self._checkpoint_manager.latest_checkpoint
                    or self._initial_checkpoint)

    def __iter__(self):
        return self

    def __next__(self) -> List[Dict]:
        while True:
            if self._executor.should_scale_up():
                logger.info("elastic scale-up: resizing the worker group")
                try:
                    self._restart_from_checkpoint()
                except Exception:
                    # the capacity that justified the resize vanished
                    # mid-restart; the group is down — come back at
                    # whatever size is feasible, not at all costs larger
                    logger.warning(
                        "scale-up failed; restarting at feasible size")
                    self._executor._resize_floor = 0
                    self._restart_from_checkpoint()
            try:
                results = self._fetch_round()
            except TrainingWorkerError:
                # restart from latest checkpoint after a worker death
                self._restart_from_checkpoint()
                continue
            if results is None:
                self.latest_run_results = self._finish()
                raise StopIteration
            return results

    def _fetch_round(self) -> Optional[List[Dict]]:
        while True:
            results = self._executor.get_next_results()
            if results is None:
                return None
            if results[0].type is TrainingResultType.CHECKPOINT:
                data = next((r.data for r in results if r.data), {})
                self._checkpoint_manager.process_checkpoint(data)
                continue  # checkpoints are consumed, not yielded
            return [r.data for r in results]

    def _finish(self) -> List[Any]:
        while True:
            try:
                return self._executor.finish_training()
            except TrainingWorkerError:
                self._executor.handle_failure(None)
                self._start(self._checkpoint_manager.latest_checkpoint
                            or self._initial_checkpoint)
                # drain the rerun
                while self._fetch_round() is not None:
                    pass
