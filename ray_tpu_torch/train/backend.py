"""Backend executor — orchestration core of ray_tpu_torch.train.

Mirrors the reference's ray.train BackendExecutor
(python/ray/train/backend.py:104): creates the placement group
(backend.py:190), starts the worker group, initializes the per-worker
session, streams results, and restarts workers from the latest checkpoint
on failure (handle_failure, backend.py:60).

The default backend is ``TopologyConfig``: workers learn their
(world_rank, world_size). On the thread tier the workers are actors
that share the process, and its card. The ``"torch"`` (``TorchConfig``,
a gloo process group) and ``"tensorflow"`` (``TensorflowConfig``,
TF_CONFIG) backends need one OS process per rank: the process tier,
``init(worker_mode="process")``.
"""

from __future__ import annotations

import logging
import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, TypeVar

import ray_tpu_torch
from ray_tpu_torch.train.session import TrainingResult, TrainingResultType
from ray_tpu_torch.train.worker_group import WorkerGroup

T = TypeVar("T")
logger = logging.getLogger(__name__)


class TrainBackendError(Exception):
    pass


class TrainingWorkerError(Exception):
    """A worker died during training; the executor restarts the group."""


@dataclass
class BackendConfig:
    """Base config; subclasses pick the backend class."""

    @property
    def backend_cls(self):
        return Backend


class Backend:
    """Startup/teardown hooks around the worker group."""

    share_cuda_visible_devices: bool = False

    def on_start(self, worker_group: WorkerGroup,
                 backend_config: BackendConfig) -> None:
        pass

    def on_shutdown(self, worker_group: WorkerGroup,
                    backend_config: BackendConfig) -> None:
        pass

    @staticmethod
    def encode_data(data_dict: Dict) -> Dict:
        return data_dict

    @staticmethod
    def decode_data(data_dict: Dict) -> Dict:
        return data_dict


@dataclass
class TopologyConfig(BackendConfig):
    """The default backend: each worker learns its (world_rank,
    world_size), read through ``get_worker_topology``; no process group
    is formed. Workers of the thread tier share one process and address
    the card directly, so there is no rendezvous to run (the JAX
    package's ``JaxConfig`` records the same)."""

    @property
    def backend_cls(self):
        return _TopologyBackend


class _TopologyBackend(Backend):
    def on_start(self, worker_group: WorkerGroup,
                 backend_config: "TopologyConfig") -> None:
        n = len(worker_group)

        def setup(rank: int, world: int):
            # per-actor topology registry, NOT os.environ: workers share
            # a process on the thread tier, so env writes would race and
            # every rank would read the last writer's value
            _worker_topology[_actor_key()] = (rank, world)
        futures = [
            worker_group.execute_single_async(i, setup, i, n)
            for i in range(n)]
        ray_tpu_torch.get(futures)


@dataclass
class TorchConfig(BackendConfig):
    """Torch DDP backend (reference: train/torch.py:57
    setup_torch_process_group): each worker joins a gloo process group
    rendezvoused over TCP, after which the train function can use
    torch.distributed / DistributedDataParallel directly. Requires
    process-backed workers (``ray_tpu_torch.init(worker_mode="process")``) —
    one OS process per rank is what torch.distributed assumes; thread
    workers share a process and are rejected with guidance. NCCL across
    cards needs one device per rank, which the process tier does not
    hand out yet (its workers see no card unless
    RAY_TPU_WORKER_CUDA_VISIBLE_DEVICES names one)."""

    backend: str = "gloo"
    init_method: Optional[str] = None  # default: tcp on a free port
    timeout_s: float = 120.0

    @property
    def backend_cls(self):
        return _TorchBackend


def _require_process_workers(worker_group: WorkerGroup,
                             backend_name: str) -> None:
    """torch.distributed and TF_CONFIG are per-PROCESS mechanisms: a
    rank per OS process is the contract. Thread workers share one
    process and are rejected with guidance."""
    n = len(worker_group)
    pids = ray_tpu_torch.get([
        worker_group.execute_single_async(
            i, lambda _r: __import__("os").getpid(), i)
        for i in range(n)])
    if len(set(pids)) != n:
        raise TrainBackendError(
            f"backend={backend_name!r} needs one OS process per rank; "
            "start the runtime with ray_tpu_torch.init("
            "worker_mode='process', num_process_workers>=num_workers)")


def _pick_free_ports(count: int) -> list:
    """Distinct free ports: every picker socket stays open until the
    whole list is chosen, so the kernel cannot re-issue an earlier
    pick to a later one."""
    import socket

    socks = []
    try:
        for _ in range(count):
            s = socket.socket()
            s.bind(("127.0.0.1", 0))
            socks.append(s)
        return [s.getsockname()[1] for s in socks]
    finally:
        for s in socks:
            s.close()


class _TorchBackend(Backend):
    def on_start(self, worker_group: WorkerGroup,
                 backend_config: "TorchConfig") -> None:
        n = len(worker_group)
        _require_process_workers(worker_group, "torch")
        init_method = backend_config.init_method
        if init_method is None:
            init_method = f"tcp://127.0.0.1:{_pick_free_ports(1)[0]}"

        def setup(rank: int, world: int, method: str, dist_backend: str,
                  timeout_s: float):
            import datetime

            import torch.distributed as dist

            dist.init_process_group(
                dist_backend, init_method=method, rank=rank,
                world_size=world,
                timeout=datetime.timedelta(seconds=timeout_s))
            _worker_topology[_actor_key()] = (rank, world)

        ray_tpu_torch.get([
            worker_group.execute_single_async(
                i, setup, i, n, init_method, backend_config.backend,
                backend_config.timeout_s)
            for i in range(n)])

    def on_shutdown(self, worker_group: WorkerGroup,
                    backend_config: "TorchConfig") -> None:
        def teardown():
            import torch.distributed as dist

            if dist.is_initialized():
                dist.destroy_process_group()

        try:
            ray_tpu_torch.get([
                worker_group.execute_single_async(i, teardown)
                for i in range(len(worker_group))])
        except Exception:
            pass  # workers may already be dead at shutdown


@dataclass
class TensorflowConfig(BackendConfig):
    """TF MultiWorkerMirrored backend (reference: train/tensorflow.py):
    each worker gets a TF_CONFIG describing the whole cluster and its
    own index, the contract tf.distribute.MultiWorkerMirroredStrategy
    reads at construction. Requires process-backed workers (TF_CONFIG
    is per-process env)."""

    port_base: int = 0  # 0 = pick free ports

    @property
    def backend_cls(self):
        return _TensorflowBackend


class _TensorflowBackend(Backend):
    def on_start(self, worker_group: WorkerGroup,
                 backend_config: "TensorflowConfig") -> None:
        n = len(worker_group)
        _require_process_workers(worker_group, "tensorflow")
        if backend_config.port_base:
            ports = [backend_config.port_base + i for i in range(n)]
        else:
            ports = _pick_free_ports(n)
        workers = [f"127.0.0.1:{p}" for p in ports]

        def setup(rank: int, world: int, worker_list):
            import json as _json
            import os as _os

            _os.environ["TF_CONFIG"] = _json.dumps({
                "cluster": {"worker": list(worker_list)},
                "task": {"type": "worker", "index": rank},
            })
            _worker_topology[_actor_key()] = (rank, world)

        ray_tpu_torch.get([
            worker_group.execute_single_async(i, setup, i, n, workers)
            for i in range(n)])


def get_worker_topology() -> Optional[tuple]:
    """(world_rank, world_size) of the calling worker actor, if set up."""
    try:
        return _worker_topology.get(_actor_key())
    except TrainBackendError:
        return None


class BackendExecutor:
    def __init__(self, backend_config: BackendConfig,
                 num_workers: int = 1,
                 num_cpus_per_worker: float = 1,
                 num_gpus_per_worker: float = 0,
                 additional_resources_per_worker: Optional[Dict] = None,
                 max_retries: int = 3,
                 min_workers: Optional[int] = None):
        self._backend_config = backend_config
        self._backend: Backend = backend_config.backend_cls()
        self._num_workers = num_workers
        # elastic when min_workers < num_workers: a shrunken cluster
        # restarts the group at any size in [min_workers, num_workers]
        # and grows back when capacity returns (the multihost
        # slice-restart story: lose a slice, keep training on the rest)
        self._target_workers = num_workers
        self._min_workers = (num_workers if min_workers is None
                             else max(1, min(min_workers, num_workers)))
        self._num_cpus_per_worker = num_cpus_per_worker
        self._num_gpus_per_worker = num_gpus_per_worker
        self._additional_resources_per_worker = \
            additional_resources_per_worker
        self._max_failures = (max_retries if max_retries >= 0
                              else float("inf"))
        self._num_failures = 0
        self._initialization_hook = None
        self._placement_group = None
        self.worker_group: Optional[WorkerGroup] = None
        self._latest_checkpoint: Optional[Dict] = None
        self._resize_floor = 0  # scale-up restarts must not shrink

    @property
    def elastic(self) -> bool:
        return self._min_workers < self._target_workers

    def _per_worker_demand(self) -> Dict[str, float]:
        demand: Dict[str, float] = {}
        if self._num_cpus_per_worker:
            demand["CPU"] = self._num_cpus_per_worker
        if self._num_gpus_per_worker:
            demand["GPU"] = self._num_gpus_per_worker
        for k, v in (self._additional_resources_per_worker or {}).items():
            demand[k] = demand.get(k, 0.0) + v
        return demand

    def _feasible_workers(self) -> int:
        """How many workers the cluster can host RIGHT NOW, capped at
        the target size. Computed PER NODE (whole bundles): aggregate
        availability overcounts fractional leftovers no PACK bundle can
        actually occupy."""
        demand = self._per_worker_demand()
        if not demand:
            return self._target_workers
        from ray_tpu_torch.core import runtime as rt_mod

        rt = rt_mod.global_runtime
        if rt is None:
            return 0
        fit = 0
        for raylet in rt.cluster_state.alive_raylets():
            avail = raylet.local_resources.to_map(
                rt.cluster_state.ids, available=True)
            fit += min(int(avail.get(k, 0.0) / v)
                       for k, v in demand.items())
        return min(self._target_workers, fit)

    def _resolve_group_size(self, timeout: float = 15.0) -> int:
        """Elastic start sizing: wait for at least the floor of capacity
        (a dying node's actors free resources asynchronously; a scale-up
        restart must wait for its OWN former resources to return or it
        would 'grow' into a smaller group), then take everything
        available up to target."""
        if not self.elastic:
            return self._target_workers
        floor = max(self._min_workers, self._resize_floor)
        self._resize_floor = 0
        start = time.monotonic()
        deadline = start + timeout
        fit = self._feasible_workers()
        last_fit, stable = fit, 0
        while fit < floor and time.monotonic() < deadline:
            time.sleep(0.2)
            fit = self._feasible_workers()
            # settle early once capacity stops changing at a viable
            # size: a worker crash frees the whole old group back (keep
            # waiting, fit is climbing); a node loss plateaus below the
            # floor (restart now, do not burn the full timeout). The
            # grace period + 2s plateau guard against sampling BEFORE
            # the old group's resources started coming back.
            if fit == last_fit:
                stable += 1
                if (fit >= self._min_workers and stable >= 10
                        and time.monotonic() - start >= 3.0):
                    break
            else:
                last_fit, stable = fit, 0
        if fit < self._min_workers:
            raise TrainBackendError(
                f"cluster can host only {fit} workers; elastic minimum "
                f"is {self._min_workers}")
        return max(fit, self._min_workers)

    def should_scale_up(self) -> bool:
        """True when the group runs below target, capacity for at least
        one MORE worker exists beyond what the group already holds (its
        own resources come back on restart), and a checkpoint exists to
        resume from (resizing without one would lose progress)."""
        if not self.elastic or self.worker_group is None:
            return False
        if len(self.worker_group) >= self._target_workers:
            return False
        if self._latest_checkpoint is None:
            return False
        if self._feasible_workers() < 1:
            return False
        # the restart must come back STRICTLY larger or it's pure churn
        self._resize_floor = len(self.worker_group) + 1
        return True

    # ------------------------------------------------------------ lifecycle
    def start(self, initialization_hook: Optional[Callable[[], None]] = None,
              train_cls=None, train_cls_args=None, train_cls_kwargs=None
              ) -> None:
        self._num_workers = self._resolve_group_size()
        self._create_placement_group()
        self.worker_group = WorkerGroup(
            num_workers=self._num_workers,
            num_cpus_per_worker=self._num_cpus_per_worker,
            num_gpus_per_worker=self._num_gpus_per_worker,
            additional_resources_per_worker=(
                self._additional_resources_per_worker),
            placement_group=self._placement_group)
        if initialization_hook:
            self._initialization_hook = initialization_hook
            self.worker_group.execute(initialization_hook)
        self._backend.on_start(self.worker_group, self._backend_config)

    def _create_placement_group(self) -> None:
        """PACK the workers (reference backend.py:190)."""
        from ray_tpu_torch.util.placement_group import placement_group

        bundle = {"CPU": self._num_cpus_per_worker}
        if self._num_gpus_per_worker:
            bundle["GPU"] = self._num_gpus_per_worker
        if self._additional_resources_per_worker:
            bundle.update(self._additional_resources_per_worker)
        bundles = [dict(bundle) for _ in range(self._num_workers)]
        pg = placement_group(bundles, strategy="PACK")
        ray_tpu_torch.get(pg.ready(), timeout=30)
        self._placement_group = pg

    # ------------------------------------------------------------- training
    def start_training(self, train_func: Callable[[], T],
                       checkpoint: Optional[Dict] = None,
                       dataset_shards: Optional[List] = None) -> None:
        if self.worker_group is None:
            raise TrainBackendError("start() must be called before training")
        checkpoint = checkpoint or self._latest_checkpoint
        n = len(self.worker_group)
        futures = []
        for i in range(n):
            shard = dataset_shards[i] if dataset_shards else None
            futures.append(self.worker_group.execute_single_async(
                i, _start_session_on_worker, train_func, i, n, checkpoint,
                shard))
        ray_tpu_torch.get(futures)

    def get_next_results(self) -> Optional[List[TrainingResult]]:
        """One lock-step round of results from every worker (or None when
        all train functions finished)."""
        futures = self.worker_group.execute_async(_session_get_next)
        try:
            # Incremental fetch: a worker whose train function died
            # raises from its get_next immediately, while healthy peers
            # may still be blocked in a collective waiting for the dead
            # rank (they only unblock at collective_op_timeout_s).
            # ray_tpu_torch.get over ALL futures would stall the driver on
            # those peers before surfacing the real error; consuming
            # futures as they complete surfaces it in milliseconds.
            by_ref = {}
            pending = list(futures)
            while pending:
                done, pending = ray_tpu_torch.wait(pending, num_returns=1)
                for ref in done:
                    # raises the error NOW
                    by_ref[ref] = ray_tpu_torch.get(ref)
            results = [by_ref[ref] for ref in futures]
        except ray_tpu_torch.exceptions.RayActorError as e:
            self._increment_failures(e)
            raise TrainingWorkerError from e
        if any(r is None for r in results):
            if not all(r is None for r in results):
                raise RuntimeError(
                    "Some workers returned results while others didn't. "
                    "Make sure train.report/save_checkpoint are called the "
                    "same number of times on all workers.")
            return None
        first_type = results[0].type
        if any(r.type is not first_type for r in results):
            raise RuntimeError(
                "Mismatched result types across workers in one round.")
        if first_type is TrainingResultType.CHECKPOINT:
            self._latest_checkpoint = results[0].data or next(
                (r.data for r in results if r.data), {})
        return results

    def finish_training(self) -> List[Any]:
        try:
            return self.worker_group.execute(_session_finish)
        except ray_tpu_torch.exceptions.RayActorError as e:
            self._increment_failures(e)
            raise TrainingWorkerError from e

    # -------------------------------------------------------------- failure
    def handle_failure(self, error: BaseException) -> None:
        """Tear down and restart the group; training resumes from the
        latest checkpoint (reference Backend.handle_failure)."""
        logger.warning("worker failure detected; restarting group: %s", error)
        if self.elastic and not self._resize_floor and \
                self.worker_group is not None:
            # prefer coming back at the previous size: a transient
            # worker crash should not shrink-then-regrow the group
            self._resize_floor = len(self.worker_group)
        self.shutdown(keep_checkpoint=True)
        self.start(self._initialization_hook)

    def reset_checkpoint(self) -> None:
        """A new run must not silently resume the previous run's state."""
        self._latest_checkpoint = None

    def _increment_failures(self, error: BaseException) -> None:
        self._num_failures += 1
        if self._num_failures > self._max_failures:
            raise RuntimeError(
                f"Training failed {self._num_failures} times, exceeding "
                f"max_retries={self._max_failures}.") from error

    @property
    def latest_checkpoint(self) -> Optional[Dict]:
        return self._latest_checkpoint

    def shutdown(self, keep_checkpoint: bool = False) -> None:
        if self.worker_group is not None:
            _end_sessions(self.worker_group)
            try:
                self._backend.on_shutdown(self.worker_group,
                                          self._backend_config)
            except Exception:  # noqa: BLE001
                pass
            self.worker_group.shutdown()
            self.worker_group = None
        if self._placement_group is not None:
            from ray_tpu_torch.util.placement_group import (
                remove_placement_group,
            )

            remove_placement_group(self._placement_group)
            self._placement_group = None
        if not keep_checkpoint:
            self._latest_checkpoint = None


# ---- closures executed on worker actors (module-level so they pickle).
# The active session is registered per worker-actor id: actors may share a
# process (in-process mode), so the registry is keyed, not global.
_worker_sessions: Dict[str, Any] = {}
_worker_topology: Dict[str, tuple] = {}


# how long a shutdown waits for its workers' train threads to end
SESSION_END_TIMEOUT_S = 30.0


def _end_sessions(worker_group: WorkerGroup) -> None:
    """End the train threads of the group's thread-tier workers, which
    run in this process (a process-tier worker's ends with its process),
    so that what a train function holds is freed before its worker and
    placement group are given back. A thread still running at the
    deadline is logged by name, not waited on."""
    sessions = [s for s in (_worker_sessions.pop(w.actor._actor_id.hex(),
                                                 None)
                            for w in worker_group.workers) if s is not None]
    for s in sessions:  # all unwind at once, each at its next report
        s.ended = True
    deadline = time.monotonic() + SESSION_END_TIMEOUT_S
    for s in sessions:
        if not s.end(deadline):
            logger.warning("train thread %s still running %.0f s after "
                           "the shutdown", s.training_thread.name,
                           SESSION_END_TIMEOUT_S)


def _actor_key() -> str:
    import os

    # PROCESS-backed actor first: the method body runs in the actor's
    # dedicated OS process, where the runtime context (and actor id)
    # live parent-side. Consulting get_runtime_context() here would
    # AUTO-INIT a whole nested runtime inside every worker process just
    # to learn the actor id is None. One actor per dedicated process
    # makes the pid a stable worker identity for the registries.
    if os.environ.get("RAY_TPU_WORKER_PROCESS") == "1":
        return f"proc-{os.getpid()}"
    aid = ray_tpu_torch.get_runtime_context().get_actor_id()
    if aid is None:
        raise TrainBackendError(
            "session closures must run on a worker actor")
    return aid


def _start_session_on_worker(train_func, rank, world, checkpoint, shard):
    from ray_tpu_torch.train import session as session_mod

    s = session_mod.init_session(
        training_func=train_func, world_rank=rank, local_rank=rank,
        world_size=world, checkpoint=checkpoint, dataset_shard=shard)
    _worker_sessions[_actor_key()] = s
    s.start()


def _session_get_next(worker_self=None):
    s = _worker_sessions.get(_actor_key())
    if s is None:
        raise TrainBackendError("no session active on worker")
    return s.get_next()


def _session_finish(worker_self=None):
    key = _actor_key()
    s = _worker_sessions.get(key)
    if s is None:
        raise TrainBackendError("no session active on worker")
    try:
        return s.finish()
    finally:
        _worker_sessions.pop(key, None)
