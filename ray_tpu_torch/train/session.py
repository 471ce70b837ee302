"""Worker-side training session.

Mirrors the reference's ray.train session (python/ray/train/session.py):
the train function runs on a thread inside each worker actor; ``report``
and ``save_checkpoint`` hand results back to the driver through a
producer/consumer queue, pausing the train thread until the driver has
consumed the result (lock-step heartbeat, as the reference does). A
Trainer that shuts down mid-run ends its sessions (``Session.end``): the
train function's next report raises ``SessionEnded``, so on the thread
tier its thread ends and frees what it held, as a killed worker process
does in the reference.
"""

from __future__ import annotations

import queue
import threading
import time
from dataclasses import dataclass
from enum import Enum
from typing import Any, Callable, Dict, Optional


class TrainingResultType(Enum):
    REPORT = "REPORT"
    CHECKPOINT = "CHECKPOINT"


@dataclass
class TrainingResult:
    type: TrainingResultType
    data: Dict[str, Any]


class SessionEnded(SystemExit):
    """Raised by report and save_checkpoint once the session has ended:
    the train function unwinds (its finally blocks run) and its thread
    ends. A SystemExit, so an ``except Exception`` lets it by."""


class Session:
    def __init__(self, training_func: Callable[[], Any], world_rank: int,
                 local_rank: int, world_size: int,
                 checkpoint: Optional[Dict] = None,
                 dataset_shard: Any = None,
                 detailed_autofilled_metrics: bool = False):
        self.training_func = training_func
        self.world_rank = world_rank
        self.local_rank = local_rank
        self.world_size = world_size
        self.loaded_checkpoint = checkpoint
        self.dataset_shard = dataset_shard
        # lock-step: train thread blocks in report() until driver fetches
        self.result_queue: "queue.Queue[TrainingResult]" = queue.Queue(1)
        self.continue_lock = threading.Semaphore(0)
        self.training_thread: Optional[threading.Thread] = None
        self.finished = False
        self.error: Optional[BaseException] = None
        self.output = None
        self.iteration = 0
        self.time_start = time.time()
        self.ended = False

    def start(self) -> None:
        def run():
            # Sessions are looked up by training-thread ident: worker
            # actors share one process in in-process mode, so a single
            # module global would collide across concurrent workers.
            _sessions[threading.get_ident()] = self
            try:
                self.output = self.training_func()
            except SessionEnded:
                pass  # ended by the Trainer's shutdown: not an error
            except BaseException as e:  # noqa: BLE001
                self.error = e
            finally:
                self.finished = True
                _sessions.pop(threading.get_ident(), None)
                # unblock a driver waiting in get_next
                self.result_queue.put(None)

        self.training_thread = threading.Thread(
            target=run, daemon=True, name=f"train-rank-{self.world_rank}")
        self.training_thread.start()

    def end(self, deadline: float) -> bool:
        """End the train thread: its next (or pending) report raises
        SessionEnded. Wakes it wherever it waits, on a full result queue
        or on the continue lock, until it ends or ``deadline``
        (time.monotonic()) passes -> whether it ended."""
        self.ended = True
        thread = self.training_thread
        while thread is not None and thread.is_alive() and \
                time.monotonic() < deadline:
            try:
                self.result_queue.get_nowait()
            except queue.Empty:
                pass
            self.continue_lock.release()
            thread.join(0.05)
        return thread is None or not thread.is_alive()

    def pause_reporting(self) -> None:
        self.continue_lock.release()

    def finish(self) -> Any:
        self.continue_lock.release()
        if self.training_thread is not None:
            self.training_thread.join()
        if self.error is not None:
            raise self.error
        return self.output

    def get_next(self) -> Optional[TrainingResult]:
        if self.finished and self.result_queue.empty():
            if self.error is not None:
                raise self.error
            return None
        result = self.result_queue.get()
        if result is None and self.error is not None:
            # The train thread died (its finally put the None marker):
            # surface the real error NOW. Deferring it to finish() wedges
            # the lock-step driver — healthy peers block in collectives
            # waiting for this rank, so their get_next never returns and
            # finish_training is never reached (the r05 dryrun hang).
            raise self.error
        if result is not None:
            # let the train thread continue past report()
            self.continue_lock.release()
        return result

    # ------------------------------------------------- called by train fn
    def _autofill(self, metrics: Dict) -> Dict:
        out = dict(metrics)
        out.setdefault("_timestamp", int(time.time()))
        out.setdefault("_time_this_iter_s", time.time() - self.time_start)
        out.setdefault("_training_iteration", self.iteration)
        return out

    def _hand_over(self, result: TrainingResult) -> None:
        """Queue ``result``; wait until the driver has consumed it."""
        if self.ended:
            raise SessionEnded(0)
        self.result_queue.put(result)
        self.continue_lock.acquire()
        if self.ended:
            raise SessionEnded(0)

    def report(self, **kwargs) -> None:
        self.iteration += 1
        self._hand_over(TrainingResult(
            TrainingResultType.REPORT, self._autofill(kwargs)))

    def checkpoint(self, **kwargs) -> None:
        # only rank 0's checkpoint is persisted (reference session.py)
        data = kwargs if self.world_rank == 0 else {}
        self._hand_over(TrainingResult(TrainingResultType.CHECKPOINT, data))


_sessions: Dict[int, Session] = {}


def init_session(*args, **kwargs) -> Session:
    return Session(*args, **kwargs)


def get_session() -> Session:
    s = _sessions.get(threading.get_ident())
    if s is None:
        raise ValueError(
            "`ray_tpu_torch.train` functions may only be called from inside a "
            "train function started by a Trainer")
    return s


def shutdown_session() -> None:
    _sessions.pop(threading.get_ident(), None)


# ------------------------------------------------------------- public API
def report(**kwargs) -> None:
    """Report intermediate metrics; blocks until the driver consumes them."""
    get_session().report(**kwargs)


def save_checkpoint(**kwargs) -> None:
    get_session().checkpoint(**kwargs)


def load_checkpoint() -> Optional[Dict]:
    return get_session().loaded_checkpoint


def world_rank() -> int:
    return get_session().world_rank


def local_rank() -> int:
    return get_session().local_rank


def world_size() -> int:
    return get_session().world_size


def get_dataset_shard(shard_name: Optional[str] = None) -> Any:
    shard = get_session().dataset_shard
    if isinstance(shard, dict):
        if shard_name is None:
            raise ValueError("Multiple datasets were passed; specify "
                             "which shard via get_dataset_shard(name)")
        return shard[shard_name]
    return shard
