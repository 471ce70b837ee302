"""Trainable — the unit a Tune trial runs.

Mirrors the reference's ray.tune.Trainable (python/ray/tune/trainable.py:
55; train:296, save_checkpoint:850, restore:461) plus the function-API
runner (python/ray/tune/function_runner.py): a function trainable runs on
its own thread and streams results through tune.report, one result per
``train()`` call. Once its trial is stopped, the function's next
tune.report raises ``TrialStopped``: the function unwinds, its finally
blocks run, and the thread ends before the trial's actor is killed.
"""

from __future__ import annotations

import logging
import queue
import threading
import time
from typing import Any, Callable, Dict, Optional

logger = logging.getLogger(__name__)

# result keys (reference tune/result.py)
TRAINING_ITERATION = "training_iteration"
DONE = "done"
TIME_THIS_ITER_S = "time_this_iter_s"
TIME_TOTAL_S = "time_total_s"
TRIAL_ID = "trial_id"

# how long a stopped function trial's cleanup waits for its thread to end
STOP_TIMEOUT_S = 30.0


class Trainable:
    """Class API: subclass and implement setup/step/save_checkpoint/
    load_checkpoint."""

    def __init__(self, config: Optional[Dict] = None, trial_id: str = ""):
        self.config = config or {}
        self.trial_id = trial_id
        self._iteration = 0
        self._time_total = 0.0
        self._start_time = time.time()
        self.setup(self.config)

    # ------------------------------------------------------- subclass API
    def setup(self, config: Dict) -> None:
        pass

    def step(self) -> Dict:
        raise NotImplementedError

    def save_checkpoint(self, checkpoint_dir: str = "") -> Any:
        return None

    def load_checkpoint(self, checkpoint: Any) -> None:
        pass

    def reset_config(self, new_config: Dict) -> bool:
        return False

    def cleanup(self) -> None:
        pass

    # --------------------------------------------------------- driver API
    def train(self) -> Dict:
        t0 = time.time()
        result = self.step() or {}
        self._iteration += 1
        dt = time.time() - t0
        self._time_total += dt
        result.setdefault(TRAINING_ITERATION, self._iteration)
        result.setdefault(TIME_THIS_ITER_S, dt)
        result.setdefault(TIME_TOTAL_S, self._time_total)
        result.setdefault(DONE, False)
        result.setdefault(TRIAL_ID, self.trial_id)
        return result

    def save(self) -> Dict:
        """In-memory checkpoint envelope (reference save_to_object)."""
        return {
            "data": self.save_checkpoint(),
            "iteration": self._iteration,
            "time_total": self._time_total,
        }

    def restore(self, checkpoint: Dict) -> None:
        self._iteration = checkpoint.get("iteration", 0)
        self._time_total = checkpoint.get("time_total", 0.0)
        self.load_checkpoint(checkpoint.get("data"))

    def reset(self, new_config: Dict, trial_id: str = None) -> bool:
        ok = self.reset_config(new_config)
        if ok:
            self.config = new_config
            if trial_id is not None:
                self.trial_id = trial_id
        return ok

    def stop(self) -> None:
        self.cleanup()

    @property
    def iteration(self) -> int:
        return self._iteration


# ---------------------------------------------------------------- function API
_fn_sessions: Dict[int, "FunctionRunner"] = {}


def report(**metrics) -> None:
    s = _fn_sessions.get(threading.get_ident())
    if s is None:
        raise RuntimeError(
            "tune.report() must be called from inside a Tune trainable")
    s._report(metrics)


class checkpoint_dir:
    """``with tune.checkpoint_dir(step=n) as d:`` context manager. The
    function API persists whatever the user writes into d; we keep the
    directory path in the in-memory checkpoint envelope."""

    def __init__(self, step: int):
        self.step = step

    def __enter__(self) -> str:
        import tempfile

        s = _fn_sessions.get(threading.get_ident())
        self._dir = tempfile.mkdtemp(prefix="tune_ckpt_")
        if s is not None:
            s._pending_checkpoint_dir = self._dir
        return self._dir

    def __exit__(self, *exc) -> None:
        s = _fn_sessions.get(threading.get_ident())
        if s is not None and exc[0] is None:
            s._checkpoint_taken(self._dir, self.step)


def get_trial_id() -> Optional[str]:
    s = _fn_sessions.get(threading.get_ident())
    return s.trial_id if s else None


class TrialStopped(SystemExit):
    """Raised by tune.report in the function of a stopped trial. As
    upstream Ray's reporter exits the function's thread, this unwinds it:
    the function's finally blocks run (a Trainer's shutdown among them).
    A SystemExit, so an ``except Exception`` in the function lets it by."""


class FunctionRunner(Trainable):
    """Adapts a train function to the Trainable interface: the function
    runs on a thread; each tune.report() unblocks one train() call.
    ``cleanup`` (the trial's stop) ends that thread under a deadline."""

    _function: Callable = None  # set by wrap_function subclass

    def setup(self, config: Dict) -> None:
        self._result_q: "queue.Queue" = queue.Queue(1)
        self._continue = threading.Semaphore(0)
        self._error: Optional[BaseException] = None
        self._done = False
        self._pending_checkpoint_dir = None
        self._last_metrics: Dict = {}
        self._latest_checkpoint = None
        self._restore_checkpoint = None
        self._thread: Optional[threading.Thread] = None
        self._stopped = False

    def _start_thread(self) -> None:
        def run():
            _fn_sessions[threading.get_ident()] = self
            try:
                import inspect

                sig = inspect.signature(self._function)
                if len(sig.parameters) >= 2:
                    self._function(self.config,
                                   checkpoint_dir=self._restore_checkpoint)
                else:
                    self._function(self.config)
            except TrialStopped:
                pass  # the trial was stopped: no error to report
            except BaseException as e:  # noqa: BLE001
                self._error = e
            finally:
                self._done = True
                _fn_sessions.pop(threading.get_ident(), None)
                self._result_q.put(None)

        self._thread = threading.Thread(
            target=run, daemon=True, name=f"tune-fn-{self.trial_id}")
        self._thread.start()

    def _report(self, metrics: Dict) -> None:
        if self._stopped:
            raise TrialStopped(0)
        self._result_q.put(dict(metrics))
        self._continue.acquire()
        if self._stopped:
            raise TrialStopped(0)

    def _checkpoint_taken(self, path: str, step: int) -> None:
        self._latest_checkpoint = {"dir": path, "step": step}

    def step(self) -> Dict:
        if self._thread is None:
            self._start_thread()
        result = self._result_q.get()
        if result is None:
            if self._error is not None:
                raise self._error
            # repeat the last reported metrics with the done flag set
            # (reference function_runner.py final-result handling)
            final = dict(self._last_metrics)
            final[DONE] = True
            return final
        self._last_metrics = dict(result)
        self._continue.release()
        return result

    def save_checkpoint(self, checkpoint_dir: str = "") -> Any:
        return self._latest_checkpoint

    def load_checkpoint(self, checkpoint: Any) -> None:
        if isinstance(checkpoint, dict):
            self._restore_checkpoint = checkpoint.get("dir")
        else:
            self._restore_checkpoint = checkpoint

    def cleanup(self) -> None:
        """End the function's thread: its next (or pending) tune.report
        raises TrialStopped. Wakes it wherever it waits, on a full result
        queue or on the semaphore, until it ends or STOP_TIMEOUT_S passes;
        a thread still running then is logged, not waited on."""
        thread = self._thread
        if thread is None or not thread.is_alive():
            return
        self._stopped = True
        deadline = time.monotonic() + STOP_TIMEOUT_S
        while thread.is_alive() and time.monotonic() < deadline:
            try:
                self._result_q.get_nowait()
            except queue.Empty:
                pass
            self._continue.release()
            thread.join(0.05)
        if thread.is_alive():
            logger.warning("trial %s: function thread %s still running "
                           "%.0f s after its stop", self.trial_id,
                           thread.name, STOP_TIMEOUT_S)


def wrap_function(train_func: Callable) -> type:
    class _WrappedFunc(FunctionRunner):
        _function = staticmethod(train_func)
    _WrappedFunc.__name__ = getattr(train_func, "__name__", "func")
    return _WrappedFunc
