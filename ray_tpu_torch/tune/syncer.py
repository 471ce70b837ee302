"""Experiment checkpointing + checkpoint sync.

Reference: python/ray/tune/syncer.py + trial_runner.py's experiment
checkpointing — tune periodically persists every trial's state (config,
results, checkpoint) to the experiment directory so ``tune.run(...,
resume=True)`` continues an interrupted sweep, and a Syncer mirrors the
experiment directory to durable storage (the reference's cloud sync;
here a pluggable URI scheme with a directory backend — S3-style remotes
slot in behind the same two methods)."""

from __future__ import annotations

import os
import shutil
import time
from typing import Dict, List, Optional

try:
    import cloudpickle as pickle
except ImportError:  # pragma: no cover
    import pickle

EXPERIMENT_STATE = "experiment_state.pkl"


class Syncer:
    """Two-method plugin surface (reference: tune/syncer.py Syncer)."""

    def sync_up(self, local_dir: str, remote_uri: str) -> None:
        raise NotImplementedError

    def sync_down(self, remote_uri: str, local_dir: str) -> None:
        raise NotImplementedError


class DirSyncer(Syncer):
    """Mirror the experiment dir into another directory tree — the
    single-host stand-in for cloud storage (an NFS mount or fuse-mapped
    bucket path works unchanged)."""

    def sync_up(self, local_dir: str, remote_uri: str) -> None:
        if os.path.isdir(local_dir):
            shutil.copytree(local_dir, remote_uri, dirs_exist_ok=True)

    def sync_down(self, remote_uri: str, local_dir: str) -> None:
        if os.path.isdir(remote_uri):
            shutil.copytree(remote_uri, local_dir, dirs_exist_ok=True)


def get_syncer(upload_dir: Optional[str]) -> Optional[Syncer]:
    if not upload_dir:
        return None
    if "://" in upload_dir and not upload_dir.startswith("file://"):
        raise ValueError(
            f"no syncer for {upload_dir!r}: cloud object stores are not "
            "reachable from this environment; mount the bucket (fuse/"
            "NFS) and pass the mount path, or register a custom Syncer")
    return DirSyncer()


def default_local_dir() -> str:
    return os.environ.get(
        "RAY_TPU_RESULTS_DIR",
        os.path.join(os.path.expanduser("~"), "ray_tpu_torch_results"))


# ---------------------------------------------------------------------------
# experiment state (trial_runner.checkpoint() role)
# ---------------------------------------------------------------------------

def save_experiment_state(exp_dir: str, trials: List) -> None:
    os.makedirs(exp_dir, exist_ok=True)
    state = []
    for t in trials:
        try:
            state.append({
                "trial_id": t.trial_id,
                "config": t.config,
                "experiment_tag": t.experiment_tag,
                "status": t.status,
                "last_result": t.last_result,
                "results": t.results,
                "checkpoint": t.checkpoint,
                "error": t.error,
                "num_failures": t.num_failures,
            })
        except Exception:
            continue  # an unpicklable trial must not sink the rest
    tmp = os.path.join(exp_dir, EXPERIMENT_STATE + ".tmp")
    with open(tmp, "wb") as f:
        pickle.dump({"version": 1, "time": time.time(),
                     "trials": state}, f)
    os.replace(tmp, os.path.join(exp_dir, EXPERIMENT_STATE))


def load_experiment_state(exp_dir: str) -> Optional[Dict]:
    path = os.path.join(exp_dir, EXPERIMENT_STATE)
    if not os.path.exists(path):
        return None
    with open(path, "rb") as f:
        return pickle.load(f)


class ExperimentCheckpointCallback:
    """Runner callback: persist experiment state (and sync it up) at a
    bounded cadence while trials report (reference: trial_runner
    checkpoints every checkpoint_period_s)."""

    def __init__(self, exp_dir: str, syncer: Optional[Syncer] = None,
                 upload_dir: Optional[str] = None,
                 period_s: float = 5.0,
                 extra_trials: Optional[List] = None):
        self.exp_dir = exp_dir
        self.syncer = syncer
        self.upload_dir = upload_dir
        self.period_s = period_s
        # finished trials restored from a previous run: EVERY save must
        # include them or a crash mid-resume would lose their results
        self.extra_trials = list(extra_trials or [])
        self._last = 0.0

    def on_trial_result(self, runner, trial, result) -> None:
        now = time.monotonic()
        if now - self._last < self.period_s:
            return
        self._last = now
        self.flush(runner.trials)

    def flush(self, trials: List) -> None:
        save_experiment_state(self.exp_dir, self.extra_trials
                              + [t for t in trials
                                 if t not in self.extra_trials])
        if self.syncer is not None and self.upload_dir:
            try:
                self.syncer.sync_up(self.exp_dir, self.upload_dir)
            except Exception:
                pass  # durable sync is best-effort mid-run
