"""Checkpoint bookkeeping for ray_tpu_torch.train.

Mirrors the reference's ray.train CheckpointManager
(python/ray/train/checkpoint.py): tracks the latest + best checkpoints,
persists rank-0 checkpoints to disk, bounds how many are kept
(keep N by score or recency).
"""

from __future__ import annotations

import heapq
import logging
import pickle
from dataclasses import dataclass
from pathlib import Path
from typing import Any, Dict, List, Optional

logger = logging.getLogger(__name__)

TUNE_CHECKPOINT_ID = "_current_checkpoint_id"


@dataclass
class CheckpointStrategy:
    """Mirrors ray.train.CheckpointStrategy."""

    num_to_keep: Optional[int] = None
    checkpoint_score_attribute: str = "_training_iteration"
    checkpoint_score_order: str = "max"

    def __post_init__(self):
        if self.num_to_keep is not None and self.num_to_keep < 0:
            raise ValueError("num_to_keep must be non-negative")
        if self.checkpoint_score_order not in ("max", "min"):
            raise ValueError("checkpoint_score_order must be 'max' or 'min'")


@dataclass(order=True)
class _Tracked:
    priority: float
    checkpoint_id: int
    path: Optional[Path] = None


class CheckpointManager:
    def __init__(self, run_dir: Optional[Path] = None,
                 checkpoint_strategy: Optional[CheckpointStrategy] = None):
        self.run_dir = Path(run_dir) if run_dir else None
        self._strategy = checkpoint_strategy or CheckpointStrategy()
        self._checkpoint_id = 0
        self.latest_checkpoint: Optional[Dict] = None
        self.latest_checkpoint_path: Optional[Path] = None
        self.best_checkpoint_path: Optional[Path] = None
        self._top: List[_Tracked] = []  # min-heap of kept checkpoints

    @property
    def latest_checkpoint_id(self) -> int:
        return self._checkpoint_id

    def on_start_training(self, checkpoint_strategy=None, run_dir=None,
                          latest_checkpoint_id=None):
        if checkpoint_strategy is not None:
            self._strategy = checkpoint_strategy
        if run_dir is not None:
            self.run_dir = Path(run_dir)
        if latest_checkpoint_id is not None:
            self._checkpoint_id = latest_checkpoint_id
        # a fresh run must not see the previous run's checkpoint through
        # the failure-restart path OR the path accessors (the persisted
        # files themselves remain on disk under run_dir)
        self.latest_checkpoint = None
        self.latest_checkpoint_path = None
        self.best_checkpoint_path = None
        self._top = []

    def _score(self, checkpoint: Dict) -> float:
        attr = self._strategy.checkpoint_score_attribute
        value = checkpoint.get(attr, self._checkpoint_id)
        try:
            score = float(value)
        except (TypeError, ValueError):
            score = float(self._checkpoint_id)
        return score if self._strategy.checkpoint_score_order == "max" \
            else -score

    def process_checkpoint(self, checkpoint: Dict) -> None:
        self._checkpoint_id += 1
        self.latest_checkpoint = dict(checkpoint)
        self.latest_checkpoint[TUNE_CHECKPOINT_ID] = self._checkpoint_id
        if self.run_dir is None:
            return
        ckpt_dir = self.run_dir / "checkpoints"
        ckpt_dir.mkdir(parents=True, exist_ok=True)
        path = ckpt_dir / f"checkpoint_{self._checkpoint_id:06d}"
        with open(path, "wb") as f:
            pickle.dump(self.latest_checkpoint, f)
        self.latest_checkpoint_path = path
        tracked = _Tracked(self._score(checkpoint), self._checkpoint_id, path)
        keep = self._strategy.num_to_keep
        if keep is None:
            heapq.heappush(self._top, tracked)
        elif keep == 0:
            path.unlink(missing_ok=True)
            return
        elif len(self._top) < keep:
            heapq.heappush(self._top, tracked)
        else:
            worst = heapq.heappushpop(self._top, tracked)
            if worst.path is not None and worst.path != path:
                worst.path.unlink(missing_ok=True)
        if self._top:
            self.best_checkpoint_path = max(self._top).path

    @staticmethod
    def load_checkpoint_from_path(path) -> Dict:
        with open(path, "rb") as f:
            return pickle.load(f)
