"""Training callbacks.

Mirrors the reference's ray.train callbacks
(python/ray/train/callbacks/): TrainingCallback protocol plus JSON and
print loggers; results flow in once per lock-step round.
"""

from __future__ import annotations

import json
import logging
from pathlib import Path
from typing import Dict, List, Optional

logger = logging.getLogger(__name__)


class TrainingCallback:
    def start_training(self, logdir: str, config: Optional[Dict] = None,
                       **info) -> None:
        pass

    def handle_result(self, results: List[Dict], **info) -> None:
        pass

    def finish_training(self, error: bool = False, **info) -> None:
        pass


class PrintCallback(TrainingCallback):
    def handle_result(self, results: List[Dict], **info) -> None:
        print(json.dumps(results, default=str))


class JsonLoggerCallback(TrainingCallback):
    """Appends one JSON line per round to results.json in the run dir."""

    def __init__(self, filename: str = "results.json"):
        self.filename = filename
        self.logdir: Optional[Path] = None
        self._results: List[List[Dict]] = []

    @property
    def log_path(self) -> Optional[Path]:
        return self.logdir / self.filename if self.logdir else None

    def start_training(self, logdir: str, config: Optional[Dict] = None,
                       **info) -> None:
        self.logdir = Path(logdir)
        self.logdir.mkdir(parents=True, exist_ok=True)
        self._results = []
        with open(self.log_path, "w") as f:
            json.dump([], f)

    def handle_result(self, results: List[Dict], **info) -> None:
        self._results.append(results)
        with open(self.log_path, "w") as f:
            json.dump(self._results, f, default=str)

    def finish_training(self, error: bool = False, **info) -> None:
        pass
