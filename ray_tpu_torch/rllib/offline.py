"""Offline data IO: JSON sample writers/readers.

Reference: rllib/offline/json_writer.py + json_reader.py — SampleBatches
serialized as JSON lines so experiences collected by one run train
another (behavior cloning, MARWIL). Columns are stored as nested lists;
dtypes restore on read.
"""

from __future__ import annotations

import json
import os
from typing import Iterator, List, Optional, Union

import numpy as np

from ray_tpu_torch.rllib.sample_batch import SampleBatch


class JsonWriter:
    """Append SampleBatches to a .json lines file."""

    def __init__(self, path: str):
        self.path = path
        parent = os.path.dirname(os.path.abspath(path))
        os.makedirs(parent, exist_ok=True)
        self._fp = open(path, "a")

    def write(self, batch: SampleBatch) -> None:
        row = {k: np.asarray(v).tolist() for k, v in batch.items()}
        self._fp.write(json.dumps(row) + "\n")
        self._fp.flush()

    def close(self) -> None:
        self._fp.close()


class JsonReader:
    """Read SampleBatches back; `next()` cycles forever (reference:
    json_reader.py next() loops over the input files)."""

    def __init__(self, path_or_batches: Union[str, List[SampleBatch]]):
        if isinstance(path_or_batches, str):
            self.batches = list(_read_file(path_or_batches))
        else:
            self.batches = list(path_or_batches)
        if not self.batches:
            raise ValueError("offline input is empty")
        self._i = 0

    def next(self) -> SampleBatch:
        batch = self.batches[self._i % len(self.batches)]
        self._i += 1
        return batch

    def __iter__(self) -> Iterator[SampleBatch]:
        return iter(self.batches)


def _read_file(path: str) -> Iterator[SampleBatch]:
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            row = json.loads(line)
            yield SampleBatch({k: np.asarray(v) for k, v in row.items()})


def collect_episodes(env, policy, num_steps: int,
                     writer: Optional[JsonWriter] = None,
                     seed: int = 0) -> SampleBatch:
    """Roll a policy in an env for num_steps and return (and optionally
    persist) the experience — the seam tests and examples use to build
    offline datasets."""
    from ray_tpu_torch.rllib import sample_batch as sb

    env.seed(seed)
    obs = env.reset()
    continuous = bool(getattr(env, "action_dim", 0))
    cols = {k: [] for k in (sb.OBS, sb.ACTIONS, sb.REWARDS, sb.DONES,
                            sb.NEXT_OBS)}
    for _ in range(num_steps):
        actions, _ = policy.compute_actions(obs)
        if continuous:  # int() would silently truncate torques
            action = np.asarray(actions, np.float32).reshape(-1)
        else:
            action = int(np.asarray(actions).reshape(-1)[0])
        next_obs, reward, done, _ = env.step(action)
        cols[sb.OBS].append(obs)
        cols[sb.ACTIONS].append(action)
        cols[sb.REWARDS].append(reward)
        cols[sb.DONES].append(done)
        cols[sb.NEXT_OBS].append(next_obs)
        obs = env.reset() if done else next_obs
    batch = SampleBatch({k: np.asarray(v) for k, v in cols.items()})
    if writer is not None:
        writer.write(batch)
    return batch
