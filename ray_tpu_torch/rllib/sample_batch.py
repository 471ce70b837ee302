"""SampleBatch — columnar rollout data (reference:
rllib/policy/sample_batch.py). A dict of parallel numpy arrays; concat
and minibatch slicing are the two operations the training loop needs.
"""

from __future__ import annotations

from typing import Dict, Iterator, List

import numpy as np

OBS = "obs"
ACTIONS = "actions"
REWARDS = "rewards"
DONES = "dones"
NEXT_OBS = "next_obs"
LOGITS = "logits"
LOGP = "logp"
VALUES = "values"
ADVANTAGES = "advantages"
RETURNS = "returns"


class SampleBatch(dict):
    @property
    def count(self) -> int:
        for v in self.values():
            return len(v)
        return 0

    @staticmethod
    def concat_samples(batches: List["SampleBatch"]) -> "SampleBatch":
        batches = [b for b in batches if b.count]
        if not batches:
            return SampleBatch()
        keys = batches[0].keys()
        return SampleBatch({
            k: np.concatenate([np.asarray(b[k]) for b in batches])
            for k in keys})

    def shuffle(self, rng: np.random.Generator) -> "SampleBatch":
        perm = rng.permutation(self.count)
        return SampleBatch({k: np.asarray(v)[perm]
                            for k, v in self.items()})

    def minibatches(self, size: int) -> Iterator["SampleBatch"]:
        n = self.count
        for start in range(0, n, size):
            yield SampleBatch({k: np.asarray(v)[start:start + size]
                               for k, v in self.items()})
