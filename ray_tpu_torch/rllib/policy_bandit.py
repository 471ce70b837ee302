"""Contextual bandit policies: LinUCB and linear Thompson sampling.

Reference behavior: rllib/agents/bandit/ (BanditLinUCBTrainer,
BanditLinTSTrainer over rllib/agents/bandit/bandit_tf_policy.py's
per-arm linear models). Pure linear algebra — numpy is the right tool;
the batched update uses one solve per arm.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np

from ray_tpu_torch.rllib import sample_batch as sb
from ray_tpu_torch.rllib.policy import Policy
from ray_tpu_torch.rllib.sample_batch import SampleBatch


class LinUCBPolicy(Policy):
    """Per-arm ridge regression with an upper confidence bonus:
    score_a = theta_a.x + alpha * sqrt(x' A_a^-1 x)."""

    thompson = False

    def __init__(self, observation_dim: int, num_actions: int,
                 config: Optional[dict] = None):
        cfg = dict(alpha=1.0, lam=1.0, ts_scale=1.0, seed=0)
        cfg.update(config or {})
        self.cfg = cfg
        self.d = observation_dim
        self.k = num_actions
        self.A = np.stack([np.eye(self.d) * cfg["lam"]
                           for _ in range(self.k)])   # [K, d, d]
        self.b = np.zeros((self.k, self.d))            # [K, d]
        self._rng = np.random.default_rng(cfg["seed"])

    def _theta(self) -> np.ndarray:
        return np.stack([np.linalg.solve(self.A[a], self.b[a])
                         for a in range(self.k)])      # [K, d]

    def compute_actions(self, obs) -> Tuple[np.ndarray, dict]:
        x = np.atleast_2d(np.asarray(obs, np.float64))  # [B, d]
        theta = self._theta()
        mean = x @ theta.T                               # [B, K]
        inv = np.stack([np.linalg.inv(self.A[a])
                        for a in range(self.k)])         # [K, d, d]
        # sigma[b, a] = sqrt(x_b' A_a^-1 x_b)
        sigma = np.sqrt(np.einsum("bd,ade,be->ba", x, inv, x))
        if self.thompson:
            # sample theta_a ~ N(theta_a, ts_scale^2 A_a^-1) per decision
            scores = mean + self.cfg["ts_scale"] * sigma \
                * self._rng.standard_normal(mean.shape)
        else:
            scores = mean + self.cfg["alpha"] * sigma
        return np.argmax(scores, axis=1), {}

    def learn_on_batch(self, batch: SampleBatch) -> Dict[str, float]:
        x = np.atleast_2d(np.asarray(batch[sb.OBS], np.float64))
        actions = np.asarray(batch[sb.ACTIONS], np.int64)
        rewards = np.asarray(batch[sb.REWARDS], np.float64)
        for a in range(self.k):
            mask = actions == a
            if not mask.any():
                continue
            xa = x[mask]
            self.A[a] += xa.T @ xa
            self.b[a] += rewards[mask] @ xa
        theta = self._theta()
        pred = np.einsum("bd,bd->b", x, theta[actions])
        return {"mse": float(np.mean((pred - rewards) ** 2)),
                "pulls": int(len(actions))}

    def get_weights(self):
        return {"A": self.A.copy(), "b": self.b.copy()}

    def set_weights(self, weights) -> None:
        self.A = np.asarray(weights["A"]).copy()
        self.b = np.asarray(weights["b"]).copy()


class LinTSPolicy(LinUCBPolicy):
    """Linear Thompson sampling — same sufficient statistics, draws from
    the posterior instead of adding a UCB bonus."""

    thompson = True
