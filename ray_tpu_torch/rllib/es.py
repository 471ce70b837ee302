"""Evolution strategies trainers: ES and ARS.

Reference behavior: rllib/agents/es/ (OpenAI-ES: antithetic Gaussian
perturbations, centered-rank fitness shaping) and rllib/agents/ars/
(Augmented Random Search: top-k directions, std-of-returns step-size
normalization). Both are embarrassingly parallel: each perturbation's
fitness is one episode rollout, fanned out as ray_tpu_torch tasks — the same
shape the reference runs across a cluster.

The evaluated policy is a deterministic linear/MLP over numpy params —
ES needs only a flat parameter vector and a fitness function.
"""

from __future__ import annotations

import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

import ray_tpu_torch
from ray_tpu_torch.rllib.env import make_env


def _policy_sizes(obs_dim: int, num_actions: int,
                  hidden: Tuple[int, ...]) -> List[Tuple[int, int]]:
    dims = (obs_dim, *hidden, num_actions)
    return list(zip(dims[:-1], dims[1:]))


def _num_params(sizes: List[Tuple[int, int]]) -> int:
    return sum(fi * fo + fo for fi, fo in sizes)


def _act(flat: np.ndarray, sizes: List[Tuple[int, int]],
         obs: np.ndarray) -> int:
    """Deterministic forward pass from the flat param vector."""
    x = obs
    off = 0
    for i, (fi, fo) in enumerate(sizes):
        w = flat[off:off + fi * fo].reshape(fi, fo)
        off += fi * fo
        b = flat[off:off + fo]
        off += fo
        x = x @ w + b
        if i < len(sizes) - 1:
            x = np.tanh(x)
    return int(np.argmax(x))


def rollout_fitness(flat_params, sizes, env, env_config, num_episodes,
                    seed) -> float:
    """One perturbation's fitness: mean episode return. Runs as a remote
    task (reference: es/es.py Worker.do_rollouts)."""
    e = make_env(env, env_config)
    e.seed(seed)
    total = 0.0
    for ep in range(num_episodes):
        obs = e.reset()
        done = False
        while not done:
            obs, reward, done, _ = e.step(_act(flat_params, sizes, obs))
            total += reward
    return total / num_episodes


class ESTrainer:
    """OpenAI evolution strategies (reference: agents/es/es.py)."""

    _default_config: Dict[str, Any] = {
        "env": None,
        "env_config": {},
        "num_workers": 4,          # concurrent fitness tasks
        "episodes_per_perturbation": 1,
        "num_perturbations": 16,   # antithetic pairs -> 2x evaluations
        "noise_std": 0.05,
        "lr": 0.02,
        "hidden": (32,),
        "seed": 0,
    }

    def __init__(self, config: Optional[dict] = None, env: Any = None):
        self.config = dict(self._default_config)
        self.config.update(config or {})
        if env is not None:
            self.config["env"] = env
        if self.config["env"] is None:
            raise ValueError("config['env'] is required")
        probe = make_env(self.config["env"], self.config["env_config"])
        self.sizes = _policy_sizes(probe.observation_dim,
                                   probe.num_actions,
                                   tuple(self.config["hidden"]))
        self._rng = np.random.default_rng(self.config["seed"])
        self.theta = self._rng.normal(
            scale=0.1, size=_num_params(self.sizes)).astype(np.float64)
        self._iteration = 0
        self._timesteps_total = 0
        self._fitness_task = ray_tpu_torch.remote(num_cpus=0.25)(rollout_fitness)

    # ------------------------------------------------------------- update
    def _evaluate(self, thetas: List[np.ndarray]) -> np.ndarray:
        """Fan fitness rollouts out as remote tasks, at most num_workers
        in flight (the reference's worker-fleet width, es.py Workers)."""
        eps = self.config["episodes_per_perturbation"]
        width = max(1, int(self.config["num_workers"]))
        seeds = self._rng.integers(2 ** 31, size=len(thetas))
        results: List[float] = [0.0] * len(thetas)
        in_flight: dict = {}
        i = 0
        while i < len(thetas) or in_flight:
            while i < len(thetas) and len(in_flight) < width:
                ref = self._fitness_task.remote(
                    thetas[i], self.sizes, self.config["env"],
                    self.config["env_config"], eps, int(seeds[i]))
                in_flight[ref] = i
                i += 1
            done, _ = ray_tpu_torch.wait(list(in_flight), num_returns=1,
                                   timeout=None)
            for ref in done:
                results[in_flight.pop(ref)] = ray_tpu_torch.get([ref])[0]
        return np.asarray(results, np.float64)

    def _step_direction(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        n = self.config["num_perturbations"]
        noise = self._rng.normal(size=(n, len(self.theta)))
        thetas = [self.theta + self.config["noise_std"] * e
                  for e in noise]
        thetas += [self.theta - self.config["noise_std"] * e
                   for e in noise]
        fitness = self._evaluate(thetas)
        return noise, fitness[:n], fitness[n:]

    def training_step(self) -> Dict[str, float]:
        noise, f_pos, f_neg = self._step_direction()
        n = len(noise)
        # centered-rank fitness shaping (reference: es/utils.py
        # compute_centered_ranks)
        all_f = np.concatenate([f_pos, f_neg])
        ranks = np.empty(len(all_f))
        ranks[np.argsort(all_f)] = np.arange(len(all_f))
        ranks = ranks / (len(all_f) - 1) - 0.5
        shaped = ranks[:n] - ranks[n:]
        grad = (shaped[:, None] * noise).mean(axis=0) \
            / self.config["noise_std"]
        self.theta = self.theta + self.config["lr"] * grad
        return {"fitness_mean": float(all_f.mean()),
                "fitness_max": float(all_f.max())}

    # --------------------------------------------------------- Trainable
    def train(self) -> Dict[str, Any]:
        t0 = time.perf_counter()
        stats = self.training_step()
        self._iteration += 1
        reward = self._evaluate([self.theta])[0]
        return {
            "training_iteration": self._iteration,
            "episode_reward_mean": float(reward),
            "time_this_iter_s": time.perf_counter() - t0,
            "info": {"learner": stats},
        }

    def compute_single_action(self, obs) -> int:
        return _act(self.theta, self.sizes, np.asarray(obs, np.float64))

    def save_checkpoint(self) -> dict:
        return {"theta": self.theta.copy(),
                "iteration": self._iteration}

    def restore(self, checkpoint: dict) -> None:
        self.theta = np.asarray(checkpoint["theta"]).copy()
        self._iteration = checkpoint["iteration"]

    def stop(self) -> None:
        pass


class ARSTrainer(ESTrainer):
    """Augmented random search (reference: agents/ars/ars.py): keep the
    top-k directions by max(f+, f-) and normalize the step by the std of
    their returns."""

    _default_config = {
        **ESTrainer._default_config,
        "top_directions": 8,
        "noise_std": 0.05,
        "lr": 0.02,
    }

    def training_step(self) -> Dict[str, float]:
        noise, f_pos, f_neg = self._step_direction()
        k = min(self.config["top_directions"], len(noise))
        best = np.argsort(np.maximum(f_pos, f_neg))[::-1][:k]
        f_p, f_n = f_pos[best], f_neg[best]
        sigma_r = np.concatenate([f_p, f_n]).std() + 1e-8
        grad = ((f_p - f_n)[:, None] * noise[best]).mean(axis=0)
        self.theta = self.theta + self.config["lr"] / sigma_r * grad
        all_f = np.concatenate([f_pos, f_neg])
        return {"fitness_mean": float(all_f.mean()),
                "fitness_max": float(all_f.max()),
                "sigma_r": float(sigma_r)}
