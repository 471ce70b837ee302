"""Built-in environments (pure numpy, no gym dependency).

Reference: rllib/env/ (VectorEnv, MultiAgentEnv wrappers). The env API
is gym-classic: reset() -> obs, step(a) -> (obs, reward, done, info).
CartPole uses the standard Barto-Sutton-Anderson dynamics; StatelessGuess
is a one-step env where the optimal policy is learnable in seconds (used
by tests as a fast learning-progress oracle).
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import numpy as np


class Env:
    observation_dim: int = 0
    num_actions: int = 0

    def reset(self) -> np.ndarray:
        raise NotImplementedError

    def step(self, action: int) -> Tuple[np.ndarray, float, bool, dict]:
        raise NotImplementedError

    def seed(self, seed: int) -> None:
        self._rng = np.random.default_rng(seed)


class CartPoleEnv(Env):
    """Classic cart-pole balancing, 200-step episodes."""

    observation_dim = 4
    num_actions = 2

    def __init__(self, max_steps: int = 200, seed: Optional[int] = None):
        self.max_steps = max_steps
        self._rng = np.random.default_rng(seed)
        self._state = None
        self._t = 0

    def reset(self) -> np.ndarray:
        self._state = self._rng.uniform(-0.05, 0.05, size=4)
        self._t = 0
        return self._state.astype(np.float32)

    def step(self, action: int):
        x, x_dot, theta, theta_dot = self._state
        force = 10.0 if action == 1 else -10.0
        gravity, masscart, masspole = 9.8, 1.0, 0.1
        total_mass = masscart + masspole
        length = 0.5
        polemass_length = masspole * length
        tau = 0.02
        costheta, sintheta = np.cos(theta), np.sin(theta)
        temp = (force + polemass_length * theta_dot ** 2 * sintheta
                ) / total_mass
        thetaacc = (gravity * sintheta - costheta * temp) / (
            length * (4.0 / 3.0 - masspole * costheta ** 2 / total_mass))
        xacc = temp - polemass_length * thetaacc * costheta / total_mass
        x = x + tau * x_dot
        x_dot = x_dot + tau * xacc
        theta = theta + tau * theta_dot
        theta_dot = theta_dot + tau * thetaacc
        self._state = np.array([x, x_dot, theta, theta_dot])
        self._t += 1
        done = bool(abs(x) > 2.4 or abs(theta) > 0.2095
                    or self._t >= self.max_steps)
        return self._state.astype(np.float32), 1.0, done, {}


class StatelessGuessEnv(Env):
    """One-step env: obs is a random one-hot; reward 1 iff the action
    matches the hot index. Optimal return = 1.0; random = 1/num_actions."""

    def __init__(self, num_actions: int = 4, seed: Optional[int] = None):
        self.num_actions = num_actions
        self.observation_dim = num_actions
        self._rng = np.random.default_rng(seed)
        self._target = 0

    def reset(self) -> np.ndarray:
        self._target = int(self._rng.integers(self.num_actions))
        obs = np.zeros(self.num_actions, dtype=np.float32)
        obs[self._target] = 1.0
        return obs

    def step(self, action: int):
        reward = 1.0 if int(action) == self._target else 0.0
        return self.reset(), reward, True, {}


class PendulumEnv(Env):
    """Classic torque-limited pendulum swing-up — the canonical
    continuous-control env (reference: rllib continuous-action agents
    train on Pendulum-v1). obs = (cos th, sin th, thdot); one torque
    action in [-2, 2]; reward = -(th^2 + 0.1 thdot^2 + 0.001 u^2)."""

    observation_dim = 3
    num_actions = 1  # action_dim alias for policy sizing
    action_dim = 1
    action_low = -2.0
    action_high = 2.0

    def __init__(self, max_steps: int = 200, seed: Optional[int] = None):
        self.max_steps = max_steps
        self._rng = np.random.default_rng(seed)
        self._th = 0.0
        self._thdot = 0.0
        self._t = 0

    def _obs(self) -> np.ndarray:
        return np.array([np.cos(self._th), np.sin(self._th),
                         self._thdot], dtype=np.float32)

    def reset(self) -> np.ndarray:
        self._th = float(self._rng.uniform(-np.pi, np.pi))
        self._thdot = float(self._rng.uniform(-1.0, 1.0))
        self._t = 0
        return self._obs()

    def step(self, action):
        u = float(np.clip(np.asarray(action).reshape(-1)[0],
                          self.action_low, self.action_high))
        g, m, length, dt = 10.0, 1.0, 1.0, 0.05
        th, thdot = self._th, self._thdot
        norm_th = ((th + np.pi) % (2 * np.pi)) - np.pi
        cost = norm_th ** 2 + 0.1 * thdot ** 2 + 0.001 * u ** 2
        thdot = thdot + (3 * g / (2 * length) * np.sin(th)
                         + 3.0 / (m * length ** 2) * u) * dt
        thdot = float(np.clip(thdot, -8.0, 8.0))
        th = th + thdot * dt
        self._th, self._thdot = th, thdot
        self._t += 1
        done = self._t >= self.max_steps
        return self._obs(), -float(cost), done, {}


class LinearBanditEnv(Env):
    """Contextual linear bandit: obs is a random context x; pulling arm a
    pays theta_a . x + noise. One-step episodes (reference:
    rllib/env/bandit_envs discrete linear payoff envs)."""

    def __init__(self, context_dim: int = 8, num_arms: int = 4,
                 noise: float = 0.05, seed: Optional[int] = None):
        self.observation_dim = context_dim
        self.num_actions = num_arms
        self.noise = noise
        self._rng = np.random.default_rng(seed)
        thetas = self._rng.normal(size=(num_arms, context_dim))
        self._thetas = thetas / np.linalg.norm(thetas, axis=1,
                                               keepdims=True)
        self._x = None

    def reset(self) -> np.ndarray:
        x = self._rng.normal(size=self.observation_dim)
        self._x = (x / np.linalg.norm(x)).astype(np.float32)
        return self._x

    def best_reward(self) -> float:
        return float(np.max(self._thetas @ self._x))

    def step(self, action: int):
        payoff = float(self._thetas[int(action)] @ self._x
                       + self._rng.normal(scale=self.noise))
        return self.reset(), payoff, True, {}


ENV_REGISTRY = {
    "CartPole-v1": CartPoleEnv,
    "StatelessGuess": StatelessGuessEnv,
    "Pendulum-v1": PendulumEnv,
    "LinearBandit": LinearBanditEnv,
}


def make_env(env: Any, env_config: Optional[dict] = None) -> Env:
    env_config = env_config or {}
    if isinstance(env, str):
        return ENV_REGISTRY[env](**env_config)
    if isinstance(env, type):
        return env(**env_config)
    if callable(env):
        return env(env_config)
    raise ValueError(f"cannot construct env from {env!r}")
