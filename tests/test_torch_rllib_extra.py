"""The port's second wave of RLlib algorithms against the JAX package's,
on the CPU: the 21 scenarios of tests/test_rllib_extra.py on the port,
with the reference's thresholds and iteration budgets (PG, offline
BC/MARWIL from JSON, bandits, DDPG/TD3, ES/ARS, multi-agent,
QMIX/VDN, continuous SAC, CQL, A3C), and the policies of policy_pg.py
and policy_continuous.py and the QMIX/VDN networks held against the JAX
ones.

Parity, as in test_torch_rllib.py: the JAX side's weights go into the
port's; the same seeded batch; the forward within FWD_RTOL; three
updates' stats within STATS_RTOL and weights within WEIGHTS_REL_L2.
Continuous SAC and CQL take the noise that the JAX policy's key schedule
draws (``PRNGKey(seed + 1)``, split once per update into k1, k2, k3);
DDPG/TD3's noise is numpy on both sides. Every port policy and QMIX
trainer runs with ``"device": "cpu"``.
"""

import jax
import numpy as np
import pytest
import torch

import ray_tpu.rllib as jrl
import ray_tpu_torch
import ray_tpu_torch.rllib as trl
from ray_tpu.rllib import policy_continuous as jcont
from ray_tpu.rllib import policy_pg as jpg
from ray_tpu_torch.rllib import (
    ARSTrainer,
    BCTrainer,
    DDPGTrainer,
    ESTrainer,
    JsonReader,
    JsonWriter,
    LinearBanditEnv,
    LinTSTrainer,
    LinUCBTrainer,
    MARWILTrainer,
    PendulumEnv,
    PGTrainer,
    SampleBatch,
    StatelessGuessEnv,
    TD3Trainer,
    collect_episodes,
)
from ray_tpu_torch.rllib import policy as tpolicy
from ray_tpu_torch.rllib import policy_continuous as tcont
from ray_tpu_torch.rllib import policy_pg as tpg
from ray_tpu_torch.rllib import sample_batch as sb
from ray_tpu_torch.rllib.env import Env

CPU = {"device": "cpu"}
# float32 on both sides, apart by summation order (see
# test_torch_rllib.py): the forward, then three adam steps
FWD_RTOL, FWD_ATOL = 1e-5, 1e-6
STATS_RTOL, STATS_ATOL = 1e-4, 1e-6
WEIGHTS_REL_L2 = 1e-4
# continuous SAC and CQL: the squashed Gaussian's log-prob takes
# log(1 - tanh(u)^2), which cancels catastrophically as |u| grows. XLA's
# and ATen's float32 tanh differ by up to 2 ulps (on 59 % of 1e5 seeded
# normals at scale 4), which moves log(1 - a^2) by up to 0.29 there; the
# soft targets carry that into the critic's gradients. Measured on the
# seeded batch below: stats 6.5e-4, weights 3.7e-4 after three updates
SQUASHED_RTOL = 2e-3


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """RLlib runs thousands of tiny torch ops; with the test runner's
    worker processes side by side, torch's intra-op thread pools
    oversubscribe the cores and spin (4x slower under -n 4)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture
def torch_init():
    rt = ray_tpu_torch.init(num_cpus=8, device="cpu")
    yield rt
    ray_tpu_torch.shutdown()


def assert_weights_close(got, want, rel_l2=WEIGHTS_REL_L2):
    """Same tree structure, shapes and dtypes; each leaf's relative L2
    within ``rel_l2``."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and sorted(got) == sorted(want)
        for k in want:
            assert_weights_close(got[k], want[k], rel_l2)
        return
    if isinstance(want, (list, tuple)):
        assert type(got) is type(want) and len(got) == len(want)
        for g, w in zip(got, want):
            assert_weights_close(g, w, rel_l2)
        return
    want = np.asarray(want)
    assert isinstance(got, np.ndarray) and got.dtype == want.dtype == \
        np.float32 and got.shape == want.shape
    err = np.linalg.norm(got - want)
    assert err <= rel_l2 * max(np.linalg.norm(want), 1e-6), (err, want)


def assert_stats_close(got, want, rtol=STATS_RTOL):
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k] == pytest.approx(want[k], rel=rtol,
                                       abs=STATS_ATOL), k


# ------------------------------------------------------------------ envs


def test_pendulum_env_contract():
    env = PendulumEnv(seed=0)
    obs = env.reset()
    assert obs.shape == (3,)
    obs, r, done, _ = env.step(np.array([0.5]))
    assert obs.shape == (3,) and r <= 0.0 and not done
    # out-of-range torque is clipped, not an error
    env.step(np.array([99.0]))


def test_linear_bandit_env_contract():
    env = LinearBanditEnv(context_dim=4, num_arms=3, seed=0)
    obs = env.reset()
    assert obs.shape == (4,)
    _, r, done, _ = env.step(1)
    assert done  # one-step episodes


# -------------------------------------------------------------------- PG


def test_pg_learns_stateless_guess(torch_init):
    trainer = PGTrainer({
        "env": StatelessGuessEnv,
        "num_workers": 2,
        "train_batch_size": 512,
        "policy_config": {"seed": 0, "lr": 2e-2, **CPU},
        "env_config": {"num_actions": 4, "seed": 1},
    })
    result = None
    for _ in range(15):
        result = trainer.train()
    trainer.stop()
    assert result["episode_reward_mean"] > 0.6, result


# -------------------------------------------------------- offline IO + BC


class _OracleGuessPolicy:
    """Perfect StatelessGuess expert: the obs IS the one-hot answer."""

    def compute_actions(self, obs):
        return np.array([int(np.argmax(obs))]), {}


def test_json_writer_reader_roundtrip(tmp_path):
    path = str(tmp_path / "data.json")
    w = JsonWriter(path)
    env = StatelessGuessEnv(num_actions=4, seed=0)
    batch = collect_episodes(env, _OracleGuessPolicy(), 64, writer=w)
    w.write(batch)  # two rows total
    w.close()
    batches = list(JsonReader(path))
    assert len(batches) == 2
    assert batches[0].count == 64
    np.testing.assert_array_equal(np.asarray(batches[0][sb.ACTIONS]),
                                  np.asarray(batch[sb.ACTIONS]))
    # reader.next() cycles forever
    r = JsonReader(path)
    assert r.next().count == 64 and r.next().count == 64
    assert r.next().count == 64
    # the JAX package reads the port's file row for row
    for got, want in zip(batches, jrl.JsonReader(path)):
        for k in want:
            np.testing.assert_array_equal(np.asarray(got[k]),
                                          np.asarray(want[k]))


def test_bc_clones_expert_from_offline_data(torch_init, tmp_path):
    path = str(tmp_path / "expert.json")
    w = JsonWriter(path)
    env = StatelessGuessEnv(num_actions=4, seed=0)
    for ep in range(4):
        collect_episodes(env, _OracleGuessPolicy(), 256, writer=w,
                         seed=ep)
    w.close()
    trainer = BCTrainer({
        "env": StatelessGuessEnv,
        "num_workers": 1,
        "input": path,
        "sgd_steps_per_iter": 24,
        "policy_config": {"seed": 0, "lr": 1e-2, **CPU},
        "env_config": {"num_actions": 4, "seed": 3},
    })
    result = None
    for _ in range(6):
        result = trainer.train()
    trainer.stop()
    # behavior cloning of a perfect expert: near-perfect play
    assert result["episode_reward_mean"] > 0.8, result


def test_marwil_beats_mediocre_data(torch_init, tmp_path):
    """MARWIL's advantage weighting upweights the good actions inside a
    mixed-quality dataset (reference: marwil learning tests)."""

    class _Mixed:
        """50% expert / 50% random behavior."""

        def __init__(self):
            self._rng = np.random.default_rng(0)

        def compute_actions(self, obs):
            if self._rng.random() < 0.5:
                return np.array([int(np.argmax(obs))]), {}
            return np.array([int(self._rng.integers(len(obs)))]), {}

    path = str(tmp_path / "mixed.json")
    w = JsonWriter(path)
    env = StatelessGuessEnv(num_actions=4, seed=0)
    for ep in range(4):
        collect_episodes(env, _Mixed(), 256, writer=w, seed=ep)
    w.close()
    trainer = MARWILTrainer({
        "env": StatelessGuessEnv,
        "num_workers": 1,
        "input": path,
        "sgd_steps_per_iter": 24,
        "policy_config": {"seed": 0, "lr": 1e-2, "beta": 2.0, **CPU},
        "env_config": {"num_actions": 4, "seed": 3},
    })
    result = None
    for _ in range(8):
        result = trainer.train()
    trainer.stop()
    # the data's own hit-rate is ~0.625; weighting must beat imitation
    assert result["episode_reward_mean"] > 0.7, result


# ----------------------------------------------------------------- bandits


@pytest.mark.parametrize("cls", [LinUCBTrainer, LinTSTrainer])
def test_linear_bandits_learn(torch_init, cls):
    trainer = cls({
        "env": LinearBanditEnv,
        "num_workers": 1,
        "rollout_fragment_length": 64,
        "train_batch_size": 64,
        "policy_config": {"seed": 0},
        "env_config": {"context_dim": 6, "num_arms": 4, "seed": 5,
                       "noise": 0.02},
    })
    result = None
    for _ in range(8):
        result = trainer.train()
    trainer.stop()
    # unit-norm thetas/contexts: random play ~0; the best arm averages
    # clearly positive payoff
    assert result["episode_reward_mean"] > 0.25, result
    assert result["info"]["learner"]["mse"] < 0.05, result


# ----------------------------------------------------- continuous control


class _TargetEnv(Env):
    """One-step continuous oracle: reward = -(a - 0.5)^2. The optimal
    deterministic policy emits 0.5 everywhere — learnable in seconds."""

    observation_dim = 2
    num_actions = 1
    action_dim = 1
    action_low = -1.0
    action_high = 1.0

    def __init__(self, seed=None):
        self._rng = np.random.default_rng(seed)

    def reset(self):
        return self._rng.normal(size=2).astype(np.float32)

    def step(self, action):
        a = float(np.asarray(action).reshape(-1)[0])
        return self.reset(), -((a - 0.5) ** 2), True, {}


@pytest.mark.parametrize("cls", [DDPGTrainer, TD3Trainer])
def test_continuous_trainers_learn_target(torch_init, cls):
    trainer = cls({
        "env": _TargetEnv,
        "num_workers": 1,
        "rollout_fragment_length": 128,
        "learning_starts": 128,
        "sgd_batch_size": 64,
        "sgd_steps_per_iter": 32,
        "policy_config": {"seed": 0, "noise_scale": 0.2,
                          "actor_l2": 0.05, **CPU},
    })
    result = None
    for _ in range(10):
        result = trainer.train()
    # actions respect bounds
    policy = trainer.get_policy()
    acts, _ = policy.compute_actions(np.zeros((8, 2), np.float32))
    assert np.all(acts >= -1.0) and np.all(acts <= 1.0)
    trainer.stop()
    # random in [-1,1]: mean reward ~ -0.58; learned: close to 0
    assert result["episode_reward_mean"] > -0.15, result


def test_pendulum_ddpg_mechanics(torch_init):
    """Full Pendulum path: bounds flow env->policy, replay learning steps
    run, checkpoints round-trip."""
    trainer = DDPGTrainer({
        "env": "Pendulum-v1",
        "num_workers": 1,
        "rollout_fragment_length": 64,
        "learning_starts": 64,
        "sgd_batch_size": 32,
        "sgd_steps_per_iter": 4,
        "policy_config": {"seed": 0, **CPU},
    })
    r1 = trainer.train()
    assert "critic_loss" in r1["info"]["learner"]
    ckpt = trainer.save_checkpoint()
    policy = trainer.get_policy()
    acts, _ = policy.compute_actions(np.zeros((4, 3), np.float32))
    assert np.all(np.abs(acts) <= 2.0)  # Pendulum bounds reached policy
    trainer.restore(ckpt)
    trainer.stop()


# ------------------------------------------------------------------ ES/ARS


@pytest.mark.parametrize("cls", [ESTrainer, ARSTrainer])
def test_evolution_learns_stateless_guess(torch_init, cls):
    trainer = cls({
        "env": StatelessGuessEnv,
        "env_config": {"num_actions": 4, "seed": 7},
        "num_perturbations": 12,
        "episodes_per_perturbation": 8,
        "noise_std": 0.1,
        "lr": 0.1,
        "hidden": (),
        "seed": 0,
    })
    result = None
    for _ in range(15):
        result = trainer.train()
    # ES on a one-hot oracle: linear policy solves it outright
    assert result["episode_reward_mean"] > 0.6, result
    # checkpoint round trip preserves theta
    ckpt = trainer.save_checkpoint()
    theta = trainer.theta.copy()
    trainer.theta += 1.0
    trainer.restore(ckpt)
    np.testing.assert_array_equal(trainer.theta, theta)
    trainer.stop()


# -------------------------------------------------------------- multi-agent


def test_multi_agent_independent_policies_learn(torch_init):
    """Two agents with independent PG policies each learn their own
    target (reference: rllib multiagent `policies` + policy_mapping_fn)."""
    from ray_tpu_torch.rllib import MultiAgentTrainer, PGPolicy
    from ray_tpu_torch.rllib import TwoStepGuessEnv

    trainer = MultiAgentTrainer({
        "env": TwoStepGuessEnv,
        "env_config": {"num_actions": 3, "seed": 2},
        "num_workers": 2,
        "train_batch_size": 256,
        "policies": {
            "p0": (PGPolicy, {"lr": 2e-2, **CPU}),
            "p1": (PGPolicy, {"lr": 2e-2, **CPU}),
        },
        "policy_mapping_fn": lambda aid: "p0" if aid == "a0" else "p1",
    })
    result = None
    for _ in range(15):
        result = trainer.train()
    trainer.stop()
    # random: per-agent ~1/3 hit + rare bonus ~ 0.39; learned: ~1.5
    assert result["episode_reward_mean"] > 1.0, result
    assert set(result["info"]["learner"]) == {"p0", "p1"}


def test_multi_agent_shared_policy(torch_init):
    """Both agents map onto ONE policy (parameter sharing) and still
    solve the env; checkpoints round-trip."""
    from ray_tpu_torch.rllib import MultiAgentTrainer, PGPolicy
    from ray_tpu_torch.rllib import TwoStepGuessEnv

    trainer = MultiAgentTrainer({
        "env": TwoStepGuessEnv,
        "env_config": {"num_actions": 3, "seed": 4},
        "num_workers": 2,
        "train_batch_size": 256,
        "policies": {"shared": (PGPolicy, {"lr": 2e-2, **CPU})},
        # default mapping: every agent -> the single policy
    })
    result = None
    for _ in range(15):
        result = trainer.train()
    assert result["episode_reward_mean"] > 1.0, result
    ckpt = trainer.save_checkpoint()
    trainer.restore(ckpt)
    policy = trainer.get_policy("shared")
    obs = np.eye(3, dtype=np.float32)[1]
    acts, _ = policy.compute_actions(obs)
    assert acts.shape == (1,)
    trainer.stop()


def test_multi_agent_trajectories_do_not_interleave():
    """Each agent's rows reach postprocess_trajectory as ONE contiguous
    trajectory — interleaving would bleed one agent's rewards into the
    other's returns on multi-step episodes."""
    from ray_tpu_torch.rllib import MultiAgentEnv
    from ray_tpu_torch.rllib.multi_agent import MultiAgentRolloutWorker

    class TwoStep(MultiAgentEnv):
        agent_ids = ("a0", "a1")
        observation_dim = 1
        num_actions = 2

        def __init__(self):
            self._t = 0

        def reset(self):
            self._t = 0
            return {a: np.zeros(1, np.float32) for a in self.agent_ids}

        def step(self, actions):
            self._t += 1
            done = self._t >= 2
            rewards = {"a0": 1.0, "a1": 100.0}  # very different scales
            dones = {a: done for a in self.agent_ids}
            dones["__all__"] = done
            obs = self.reset() if done else {
                a: np.zeros(1, np.float32) for a in self.agent_ids}
            return obs, rewards, dones, {a: {} for a in self.agent_ids}

    seen = []

    class Probe:
        def __init__(self, obs_dim, num_actions, cfg):
            pass

        def compute_actions(self, obs):
            return np.array([0]), {}

        def postprocess_trajectory(self, batch):
            seen.append(np.asarray(batch[sb.REWARDS]).tolist())
            return batch

    worker = MultiAgentRolloutWorker(
        TwoStep, {"shared": (Probe, {})}, lambda aid: "shared")
    worker.sample(4)  # two 2-step episodes
    # every postprocessed trajectory is single-agent: homogeneous rewards
    assert seen and all(len(set(r)) == 1 for r in seen), seen
    scales = {r[0] for r in seen}
    assert scales == {1.0, 100.0}, seen


@pytest.mark.parametrize("cls_name", ["QMixTrainer", "VDNTrainer"])
def test_value_decomposition_solves_two_step_game(cls_name):
    """The QMIX paper's two-step game: the safe branch pays 7, the
    coordinated branch pays 8. Centralized value decomposition must
    find the 8 (reference: rllib/agents/qmix learning tests)."""
    cls = getattr(trl, cls_name)
    trainer = cls({
        "env": trl.TwoStepCoopEnv,
        "env_config": {"seed": 3},
        "seed": 0,
        "lr": 5e-3,
        "epsilon_decay": 0.999,
        **CPU,
    })
    for _ in range(30):
        trainer.train()
    # greedy evaluation: play 5 episodes with exploration off
    env = trl.TwoStepCoopEnv(seed=99)
    returns = []
    for _ in range(5):
        obs = env.reset()
        total, done = 0.0, False
        while not done:
            actions = trainer.greedy_actions(obs)
            obs, rewards, dones, _ = env.step(actions)
            total += float(np.mean(list(rewards.values())))
            done = dones["__all__"]
        returns.append(total)
    trainer.stop()
    assert np.mean(returns) >= 7.5, returns  # found the coordinated 8
    ckpt = trainer.save_checkpoint()
    trainer.restore(ckpt)


def test_continuous_sac_learns_target(torch_init):
    """Continuous SAC (squashed Gaussian + twin soft-Q + learned
    temperature) solves the one-step continuous oracle."""
    trainer = trl.SACContinuousTrainer({
        "env": _TargetEnv,
        "num_workers": 1,
        "rollout_fragment_length": 128,
        "learning_starts": 128,
        "sgd_batch_size": 64,
        "sgd_steps_per_iter": 64,
        "policy_config": {"seed": 0, "actor_lr": 1e-3,
                          "critic_lr": 1e-3, "alpha_lr": 1e-3, **CPU},
    })
    result = None
    for _ in range(25):
        result = trainer.train()
    policy = trainer.get_policy()
    greedy = policy.greedy_actions(np.zeros((4, 2), np.float32))
    trainer.stop()
    assert np.all(np.abs(greedy) <= 1.0)
    # the mean action converges near the optimum 0.5 and the reward
    # climbs toward it (random play in [-1,1] averages ~ -0.58)
    assert abs(float(greedy.mean()) - 0.5) < 0.25, greedy
    assert result["episode_reward_mean"] > -0.12, result
    assert result["info"]["learner"]["alpha"] < 0.1  # temp annealed


def test_cql_learns_from_offline_random_data(torch_init, tmp_path):
    """CQL recovers a near-optimal policy from a RANDOM-behavior offline
    dataset (the setting it exists for): the conservative penalty keeps
    Q honest on out-of-distribution actions."""

    class _RandomCont:
        def __init__(self):
            self._rng = np.random.default_rng(0)

        def compute_actions(self, obs):
            return self._rng.uniform(-1, 1, size=(1, 1)), {}

    path = str(tmp_path / "cont.json")
    w = JsonWriter(path)
    env = _TargetEnv(seed=0)
    for ep in range(4):
        collect_episodes(env, _RandomCont(), 256, writer=w, seed=ep)
    w.close()

    trainer = trl.CQLTrainer({
        "env": _TargetEnv,
        "num_workers": 1,
        "input": path,
        "sgd_batch_size": 64,
        "sgd_steps_per_iter": 64,
        "policy_config": {"seed": 0, "actor_lr": 1e-3,
                          "critic_lr": 1e-3, "alpha_lr": 1e-3,
                          "min_q_weight": 0.5, **CPU},
    })
    result = None
    for _ in range(20):
        result = trainer.train()
    policy = trainer.get_policy()
    greedy = policy.greedy_actions(np.zeros((4, 2), np.float32))
    trainer.stop()
    assert "cql_penalty" in result["info"]["learner"]
    # random behavior averages ~ -0.58; the recovered policy is close
    # to the optimum 0.5
    assert abs(float(greedy.mean()) - 0.5) < 0.3, greedy
    assert result["episode_reward_mean"] > -0.2, result


def test_a3c_async_gradients_learn(torch_init):
    """A3C's async execution plan: workers compute gradients with
    (possibly stale) weights, the learner applies on wait-any and ships
    weights back to that worker only (reference: agents/a3c AsyncGradients)."""
    trainer = trl.A3CTrainer({
        "env": StatelessGuessEnv,
        "num_workers": 2,
        "rollout_fragment_length": 64,
        "grads_per_iter": 16,
        "policy_config": {"seed": 0, "lr": 5e-3, **CPU},
        "env_config": {"num_actions": 4, "seed": 1},
    })
    result = None
    for _ in range(15):
        result = trainer.train()
    assert result["grads_applied_total"] >= 15 * 16
    ckpt = trainer.save_checkpoint()
    trainer.restore(ckpt)
    trainer.stop()
    # random = 0.25; the async learner must clearly beat it
    assert result["episode_reward_mean"] > 0.6, result


# ------------------------------------------------------ parity with JAX


def parity_batch(n, obs_dim, num_actions, seed, continuous=False):
    rng = np.random.default_rng(seed)
    actions = (rng.uniform(-1, 1, (n, num_actions)).astype(np.float32)
               if continuous else rng.integers(num_actions, size=n))
    return SampleBatch({
        sb.OBS: rng.normal(size=(n, obs_dim)).astype(np.float32),
        sb.ACTIONS: actions,
        sb.REWARDS: rng.normal(size=n).astype(np.float32),
        sb.NEXT_OBS: rng.normal(size=(n, obs_dim)).astype(np.float32),
        sb.DONES: rng.random(n) < 0.2,
        sb.RETURNS: rng.normal(size=n).astype(np.float32),
    })


def _copy(batch):
    return SampleBatch({k: np.array(v) for k, v in batch.items()})


def jax_sac_noise(seed, batch_size, action_dim, steps, n_rand=0,
                  low=-1.0, high=1.0):
    """The noise a JAX ContinuousSACPolicy/CQLPolicy draws in its first
    ``steps`` updates (policy_continuous.py:239, :287, :344, :402), as
    the port's ``learn_on_batch(noise=...)`` takes it."""
    key = jax.random.PRNGKey(seed + 1)
    out = []
    for _ in range(steps):
        key, sub = jax.random.split(key)
        k1, k2, k3 = jax.random.split(sub, 3)
        noise = {"next": jax.random.normal(k1, (batch_size, action_dim)),
                 "pi": jax.random.normal(k2, (batch_size, action_dim))}
        if n_rand:
            noise["rand"] = jax.random.uniform(
                k3, (batch_size, n_rand, action_dim), minval=low,
                maxval=high)
        out.append({k: torch.tensor(np.asarray(v))
                    for k, v in noise.items()})
    return out


OBS_DIM, NUM_ACTIONS, ACTION_DIM, N = 5, 3, 2, 40

PARITY = {
    "pg": (jpg.PGPolicy, tpg.PGPolicy, {"seed": 3, "lr": 1e-2,
                                        "hidden": (16, 8)}),
    "marwil": (jpg.MARWILPolicy, tpg.MARWILPolicy,
               {"seed": 3, "lr": 1e-2, "beta": 1.5, "ma_lr": 0.1,
                "hidden": (16, 8)}),
    "bc": (jpg.MARWILPolicy, tpg.MARWILPolicy,
           {"seed": 4, "lr": 1e-2, "beta": 0.0, "hidden": (16,)}),
    "ddpg": (jcont.DDPGPolicy, tcont.DDPGPolicy,
             {"seed": 3, "actor_lr": 1e-2, "critic_lr": 1e-2, "tau": 0.1,
              "hidden": (16, 8), "action_low": -2.0, "action_high": 2.0}),
    "td3": (jcont.TD3Policy, tcont.TD3Policy,
            {"seed": 3, "actor_lr": 1e-2, "critic_lr": 1e-2, "tau": 0.1,
             "hidden": (16, 8)}),
    "sac_continuous": (jcont.ContinuousSACPolicy, tcont.ContinuousSACPolicy,
                       {"seed": 3, "actor_lr": 1e-2, "critic_lr": 1e-2,
                        "alpha_lr": 1e-2, "tau": 0.1, "hidden": (16, 8),
                        "action_low": -2.0, "action_high": 1.0}),
    "cql": (jcont.CQLPolicy, tcont.CQLPolicy,
            {"seed": 3, "actor_lr": 1e-2, "critic_lr": 1e-2,
             "alpha_lr": 1e-2, "tau": 0.1, "hidden": (16, 8),
             "min_q_weight": 0.5, "num_cql_actions": 4}),
}


def _forward(name, p, obs):
    """What the policy computes before any noise, as numpy."""
    port = isinstance(p, tpolicy.Policy)
    if name in ("sac_continuous", "cql"):
        return p.greedy_actions(obs)
    if port:
        return p._forward(torch.as_tensor(obs)).numpy()
    return np.asarray(p._forward(p.params, obs))


@pytest.mark.parametrize("name", sorted(PARITY))
def test_policy_parity_with_jax(name):
    jcls, tcls, cfg = PARITY[name]
    continuous = name not in ("pg", "marwil", "bc")
    width = ACTION_DIM if continuous else NUM_ACTIONS
    jp = jcls(OBS_DIM, width, cfg)
    tp = tcls(OBS_DIM, width, {**cfg, **CPU})
    tp.set_weights(jp.get_weights())
    assert_weights_close(tp.get_weights(), jp.get_weights(), 0.0)
    obs = np.random.default_rng(1).normal(
        size=(N, OBS_DIM)).astype(np.float32)
    np.testing.assert_allclose(_forward(name, tp, obs),
                               _forward(name, jp, obs),
                               rtol=FWD_RTOL, atol=FWD_ATOL)
    batch = parity_batch(N, OBS_DIM, width, seed=2, continuous=continuous)
    if continuous:
        batch[sb.ACTIONS] = batch[sb.ACTIONS] * tp._scale + tp._mid
    noises, rtol = [None] * 3, STATS_RTOL
    if name in ("sac_continuous", "cql"):
        noises = jax_sac_noise(
            cfg["seed"], N, ACTION_DIM, 3, cfg.get("num_cql_actions", 0),
            tp._mid - tp._scale, tp._mid + tp._scale)
        rtol = SQUASHED_RTOL
    for noise in noises:
        want = jp.learn_on_batch(_copy(batch))
        got = (tp.learn_on_batch(_copy(batch)) if noise is None
               else tp.learn_on_batch(_copy(batch), noise=noise))
        assert_stats_close(got, want, rtol)
    assert_weights_close(tp.get_weights(), jp.get_weights(),
                         max(rtol, WEIGHTS_REL_L2))


def test_sac_noise_comes_from_the_policy_generator():
    """Without ``noise=`` the port draws from its own generator (seeded
    with seed + 1): two policies of one seed update alike, and a draw is
    [B, action_dim] for ``next``/``pi`` and [B, N, action_dim] inside the
    action range for CQL's ``rand``."""
    cfg = {"seed": 5, "hidden": (8,), "num_cql_actions": 3,
           "action_low": -2.0, "action_high": 1.0, **CPU}
    a, b = tcont.CQLPolicy(3, 2, cfg), tcont.CQLPolicy(3, 2, cfg)
    noise = a.draw_noise(7)
    assert noise["next"].shape == noise["pi"].shape == (7, 2)
    assert noise["rand"].shape == (7, 3, 2)
    assert float(noise["rand"].min()) >= -2.0
    assert float(noise["rand"].max()) < 1.0
    b.draw_noise(7)
    batch = parity_batch(16, 3, 2, seed=9, continuous=True)
    assert a.learn_on_batch(_copy(batch)) == b.learn_on_batch(_copy(batch))


def _qmix_pair(mixer):
    cfg = {"env": jrl.TwoStepCoopEnv, "mixer": mixer, "seed": 2,
           "lr": 1e-2, "hidden": (16,), "mixer_hidden": 8,
           "sgd_batch_size": 32, "sgd_steps_per_iter": 3,
           "rollout_steps_per_iter": 64, "target_update_freq": 2}
    jt = jrl.QMixTrainer(cfg)
    tt = trl.QMixTrainer({**cfg, "env": trl.TwoStepCoopEnv, **CPU})
    tt.restore(jt.save_checkpoint())
    return jt, tt


@pytest.mark.parametrize("mixer", ["qmix", "vdn"])
def test_qmix_networks_parity_with_jax(mixer):
    """The agent Q-net and the mixer: the TD loss of one seeded joint
    batch, then three training steps (the same rollouts, replay draws
    and updates on both sides: numpy RNGs of one seed, greedy actions of
    equal Q-nets)."""
    jt, tt = _qmix_pair(mixer)
    assert_weights_close(tt.save_checkpoint()["params"],
                         jt.save_checkpoint()["params"], 0.0)
    rng = np.random.default_rng(3)
    b = 24
    obs = rng.normal(size=(b, 2, 3)).astype(np.float32)
    next_obs = rng.normal(size=(b, 2, 3)).astype(np.float32)
    actions = rng.integers(2, size=(b, 2)).astype(np.int32)
    rewards = rng.normal(size=b).astype(np.float32)
    dones = (rng.random(b) < 0.5).astype(np.float32)
    _, _, want = jt._update(jt.params, jt.target, jt.opt_state, obs,
                            actions, rewards, dones, next_obs,
                            obs.reshape(b, -1), next_obs.reshape(b, -1))
    got = tt.td_loss(tt.params, *(torch.as_tensor(x) for x in (
        obs, actions.astype(np.int64), rewards, dones, next_obs)))
    assert float(got.detach()) == pytest.approx(float(want), rel=FWD_RTOL)
    for _ in range(3):
        assert_stats_close(tt.train()["info"]["learner"],
                           jt.train()["info"]["learner"])
    assert_weights_close(tt.save_checkpoint()["params"],
                         jt.save_checkpoint()["params"])
    state = {a: np.eye(3, dtype=np.float32)[2] for a in jt.agent_ids}
    assert tt.greedy_actions(state) == jt.greedy_actions(state)
