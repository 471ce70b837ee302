"""The port's ray_tpu_torch.rllib against the JAX package's ray_tpu.rllib
on the CPU: the 13 scenarios of tests/test_rllib.py on the port, with
the reference's thresholds and iteration budgets, and the policies of
policy.py and policy_extra.py held against the JAX ones.

- Parity: the JAX policy's ``get_weights()`` goes into the port's
  ``set_weights``; both get the same seeded numpy batch. The forward
  (logits, values, Q) agrees to FWD_RTOL; after three
  ``learn_on_batch`` calls the returned stats agree to STATS_RTOL and
  every weight leaf to WEIGHTS_REL_L2 (float32 on both sides, apart by
  summation order, compounded through three adam steps).
- ``vtrace`` equals the JAX function on seeded fragments with dones.
- Acting: the same weights and seed give the same actions on 200
  seeded observations (PPO's Gumbel-max, DQN's epsilon-greedy).
- A JAX trainer's ``save_checkpoint()`` restores into the port's
  trainer; then their actions agree on 100 observations.

Every port policy runs with ``"device": "cpu"``.
"""

import contextlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ray_tpu
import ray_tpu.rllib as jrl
import ray_tpu_torch
import ray_tpu_torch.rllib as trl
from ray_tpu.rllib import policy as jpolicy
from ray_tpu.rllib import policy_extra as jextra
from ray_tpu_torch.rllib import CartPoleEnv
from ray_tpu_torch.rllib import ReplayBuffer
from ray_tpu_torch.rllib import RolloutWorker
from ray_tpu_torch.rllib import SampleBatch
from ray_tpu_torch.rllib import StatelessGuessEnv
from ray_tpu_torch.rllib import sample_batch as sb
from ray_tpu_torch.rllib import policy as tpolicy
from ray_tpu_torch.rllib import policy_extra as textra

CPU = {"device": "cpu"}
# float32 forward on both sides: the same products, summed in another
# order (XLA's dot vs ATen's), a few ulps of values of magnitude ~1
FWD_RTOL, FWD_ATOL = 1e-5, 1e-6
# three adam steps: each normalises its step by sqrt(nu), so a gradient
# apart by summation order moves the step by the same relative amount;
# a wrong loss term or stop-gradient moves the weights by O(lr)
STATS_RTOL, STATS_ATOL = 1e-4, 1e-6
WEIGHTS_REL_L2 = 1e-4


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
    assert type(got) is type(want)
    if isinstance(want, dict):
        assert sorted(got) == sorted(want)
        for k in want:
            assert_weights_close(got[k], want[k], rel_l2)
        return
    if isinstance(want, (list, tuple)):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert_weights_close(g, w, rel_l2)
        return
    if not isinstance(want, np.ndarray):  # DQN's epsilon
        assert got == pytest.approx(want, rel=1e-12)
        return
    assert isinstance(got, np.ndarray) and got.dtype == want.dtype == \
        np.float32 and got.shape == want.shape
    err = np.linalg.norm(got - want)
    assert err <= rel_l2 * max(np.linalg.norm(want), 1e-6), (err, want)


def assert_stats_close(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k] == pytest.approx(want[k], rel=STATS_RTOL,
                                       abs=STATS_ATOL), k


def parity_batch(n, obs_dim, num_actions, seed=0, continuous=False):
    rng = np.random.default_rng(seed)
    dones = rng.random(n) < 0.2
    dones[-1] = False  # a truncated fragment: IMPALA bootstraps
    actions = (rng.uniform(-1, 1, (n, num_actions)).astype(np.float32)
               if continuous else rng.integers(num_actions, size=n))
    return SampleBatch({
        sb.OBS: rng.normal(size=(n, obs_dim)).astype(np.float32),
        sb.ACTIONS: actions,
        sb.REWARDS: rng.normal(size=n).astype(np.float32),
        sb.NEXT_OBS: rng.normal(size=(n, obs_dim)).astype(np.float32),
        sb.DONES: dones,
        sb.LOGP: np.log(rng.uniform(0.1, 0.9, n)).astype(np.float32),
        sb.VALUES: rng.normal(size=n).astype(np.float32),
        sb.ADVANTAGES: rng.normal(size=n).astype(np.float32),
        sb.RETURNS: rng.normal(size=n).astype(np.float32),
    })


def _copy(batch):
    return SampleBatch({k: np.array(v) for k, v in batch.items()})


def learn_both(jp, tp, batch, steps=3):
    """Three updates on each side from one batch -> (JAX stats, port
    stats) of each."""
    out = []
    for _ in range(steps):
        out.append((jp.learn_on_batch(_copy(batch)),
                    tp.learn_on_batch(_copy(batch))))
    return out


def _pair(jcls, tcls, obs_dim, num_actions, cfg):
    jp = jcls(obs_dim, num_actions, cfg)
    tp = tcls(obs_dim, num_actions, {**cfg, **CPU})
    tp.set_weights(jp.get_weights())
    return jp, tp


# ----------------------------------------------------- tests/test_rllib.py


def test_cartpole_env():
    env = CartPoleEnv(seed=0)
    obs = env.reset()
    assert obs.shape == (4,)
    total = 0
    done = False
    while not done:
        obs, r, done, _ = env.step(0)
        total += r
    assert 1 <= total < 200
    jenv = jrl.CartPoleEnv(seed=0)  # the copy steps as the reference
    jenv.reset()
    env = CartPoleEnv(seed=0)
    env.reset()
    for a in (0, 1, 1, 0, 1):
        np.testing.assert_array_equal(env.step(a)[0], jenv.step(a)[0])


def test_sample_batch_ops():
    b1 = SampleBatch({"a": np.arange(5), "b": np.ones(5)})
    b2 = SampleBatch({"a": np.arange(3), "b": np.zeros(3)})
    cat = SampleBatch.concat_samples([b1, b2])
    assert cat.count == 8
    mbs = list(cat.minibatches(3))
    assert [m.count for m in mbs] == [3, 3, 2]


def test_rollout_worker_produces_batches():
    w = RolloutWorker("CartPole-v1", tpolicy.PPOPolicy,
                      policy_config={"seed": 0, **CPU})
    batch = w.sample(64)
    assert batch.count == 64
    for key in (sb.OBS, sb.ACTIONS, sb.REWARDS, sb.DONES, sb.VALUES,
                sb.LOGP, sb.ADVANTAGES, sb.RETURNS):
        assert key in batch, key
    assert batch[sb.OBS].shape == (64, 4)


def test_replay_buffer_wraps():
    buf = ReplayBuffer(capacity=100, seed=0)
    for i in range(5):
        buf.add_batch(SampleBatch({"x": np.full(40, i)}))
    assert len(buf) == 100
    s = buf.sample(32)
    assert s["x"].shape == (32,)
    assert s["x"].min() >= 1  # oldest (0) was overwritten


def test_ppo_learns_stateless_guess(torch_init):
    trainer = trl.PPOTrainer({
        "env": StatelessGuessEnv,
        "num_workers": 2,
        "train_batch_size": 512,
        "policy_config": {"seed": 0, "lr": 5e-3,
                          "entropy_coeff": 0.0, **CPU},
        "env_config": {"num_actions": 4, "seed": 1},
    })
    result = None
    for _ in range(12):
        result = trainer.train()
    trainer.stop()
    # random = 0.25; learned policy should be clearly better
    assert result["episode_reward_mean"] > 0.6, result
    assert result["timesteps_total"] > 0


def test_dqn_learns_stateless_guess(torch_init):
    trainer = trl.DQNTrainer({
        "env": StatelessGuessEnv,
        "num_workers": 2,
        "rollout_fragment_length": 256,
        "learning_starts": 256,
        "sgd_steps_per_iter": 64,
        "policy_config": {"seed": 0, "lr": 5e-3,
                          "epsilon_decay": 0.9, **CPU},
        "env_config": {"num_actions": 3, "seed": 2},
    })
    result = None
    for _ in range(12):
        result = trainer.train()
    trainer.stop()
    assert result["episode_reward_mean"] > 0.6, result


def test_checkpoint_restore(torch_init):
    config = {
        "env": StatelessGuessEnv,
        "num_workers": 1,
        "train_batch_size": 128,
        "env_config": {"num_actions": 4},
        "policy_config": dict(CPU),
    }
    trainer = trl.PPOTrainer(config)
    trainer.train()
    ckpt = trainer.save_checkpoint()
    trainer2 = trl.PPOTrainer(config)
    trainer2.restore(ckpt)
    w1 = trainer.workers.local_worker.get_weights()
    w2 = trainer2.workers.local_worker.get_weights()
    np.testing.assert_array_equal(
        np.asarray(w1["pi"][0]["w"]), np.asarray(w2["pi"][0]["w"]))
    trainer.stop()
    trainer2.stop()


def test_dqn_policy_epsilon_decays():
    p = tpolicy.DQNPolicy(4, 2, {"epsilon_decay": 0.5, **CPU})
    batch = SampleBatch({
        sb.OBS: np.random.randn(8, 4).astype(np.float32),
        sb.ACTIONS: np.zeros(8, np.int32),
        sb.REWARDS: np.ones(8, np.float32),
        sb.NEXT_OBS: np.random.randn(8, 4).astype(np.float32),
        sb.DONES: np.zeros(8, np.float32),
    })
    eps0 = p.epsilon
    p.learn_on_batch(batch)
    assert p.epsilon < eps0


def test_a2c_learns_stateless_guess(torch_init):
    trainer = trl.A2CTrainer({
        "env": StatelessGuessEnv,
        "num_workers": 2,
        "train_batch_size": 512,
        "policy_config": {"seed": 0, "lr": 5e-3, "entropy_coeff": 0.0,
                          **CPU},
        "env_config": {"num_actions": 4, "seed": 3},
    })
    result = None
    for _ in range(15):
        result = trainer.train()
    trainer.stop()
    assert result["episode_reward_mean"] > 0.6, result


def test_sac_learns_stateless_guess(torch_init):
    trainer = trl.SACTrainer({
        "env": StatelessGuessEnv,
        "num_workers": 2,
        "rollout_fragment_length": 256,
        "learning_starts": 256,
        "sgd_steps_per_iter": 32,
        "policy_config": {"seed": 0, "lr": 5e-3,
                          "initial_alpha": 0.05,
                          "target_entropy": 0.05, **CPU},
        "env_config": {"num_actions": 3, "seed": 4},
    })
    result = None
    for _ in range(15):
        result = trainer.train()
    trainer.stop()
    assert result["episode_reward_mean"] > 0.6, result


def test_impala_learns_stateless_guess(torch_init):
    trainer = trl.IMPALATrainer({
        "env": StatelessGuessEnv,
        "num_workers": 2,
        "train_batch_size": 512,
        "num_sgd_iter": 2,
        "policy_config": {"seed": 0, "lr": 5e-3, "entropy_coeff": 0.0,
                          **CPU},
        "env_config": {"num_actions": 4, "seed": 5},
    })
    result = None
    for _ in range(15):
        result = trainer.train()
    trainer.stop()
    assert result["episode_reward_mean"] > 0.6, result


def test_vtrace_matches_onpolicy_returns():
    """With target == behavior policy and clip >= 1, V-trace degenerates
    to n-step TD(lambda=1) corrections; sanity-check against a direct
    computation on a tiny fixed sequence."""
    logp = torch.zeros(4)
    rewards = torch.tensor([1.0, 0.0, 1.0, 0.0])
    values = torch.tensor([0.5, 0.5, 0.5, 0.5])
    dones = torch.tensor([0.0, 0.0, 0.0, 1.0])
    vs, pg_adv = textra.vtrace(logp, logp, rewards, values,
                               torch.tensor(0.0), dones, gamma=1.0)
    # on-policy, gamma=1: vs equals the forward returns from each step
    np.testing.assert_allclose(vs.numpy(), [2.0, 1.0, 1.0, 0.0],
                               atol=1e-5)


def test_appo_learns_stateless_guess(torch_init):
    """APPO (reference agents/ppo/appo.py): IMPALA's async execution
    plan + the PPO clipped surrogate over V-trace advantages; must
    learn the oracle env like its siblings."""
    trainer = trl.APPOTrainer({
        "env": StatelessGuessEnv,
        "num_workers": 2,
        "train_batch_size": 512,
        "num_sgd_iter": 2,
        "policy_config": {"seed": 0, "lr": 5e-3, "entropy_coeff": 0.0,
                          "clip_param": 0.2, **CPU},
        "env_config": {"num_actions": 4, "seed": 5},
    })
    result = None
    for _ in range(15):
        result = trainer.train()
    trainer.stop()
    assert result["episode_reward_mean"] > 0.6, result


# ------------------------------------------------------ parity with JAX

OBS_DIM, NUM_ACTIONS, N = 5, 3, 48

PARITY = {
    # name: (JAX class, port class, config, what the forward returns)
    "ppo": (jpolicy.PPOPolicy, tpolicy.PPOPolicy,
            {"seed": 3, "lr": 1e-2, "num_sgd_iter": 2,
             "sgd_minibatch_size": 16, "hidden": (16, 8)}),
    "dqn": (jpolicy.DQNPolicy, tpolicy.DQNPolicy,
            {"seed": 3, "lr": 1e-2, "target_update_freq": 2,
             "hidden": (16, 8)}),
    "dqn_single_q": (jpolicy.DQNPolicy, tpolicy.DQNPolicy,
                     {"seed": 4, "lr": 1e-2, "double_q": False,
                      "hidden": (16,)}),
    "a2c": (jextra.A2CPolicy, textra.A2CPolicy,
            {"seed": 3, "lr": 1e-2, "hidden": (16, 8)}),
    "sac": (jextra.SACPolicy, textra.SACPolicy,
            {"seed": 3, "lr": 1e-2, "hidden": (16, 8), "tau": 0.1}),
    "impala": (jextra.IMPALAPolicy, textra.IMPALAPolicy,
               {"seed": 3, "lr": 1e-2, "hidden": (16, 8)}),
    "appo": (jextra.APPOPolicy, textra.APPOPolicy,
             {"seed": 3, "lr": 1e-2, "hidden": (16, 8),
              "clip_param": 0.1}),
}


def _forward(name, p, obs):
    """What the policy computes before sampling, as numpy."""
    if isinstance(p, tpolicy.Policy):
        x = torch.as_tensor(obs)
        if name.startswith("dqn"):
            return [p._q(x).numpy()]
        if name == "sac":
            return [p._logits(x).numpy()]
        return [t.numpy() for t in p._forward(x)]
    if name.startswith("dqn"):
        return [np.asarray(p._q(p.params, obs))]
    if name == "sac":
        return [np.asarray(p._logits_fn(p.params, obs))]
    return [np.asarray(t) for t in p._forward(p.params, obs)]


@pytest.mark.parametrize("name", sorted(PARITY))
def test_policy_parity_with_jax(name):
    jcls, tcls, cfg = PARITY[name]
    jp, tp = _pair(jcls, tcls, OBS_DIM, NUM_ACTIONS, cfg)
    # get_weights is the JAX package's pytree: keys, shapes, float32
    assert_weights_close(tp.get_weights(), jp.get_weights(), 0.0)
    obs = np.random.default_rng(1).normal(
        size=(N, OBS_DIM)).astype(np.float32)
    for got, want in zip(_forward(name, tp, obs), _forward(name, jp, obs)):
        np.testing.assert_allclose(got, want, rtol=FWD_RTOL, atol=FWD_ATOL)
    batch = parity_batch(N, OBS_DIM, NUM_ACTIONS, seed=2)
    for want, got in learn_both(jp, tp, batch):
        assert_stats_close(got, want)
    assert_weights_close(tp.get_weights(), jp.get_weights())
    if name.startswith("dqn"):
        assert tp.epsilon == jp.epsilon


def test_a2c_gradients_cross_packages():
    """A3C's seam: the gradients are the same numpy tree on both sides,
    and each side applies the other's."""
    jp, tp = _pair(jextra.A2CPolicy, textra.A2CPolicy, OBS_DIM,
                   NUM_ACTIONS, {"seed": 5, "lr": 1e-2, "hidden": (8,)})
    batch = parity_batch(N, OBS_DIM, NUM_ACTIONS, seed=6)
    jg, jstats = jp.compute_gradients(_copy(batch))
    tg, tstats = tp.compute_gradients(_copy(batch))
    assert_stats_close(tstats, jstats)
    assert_weights_close(tg, jax_tree_to_numpy(jg), 1e-5)
    jp.apply_gradients(tg)
    tp.apply_gradients(jg)
    assert_weights_close(tp.get_weights(), jp.get_weights())


def jax_tree_to_numpy(tree):
    return tpolicy.tree_map(lambda x: np.asarray(x), tree)


def test_vtrace_matches_jax_on_seeded_fragments():
    rng = np.random.default_rng(7)
    for t, gamma, clip in ((1, 0.99, 1.0), (17, 0.9, 1.0), (64, 0.99, 0.5)):
        blp = np.log(rng.uniform(0.05, 1.0, t)).astype(np.float32)
        tlp = np.log(rng.uniform(0.05, 1.0, t)).astype(np.float32)
        rewards = rng.normal(size=t).astype(np.float32)
        values = rng.normal(size=t).astype(np.float32)
        dones = (rng.random(t) < 0.25).astype(np.float32)
        boot = np.float32(rng.normal())
        want = jextra.vtrace(*(jnp.asarray(a) for a in (
            blp, tlp, rewards, values, boot, dones)), gamma, clip, clip)
        got = textra.vtrace(*(torch.as_tensor(a) for a in (
            blp, tlp, rewards, values, boot, dones)), gamma, clip, clip)
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w),
                                       rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("name", ["ppo", "dqn"])
def test_acting_matches_jax(name):
    """Gumbel-max (PPO) and epsilon-greedy (DQN) draw from the policy's
    numpy RNG on both sides: the same weights and seed give the same
    actions, one observation at a time as a rollout acts."""
    jcls, tcls, cfg = PARITY[name]
    cfg = {**cfg, "epsilon": 0.3}
    jp, tp = _pair(jcls, tcls, OBS_DIM, NUM_ACTIONS, cfg)
    obs = np.random.default_rng(8).normal(size=(200, OBS_DIM)).astype(
        np.float32)
    got = [tp.compute_actions(o)[0][0] for o in obs]
    want = [jp.compute_actions(o)[0][0] for o in obs]
    assert got == want
    if name == "ppo":  # the extras agree too
        te = tp.compute_actions(obs[:4])[1]
        je = jp.compute_actions(obs[:4])[1]
        for k in (sb.VALUES, sb.LOGP):
            np.testing.assert_allclose(te[k], je[k], rtol=FWD_RTOL,
                                       atol=FWD_ATOL)


@contextlib.contextmanager
def _jax_runtime():
    ray_tpu.init(num_cpus=4)
    try:
        yield
    finally:
        ray_tpu.shutdown()


@pytest.mark.parametrize("algo", ["PPOTrainer", "DQNTrainer"])
def test_jax_checkpoint_restores_into_port_trainer(algo):
    config = {
        "env": StatelessGuessEnv,
        "num_workers": 1,
        "train_batch_size": 128,
        "rollout_fragment_length": 128,
        "learning_starts": 64,
        "sgd_steps_per_iter": 4,
        "env_config": {"num_actions": 4, "seed": 1},
        "policy_config": {"seed": 0},
    }
    with _jax_runtime():
        jt = getattr(jrl, algo)({**config, "env": jrl.StatelessGuessEnv})
        jt.train()
        ckpt = jt.save_checkpoint()
        jpol = jt.get_policy()
        jt.stop()
    ray_tpu_torch.init(num_cpus=4, device="cpu")
    try:
        tt = getattr(trl, algo)({**config, "policy_config": {"seed": 0,
                                                             **CPU}})
        tt.restore(ckpt)
        assert tt._iteration == ckpt["iteration"] == 1
        assert_weights_close(tt.get_policy().get_weights(),
                             ckpt["weights"], 0.0)
        # the checkpoint carries weights only: both act from one RNG
        jpol._rng = np.random.default_rng(9)
        tt.get_policy()._rng = np.random.default_rng(9)
        obs = np.random.default_rng(10).normal(size=(100, 4)).astype(
            np.float32)
        got = [tt.compute_single_action(o) for o in obs]
        want = [int(jpol.compute_actions(o)[0][0]) for o in obs]
        assert got == want
        # and its remote workers got the restored weights
        remote = ray_tpu_torch.get(
            tt.workers.remote_workers[0].get_weights.remote())
        assert_weights_close(remote, ckpt["weights"], 0.0)
        tt.stop()
    finally:
        ray_tpu_torch.shutdown()
