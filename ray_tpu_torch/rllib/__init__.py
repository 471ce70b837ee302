"""ray_tpu_torch.rllib — reinforcement learning on the actor fleet.

Reference surface: rllib/ (agents, rollout workers, sample batches,
replay). Policies are PyTorch functions over parameter trees kept in the
JAX package's layout, on the device of their config's ``device`` key
(CUDA unless the caller asks for the CPU); sampling is an actor fleet;
learning runs on the local worker.
"""

from ray_tpu_torch.rllib.agents import (  # noqa: F401
    A2CTrainer,
    BCTrainer,
    CQLTrainer,
    DDPGTrainer,
    DQNTrainer,
    APPOTrainer,
    IMPALATrainer,
    LinTSTrainer,
    LinUCBTrainer,
    MARWILTrainer,
    PGTrainer,
    PPOTrainer,
    SACContinuousTrainer,
    SACTrainer,
    TD3Trainer,
    Trainer,
)
from ray_tpu_torch.rllib.env import (  # noqa: F401
    CartPoleEnv,
    Env,
    LinearBanditEnv,
    PendulumEnv,
    StatelessGuessEnv,
    make_env,
)
from ray_tpu_torch.rllib.a3c import A3CTrainer  # noqa: F401
from ray_tpu_torch.rllib.es import ARSTrainer, ESTrainer  # noqa: F401
from ray_tpu_torch.rllib.multi_agent import (  # noqa: F401
    MultiAgentEnv,
    MultiAgentRolloutWorker,
    MultiAgentTrainer,
    TwoStepGuessEnv,
)
from ray_tpu_torch.rllib.qmix import (  # noqa: F401
    QMixTrainer,
    TwoStepCoopEnv,
    VDNTrainer,
)
from ray_tpu_torch.rllib.offline import (  # noqa: F401
    JsonReader,
    JsonWriter,
    collect_episodes,
)
from ray_tpu_torch.rllib.policy import DQNPolicy, PPOPolicy, Policy  # noqa: F401
from ray_tpu_torch.rllib.policy_bandit import (  # noqa: F401
    LinTSPolicy,
    LinUCBPolicy,
)
from ray_tpu_torch.rllib.policy_continuous import (  # noqa: F401
    ContinuousSACPolicy,
    CQLPolicy,
    DDPGPolicy,
    TD3Policy,
)
from ray_tpu_torch.rllib.policy_extra import (  # noqa: F401
    A2CPolicy,
    IMPALAPolicy,
    SACPolicy,
)
from ray_tpu_torch.rllib.policy_pg import MARWILPolicy, PGPolicy  # noqa: F401
from ray_tpu_torch.rllib.rollout_worker import (  # noqa: F401
    ReplayBuffer,
    RolloutWorker,
    WorkerSet,
)
from ray_tpu_torch.rllib.sample_batch import SampleBatch  # noqa: F401

__all__ = [
    "Trainer", "PPOTrainer", "DQNTrainer", "A2CTrainer", "SACTrainer",
    "IMPALATrainer", "APPOTrainer", "PGTrainer", "MARWILTrainer", "BCTrainer",
    "DDPGTrainer", "TD3Trainer", "SACContinuousTrainer", "CQLTrainer",
    "LinUCBTrainer", "LinTSTrainer",
    "ESTrainer", "ARSTrainer", "A3CTrainer",
    "Policy", "PPOPolicy", "DQNPolicy", "A2CPolicy",
    "SACPolicy", "IMPALAPolicy", "PGPolicy", "MARWILPolicy",
    "DDPGPolicy", "TD3Policy", "ContinuousSACPolicy", "CQLPolicy",
    "LinUCBPolicy", "LinTSPolicy",
    "RolloutWorker", "WorkerSet",
    "ReplayBuffer", "SampleBatch", "Env", "CartPoleEnv",
    "StatelessGuessEnv", "PendulumEnv", "LinearBanditEnv", "make_env",
    "JsonReader", "JsonWriter", "collect_episodes",
    "MultiAgentEnv", "MultiAgentTrainer", "MultiAgentRolloutWorker",
    "TwoStepGuessEnv", "QMixTrainer", "VDNTrainer", "TwoStepCoopEnv",
]
