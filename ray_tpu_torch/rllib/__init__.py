"""ray_tpu_torch.rllib: the algorithms of ``ray_tpu.rllib`` on PyTorch,
on-policy (PPO, PG and A2C, IMPALA with V-trace, APPO) with their learner
plane, from replay (DQN with prioritized and n-step replay, C51 and
dueling; SAC; TD3 and DDPG) and offline (BC, CQL, MARWIL and the
off-policy estimators), with the port's own copies of the numpy
environments, replay and dataset IO."""

from ray_tpu_torch.rllib.appo import APPO, APPOConfig
from ray_tpu_torch.rllib.dqn import DQN, DQNConfig
from ray_tpu_torch.rllib.env import (
    BanditEnv,
    CartPole,
    ContinuousBandit,
    Pendulum,
    make_env,
)
from ray_tpu_torch.rllib.gym_env import GymEnvAdapter
from ray_tpu_torch.rllib.impala import IMPALA, IMPALAConfig
from ray_tpu_torch.rllib.learner_group import LearnerGroup
from ray_tpu_torch.rllib.estimators import (
    ImportanceSampling,
    WeightedImportanceSampling,
    episodes_from_dataset,
)
from ray_tpu_torch.rllib.offline import (
    BC,
    BCConfig,
    CQL,
    CQLConfig,
    DatasetWriter,
    OfflineDataset,
    collect_dataset,
)
from ray_tpu_torch.rllib.marwil import MARWIL, MARWILConfig
from ray_tpu_torch.rllib.pg import A2C, A2CConfig, PG, PGConfig
from ray_tpu_torch.rllib.ppo import PPO, PPOConfig
from ray_tpu_torch.rllib.sac import SAC, SACConfig
from ray_tpu_torch.rllib.td3 import DDPG, DDPGConfig, TD3, TD3Config

__all__ = ["A2C", "A2CConfig", "APPO", "APPOConfig", "BC", "BCConfig",
           "BanditEnv", "CQL", "CQLConfig", "CartPole", "ContinuousBandit",
           "DDPG", "DDPGConfig", "DQN", "DQNConfig", "DatasetWriter",
           "GymEnvAdapter", "IMPALA", "IMPALAConfig", "ImportanceSampling",
           "LearnerGroup", "MARWIL", "MARWILConfig", "OfflineDataset", "PG",
           "PGConfig", "PPO", "PPOConfig", "Pendulum", "SAC", "SACConfig",
           "TD3", "TD3Config", "WeightedImportanceSampling",
           "collect_dataset", "episodes_from_dataset", "make_env"]
