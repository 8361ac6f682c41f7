"""ray_tpu_torch.rllib: the algorithms of ``ray_tpu.rllib`` on PyTorch,
on-policy (PPO, PG and A2C, IMPALA with V-trace, APPO, each IMPALA-family
algorithm with an optional GRU/LSTM core; RecurrentPPO) with their learner
plane, from replay (DQN with prioritized and n-step replay, C51 and
dueling; SAC; TD3 and DDPG), offline (BC, CQL, MARWIL and the off-policy
estimators), multi-agent PPO, model-based (DreamerV3), and the numpy-only
ones (the linear bandits, ES and ARS, the connectors), with the port's own
copies of the numpy environments, replay and dataset IO. Exports every
name of ``ray_tpu.rllib``."""

from ray_tpu_torch.rllib.appo import APPO, APPOConfig
from ray_tpu_torch.rllib.bandit import (
    BanditLinTS,
    BanditLinTSConfig,
    BanditLinUCB,
    BanditLinUCBConfig,
)
from ray_tpu_torch.rllib.connectors import (
    ClipActions,
    Connector,
    ConnectorEnv,
    ConnectorPipeline,
    FlattenObs,
    FrameStack,
    NormalizeObs,
    UnsquashActions,
)
from ray_tpu_torch.rllib.dqn import DQN, DQNConfig
from ray_tpu_torch.rllib.dreamer import DreamerV3, DreamerV3Config
from ray_tpu_torch.rllib.es import ARS, ARSConfig, ES, ESConfig
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
from ray_tpu_torch.rllib.recurrent import (
    MemoryCueEnv,
    RecurrentPPO,
    RecurrentPPOConfig,
    StatelessCartPole,
)
from ray_tpu_torch.rllib.multi_agent import (
    MultiAgentCartPole,
    MultiAgentEnv,
    MultiAgentPPO,
    MultiAgentPPOConfig,
    MultiAgentReplay,
    PolicyMap,
)
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

__all__ = ["A2C", "A2CConfig", "APPO", "APPOConfig", "ARS", "ARSConfig",
           "BC", "BCConfig", "BanditEnv", "BanditLinTS", "BanditLinTSConfig",
           "BanditLinUCB", "BanditLinUCBConfig", "CQL", "CQLConfig",
           "CartPole", "ClipActions", "Connector", "ConnectorEnv",
           "ConnectorPipeline", "ContinuousBandit", "DDPG", "DDPGConfig",
           "DQN", "DQNConfig", "DatasetWriter", "DreamerV3",
           "DreamerV3Config", "ES", "ESConfig", "FlattenObs", "FrameStack",
           "GymEnvAdapter", "IMPALA", "IMPALAConfig", "ImportanceSampling",
           "LearnerGroup", "MARWIL", "MARWILConfig", "MemoryCueEnv",
           "MultiAgentCartPole", "MultiAgentEnv", "MultiAgentPPO",
           "MultiAgentPPOConfig", "MultiAgentReplay", "NormalizeObs",
           "OfflineDataset", "PG", "PGConfig", "PPO", "PPOConfig",
           "Pendulum", "PolicyMap", "RecurrentPPO", "RecurrentPPOConfig",
           "SAC", "SACConfig", "StatelessCartPole", "TD3", "TD3Config",
           "UnsquashActions", "WeightedImportanceSampling",
           "collect_dataset", "episodes_from_dataset", "make_env"]
