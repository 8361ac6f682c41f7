"""ray_tpu_torch.rllib: the on-policy algorithms of ``ray_tpu.rllib`` on
PyTorch (PPO, PG and A2C, IMPALA with V-trace, APPO) and their learner
plane, with the port's own copies of the numpy environments."""

from ray_tpu_torch.rllib.appo import APPO, APPOConfig
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
from ray_tpu_torch.rllib.pg import A2C, A2CConfig, PG, PGConfig
from ray_tpu_torch.rllib.ppo import PPO, PPOConfig

__all__ = ["A2C", "A2CConfig", "APPO", "APPOConfig", "BanditEnv",
           "CartPole", "ContinuousBandit", "GymEnvAdapter", "IMPALA",
           "IMPALAConfig", "LearnerGroup", "PG", "PGConfig", "PPO",
           "PPOConfig", "Pendulum", "make_env"]
