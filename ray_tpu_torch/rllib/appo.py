"""APPO on PyTorch: IMPALA's architecture + PPO's clipped surrogate.

Port of ``ray_tpu/rllib/appo.py`` (reference analog:
``rllib/algorithms/appo/``): IMPALA's rollout workers and V-trace
correction, with the plain policy-gradient term replaced by the PPO clip
objective (``impala_loss``'s ``clip_param`` branch), which bounds how far
one update can move the policy from the behavior policy.
"""

from __future__ import annotations

from dataclasses import dataclass, replace

from ray_tpu_torch.rllib.impala import IMPALA, IMPALAConfig


@dataclass
class APPOConfig(IMPALAConfig):
    clip_param: float | None = 0.3

    def build(self) -> "APPO":
        return APPO(self)


class APPO(IMPALA):
    def __init__(self, config):
        if config.clip_param is None:   # field lives on IMPALAConfig
            config = replace(config, clip_param=0.3)
        super().__init__(config)
