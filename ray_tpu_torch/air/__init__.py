"""Port of ``ray_tpu.air``: the run and scaling configs of the train
harness."""

from ray_tpu_torch.air.config import (CheckpointConfig, FailureConfig,
                                      RunConfig, ScalingConfig)

__all__ = [
    "CheckpointConfig",
    "FailureConfig",
    "RunConfig",
    "ScalingConfig",
]
