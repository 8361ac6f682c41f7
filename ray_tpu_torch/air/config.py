"""Run and scaling configs of the train harness.

Port of ``ray_tpu/air/config.py`` (``ScalingConfig``, ``RunConfig``,
``FailureConfig``, ``CheckpointConfig``). ``ScalingConfig`` asks for cards
with ``use_gpu`` in place of ``use_tpu``, as the reference's Ray does, and
names the ``torch.distributed`` backend of the rank processes: NCCL between
cards, gloo on the CPU or for several ranks on one card (NCCL refuses two
ranks on one GPU). The TPU slice ``topology`` and the placement fields of
the JAX package have no counterpart: the port spawns its ranks on this
host.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field

@dataclass
class ScalingConfig:
    """How many rank processes, and what each drives: rank ``r`` takes
    card ``r % device_count`` (the default, as every entry point of the
    port runs on the card; a host without one raises before any rank
    starts), or the CPU with ``use_gpu=False``. ``backend`` defaults to
    nccl with ``use_gpu`` and gloo without."""

    num_workers: int = 1
    use_gpu: bool = True
    backend: str | None = None

    def resolved_backend(self) -> str:
        """``backend``, or its default (checked against the host by
        ``parallel.process_group.check_backend``)."""
        return self.backend or ("nccl" if self.use_gpu else "gloo")


@dataclass
class FailureConfig:
    max_failures: int = 0   # trial-level retries (reference semantics)


@dataclass
class CheckpointConfig:
    num_to_keep: int | None = None           # top-k retention
    checkpoint_score_attribute: str | None = None
    checkpoint_score_order: str = "max"      # "max" | "min"


@dataclass
class RunConfig:
    name: str | None = None
    storage_path: str | None = None
    failure_config: FailureConfig = field(default_factory=FailureConfig)
    checkpoint_config: CheckpointConfig = field(
        default_factory=CheckpointConfig)
    verbose: int = 0

    def resolved_storage_path(self) -> str:
        base = self.storage_path or os.path.join(
            os.path.expanduser("~"), "ray_tpu_torch_results")
        return os.path.join(base, self.name) if self.name else base
