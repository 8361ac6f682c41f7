"""Training: the trainer with its state, optimizer and checkpoints, and
the multi-process harness. Exports the device-plane names of
``ray_tpu.train``, ``JaxTrainer`` as ``Trainer`` and ``JaxMeshTrainer``
as ``TorchMeshTrainer``; its integrations of other frameworks
(``TorchTrainer``, ``LightningTrainer``, the gradient-boosted trees, ...)
are not ported."""

from ray_tpu_torch.air.config import (CheckpointConfig, FailureConfig,
                                      RunConfig, ScalingConfig)
from ray_tpu_torch.train.data_parallel_trainer import (DataParallelTrainer,
                                                       Result,
                                                       TorchMeshTrainer)
from ray_tpu_torch.train.elastic import ElasticTrainer
from ray_tpu_torch.train.session import (get_checkpoint_dir, get_context,
                                         report, set_flops_per_step, timeit)
from ray_tpu_torch.train.telemetry import StepTelemetry, record_run_bucket
from ray_tpu_torch.train.trainer import TrainConfig, Trainer
from ray_tpu_torch.train.worker_group import BackendExecutor, WorkerGroup

__all__ = [
    "BackendExecutor",
    "CheckpointConfig",
    "DataParallelTrainer",
    "ElasticTrainer",
    "FailureConfig",
    "Result",
    "RunConfig",
    "ScalingConfig",
    "StepTelemetry",
    "TorchMeshTrainer",
    "TrainConfig",
    "Trainer",
    "WorkerGroup",
    "get_checkpoint_dir",
    "get_context",
    "record_run_bucket",
    "report",
    "set_flops_per_step",
    "timeit",
]
