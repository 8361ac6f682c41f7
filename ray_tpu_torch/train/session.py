"""Per-rank training session: report, checkpoint, context.

Port of ``ray_tpu/train/session.py``. The session is process-local state
inside each rank process. Where the JAX package sends reports through a
``_ReportBus`` actor that the driver polls, a rank here puts each report
on a ``multiprocessing`` queue of the spawn context, which the driver
drains (``train.worker_group``). ``TrainContext`` also carries what a
rank's loop needs to train across processes: its device and its
``parallel.process_group.ProcessGroup``.
"""

from __future__ import annotations

import contextlib
import os
import threading
from dataclasses import dataclass, field
from typing import Any


@dataclass
class TrainContext:
    rank: int = 0
    world_size: int = 1
    local_rank: int = 0
    node_rank: int = 0
    trial_dir: str = ""
    experiment_name: str = ""
    restore_checkpoint: str | None = None
    # the rank's device ("cuda:<i>", or "cpu" for a rank asked to run on
    # the CPU; outside a rank the card, as every entry point's default) and
    # its process group (None outside a harness rank)
    device: str = "cuda"
    process_group: Any = None
    # what a rank keeps between ``WorkerGroup.execute`` calls (a learner
    # replica: ``rllib.learner_group``), by name
    objects: dict = field(default_factory=dict)

    def get_world_size(self) -> int:
        return self.world_size

    def get_world_rank(self) -> int:
        return self.rank

    def get_local_rank(self) -> int:
        return self.local_rank

    def get_trial_dir(self) -> str:
        return self.trial_dir


_session = threading.local()


def _init_session(context: TrainContext, queue=None):
    from ray_tpu_torch.train.telemetry import StepTelemetry, \
        detect_peak_flops

    _session.context = context
    _session.queue = queue
    _session.iteration = 0
    _session.collective_s = 0.0
    _session.telemetry = StepTelemetry(
        run=context.experiment_name, rank=context.rank,
        world_size=context.world_size, peak_flops=detect_peak_flops())


def telemetry():
    """This rank's StepTelemetry (None outside a session)."""
    return getattr(_session, "telemetry", None)


def set_flops_per_step(flops: float, peak_flops: float | None = None):
    """Declare the model's FLOPs per optimizer step (and optionally the
    card's peak FLOP/s, detected from the card's name where
    ``telemetry.PEAK_BF16_FLOPS`` knows it) so every report carries MFU.
    The usual declaration is ``6 * n_params * tokens_per_step``."""
    t = telemetry()
    if t is not None:
        t.set_flops_per_step(flops, peak_flops)


def timeit(bucket: str):
    """Context manager attributing the block's wall clock to one step
    stage (``data_wait`` / ``compute`` / ``collective_sync`` /
    ``checkpoint``; ``report`` books the process group's all-reduces into
    ``collective_sync`` itself). No-op outside a session."""
    t = telemetry()
    if t is None:
        return contextlib.nullcontext()
    return t.timeit(bucket)


def get_context() -> TrainContext:
    ctx = getattr(_session, "context", None)
    if ctx is None:
        return TrainContext()  # outside a worker: defaults (like reference)
    return ctx


def report(metrics: dict, *, checkpoint_dir: str | None = None):
    """Send metrics (and optionally a checkpoint directory) to the
    driver. Rank 0's checkpoint is the one retained (reference: rank-0
    upload via StorageContext). The process group's gradient all-reduce
    seconds since the last report go to the step's ``collective_sync``."""
    ctx = get_context()
    _session.iteration = getattr(_session, "iteration", 0) + 1
    # close the telemetry step before the put: the put is reporting
    # overhead, booked into the next step's wall, never into the step
    # being stamped
    t = telemetry()
    if t is not None:
        if ctx.process_group is not None:
            spent = ctx.process_group.stats["grad_all_reduce_s"]
            if spent > _session.collective_s:
                t.add("collective_sync", spent - _session.collective_s)
            _session.collective_s = spent
        t.on_report(metrics)
    queue = getattr(_session, "queue", None)
    if queue is not None:
        queue.put({"rank": ctx.rank, "metrics": dict(metrics),
                   "checkpoint": checkpoint_dir})


def get_checkpoint_dir() -> str | None:
    """Restore path for resumed runs: the per-trial context first, the
    environment variable as the out-of-band fallback."""
    ctx = get_context()
    if ctx.restore_checkpoint:
        return ctx.restore_checkpoint
    return os.environ.get("RAY_TPU_RESTORE_CHECKPOINT") or None
