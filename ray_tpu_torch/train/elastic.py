"""Elastic mesh reformation: rebuild the mesh and resume from the
newest checkpoint when the set of places changes.

Port of ``ray_tpu/train/elastic.py`` (``ElasticTrainer:40``). The
checkpoint is sharding-agnostic (``train.checkpoint`` saves global
tensors), so a restore places the state onto whatever mesh exists now,
fewer places after a failure or more after a scale-up, by the new mesh's
shardings (``CheckpointManager.restore(target=, shardings=)``). A place is
a ``torch.device``; one card may fill several places of a mesh.

Across processes (``process_group=``) the mesh is global, its places
dealt to the processes (``parallel.mesh.split_axes``), each process
giving its own ``devices``. A checkpoint saved there holds each
process's chunks in a file of its own, and restores onto any layout and
world (``train.checkpoint``), so a reform is the JAX path after
``jax.distributed`` re-initialises with the survivors: the survivors join
a new process group, and each calls ``reform(process_group=)``, which
rebuilds the global mesh over the new world and restores the newest
checkpoint into this process's places of it.
"""

from __future__ import annotations

import os
import time
from dataclasses import dataclass
from typing import Callable

from ray_tpu_torch.parallel.mesh import Mesh, create_mesh, visible_devices
from ray_tpu_torch.parallel.process_group import mesh_layout
from ray_tpu_torch.train.checkpoint import CheckpointManager
from ray_tpu_torch.train.telemetry import StepTelemetry, record_run_bucket
from ray_tpu_torch.train.trainer import TrainConfig, Trainer


@dataclass
class ReformEvent:
    step: int
    old_devices: int
    new_devices: int
    seconds: float


def _dp_axes(n: int) -> dict:
    return {"dp": n}


class ElasticTrainer:
    """Trainer + CheckpointManager + mesh reformation.

    ``mesh_axes_fn(n_places) -> axes`` decides the mesh shape for any
    number of places, so a reformation after losing (or gaining) places
    picks a valid factorization. With ``process_group`` (this process's
    ``ProcessGroup``) the places are global: ``mesh_axes_fn`` gets the
    world size times this process's places (``devices``, default its
    rank's device), and the mesh spans the processes (module
    docstring)."""

    def __init__(self, model_cfg, train_cfg: TrainConfig, *,
                 checkpoint_dir: str,
                 mesh_axes_fn: Callable[[int], dict] | None = None,
                 devices=None, checkpoint_every: int = 50,
                 max_to_keep: int = 3, run_name: str | None = None,
                 process_group=None):
        self.process_group = process_group
        self.model_cfg = model_cfg
        self.train_cfg = train_cfg
        self.mesh_axes_fn = mesh_axes_fn or _dp_axes
        self.checkpoint_every = checkpoint_every
        self.run_name = run_name or \
            os.path.basename(os.path.normpath(checkpoint_dir))
        self.ckpt = CheckpointManager(checkpoint_dir,
                                      max_to_keep=max_to_keep)
        self.reform_events: list[ReformEvent] = []
        # elastic runs are driver-driven (no rank session): the trainer
        # owns its step clock, so its accounting matches the harness's
        self.telemetry = StepTelemetry(self.run_name, 0)
        self._build(devices)

    @property
    def places(self) -> int:
        """The mesh's places: this process's, times the world size across
        processes."""
        world = self.process_group.world_size if self.process_group else 1
        return world * len(self.devices)

    def _build(self, devices):
        pg = self.process_group
        if devices is None:
            devices = [pg.device] if pg is not None else visible_devices()
        self.devices = list(devices)
        if not self.devices:
            raise ValueError("ElasticTrainer needs at least one place")
        axes = self.mesh_axes_fn(self.places)
        if pg is None:
            mesh = create_mesh(axes, devices=self.devices)
        else:
            layout = mesh_layout(pg, axes)
            local = create_mesh(layout.local, devices=self.devices)
            mesh = Mesh(local.devices, local.axis_names, layout)
        self.trainer = Trainer(self.model_cfg, self.train_cfg, mesh=mesh,
                               device=mesh.devices.ravel()[0],
                               process_group=pg)

    # -- state lifecycle -------------------------------------------------

    def init_state(self, seed: int = 0):
        return self.trainer.init_state(seed=seed)

    def save(self, state, *, metrics: dict | None = None,
             force: bool = False):
        self.ckpt.save(int(state.step), state, metrics=metrics,
                       force=force)

    def restore_latest(self):
        """Restore the newest checkpoint into the current mesh's
        shardings (across changes of the number of places)."""
        return self.ckpt.restore(
            target=self.trainer.abstract_state(),
            shardings=self.trainer.state_shardings())

    # -- reformation -----------------------------------------------------

    def reform(self, devices=None, *, process_group=None):
        """Rebuild the mesh over the (new) places and restore the newest
        checkpoint onto it; returns the restored state. Across processes,
        ``process_group`` is the group the processes left (or the new
        world) joined, and the mesh is dealt to it. Its seconds go to the
        run's ``restart`` goodput bucket."""
        t0 = time.perf_counter()
        self.ckpt.wait()  # pending async saves must be durable first
        old_n = self.places
        if process_group is not None:
            self.process_group = process_group
        self._build(devices)
        state = self.restore_latest()
        event = ReformEvent(step=int(state.step), old_devices=old_n,
                            new_devices=self.places,
                            seconds=time.perf_counter() - t0)
        self.reform_events.append(event)
        # the step clock skips past the reform, so the gap is not counted
        # again in the next step's residual
        record_run_bucket(self.run_name, "restart", event.seconds)
        self.telemetry.mark_gap()
        return state

    # -- driving loop ----------------------------------------------------

    def fit(self, state, data_iter, *, steps: int,
            on_metrics: Callable | None = None):
        """Train with periodic checkpoints. If a step raises, the caller
        reforms and resumes; this loop owns the happy path and the
        checkpoint cadence."""
        for _ in range(steps):
            with self.telemetry.timeit("data_wait"):
                batch = next(data_iter)
            state, metrics = self.trainer.train_step(state, batch)
            step = int(metrics["step"])
            if on_metrics:
                on_metrics({k: float(v) for k, v in metrics.items()})
            if step % self.checkpoint_every == 0:
                with self.telemetry.timeit("checkpoint"):
                    self.save(state,
                              metrics={"loss": float(metrics["loss"])})
            self.telemetry.on_report(metrics)
        return state

    def close(self):
        self.ckpt.close()
