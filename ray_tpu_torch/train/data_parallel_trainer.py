"""DataParallelTrainer: the fit() harness over rank processes.

Port of ``ray_tpu/train/data_parallel_trainer.py`` (reference:
``python/ray/train/data_parallel_trainer.py``, ``DataParallelTrainer:28``,
and ``BaseTrainer.fit``, ``base_trainer.py:571``). ``fit()`` spawns the
worker group (``train.worker_group``: one process per rank over a
``torch.distributed`` group), streams the ranks' reports, applies
``FailureConfig`` retries (each retry resumes from the last retained
checkpoint) and keeps the top-k checkpoints of ``CheckpointConfig``.

Ranks call ``train.session.report(metrics, checkpoint_dir=...)``; rank 0's
metrics are the canonical stream. Data: ``datasets={"train": columns}``,
``columns`` a dict of equal-length numpy arrays; each rank gets its rows
(contiguous, split by rank) as ``config["train_shard"]``, a
``data.iterator.DataIterator``. The loop reaches the ranks by ``pickle``:
it is a module-level function, with its settings in
``train_loop_config``.

``TorchMeshTrainer`` is the counterpart of ``JaxMeshTrainer`` (``:200``):
each rank runs ``train.trainer.Trainer`` over its process group, fed from
the device feed when it has a dataset; the global mesh's places are dealt
to the ranks (``parallel.mesh.split_axes``), checked before any rank
starts.
"""

from __future__ import annotations

import math
import os
import shutil
import time
import uuid
from dataclasses import dataclass, field
from typing import Callable

import numpy as np

from ray_tpu_torch.air.config import RunConfig, ScalingConfig
from ray_tpu_torch.data.iterator import DataIterator
from ray_tpu_torch.train.worker_group import BackendExecutor


@dataclass
class Result:
    metrics: dict = field(default_factory=dict)
    checkpoint_dir: str | None = None
    error: str | None = None
    metrics_history: list = field(default_factory=list)
    # each finished rank's stats (worker_group._rank_stats), rank order
    rank_stats: list = field(default_factory=list)
    # seconds from the spawn of the ranks to rank 0's first report
    first_report_s: float | None = None


class _TopKCheckpoints:
    """Retention per CheckpointConfig (reference: CheckpointManager top-k,
    ``train/_internal/checkpoint_manager.py``)."""

    def __init__(self, cfg):
        self.cfg = cfg
        self.entries: list[tuple[float, str]] = []  # (score, dir)

    def add(self, checkpoint_dir: str, metrics: dict):
        if self.cfg.num_to_keep is None:
            self.entries.append((0.0, checkpoint_dir))
            return
        attr = self.cfg.checkpoint_score_attribute
        score = float(metrics.get(attr, 0.0)) if attr else float(
            len(self.entries))
        if self.cfg.checkpoint_score_order == "min":
            score = -score
        self.entries.append((score, checkpoint_dir))
        self.entries.sort(key=lambda e: e[0], reverse=True)
        while len(self.entries) > self.cfg.num_to_keep:
            _, victim = self.entries.pop()
            if victim != checkpoint_dir and os.path.isdir(victim):
                shutil.rmtree(victim, ignore_errors=True)

    def best(self) -> str | None:
        return self.entries[0][1] if self.entries else None

    def latest(self) -> str | None:
        return self.entries[-1][1] if self.entries else None


class DataParallelTrainer:
    def __init__(
        self,
        train_loop_per_worker: Callable,
        *,
        train_loop_config: dict | None = None,
        scaling_config: ScalingConfig | None = None,
        run_config: RunConfig | None = None,
        datasets: dict | None = None,
    ):
        self.train_fn = train_loop_per_worker
        self.config = dict(train_loop_config or {})
        self.scaling = scaling_config or ScalingConfig()
        self.run_config = run_config or RunConfig()
        self.datasets = datasets or {}
        # stable run label for telemetry: the RunConfig name, or a
        # per-trainer handle when unnamed (not per attempt: restart
        # badput accrues to the same run)
        self.run_name = self.run_config.name or f"run-{uuid.uuid4().hex[:8]}"

    def fit(self) -> Result:
        attempts = self.run_config.failure_config.max_failures + 1
        restore_dir = None
        last_error = None
        failed_at = None
        for attempt in range(attempts):
            result = self._run_once(restore_dir, attempt,
                                    failed_at=failed_at)
            if result.error is None:
                return result
            last_error = result.error
            restore_dir = result.checkpoint_dir  # resume from last ckpt
            failed_at = time.monotonic()
        return Result(error=last_error, checkpoint_dir=restore_dir)

    def _shard(self, columns: dict, rank: int) -> DataIterator:
        """Rank ``rank``'s part of a dataset: its contiguous rows."""
        n = self.scaling.num_workers
        rows = len(next(iter(columns.values())))
        lo, hi = rank * rows // n, (rank + 1) * rows // n
        return DataIterator([{k: np.asarray(v)[lo:hi]
                              for k, v in columns.items()}])

    def _rank_configs(self) -> list:
        configs = []
        for rank in range(self.scaling.num_workers):
            config = dict(self.config)
            for name, columns in self.datasets.items():
                config[f"{name}_shard"] = self._shard(columns, rank)
            configs.append(config)
        return configs

    def _run_once(self, restore_dir: str | None, attempt: int,
                  failed_at: float | None = None) -> Result:
        trial_dir = os.path.join(
            self.run_config.resolved_storage_path(),
            f"attempt_{attempt}_{int(time.time())}")
        os.makedirs(trial_dir, exist_ok=True)
        env = {}
        if restore_dir:
            env["RAY_TPU_RESTORE_CHECKPOINT"] = restore_dir
        executor = BackendExecutor(self.scaling, env=env)
        if failed_at is not None:
            # retry attempt: the teardown->respawn gap is restart badput
            from ray_tpu_torch.train.telemetry import record_run_bucket

            record_run_bucket(self.run_name, "restart",
                              time.monotonic() - failed_at)
        manager = _TopKCheckpoints(self.run_config.checkpoint_config)
        result = Result()
        try:
            t_spawn = time.monotonic()
            executor.start_training(self.train_fn, self._rank_configs(),
                                    trial_dir, restore_checkpoint=restore_dir,
                                    run_name=self.run_name)
            done = False
            while not done:
                reports, done = executor.poll_reports()
                for rep in reports:
                    if "error" in rep:
                        result.error = result.error or rep["error"]
                        continue
                    if rep["rank"] != 0:
                        continue
                    if result.first_report_s is None:
                        result.first_report_s = time.monotonic() - t_spawn
                    result.metrics = rep["metrics"]
                    result.metrics_history.append(rep["metrics"])
                    if rep.get("checkpoint"):
                        manager.add(rep["checkpoint"], rep["metrics"])
        finally:
            executor.shutdown()
        result.rank_stats = executor.rank_stats()
        result.checkpoint_dir = manager.best() or manager.latest()
        return result


def mesh_train_loop(config: dict) -> None:
    """``TorchMeshTrainer``'s loop on each rank: ``Trainer`` over the
    rank's process group from ``Trainer.init_state(seed)``, ``steps``
    steps on global batches of ``batch_size`` rows, from the rank's
    dataset shard through the device feed (``iter_torch_batches``), else
    random tokens [batch_size, seq_len] seeded by the step. Declares the
    rank's FLOPs a step as JAX does (6 · parameters · batch elements), of
    its own work: its rows of the global batch, over the processes along
    tp (each its heads and mlp columns), along sp (each its chunk of
    the sequence) and along pp (each its stage's layers). Reports
    ``loss``, ``grad_norm`` and ``step`` each step."""
    import torch

    from ray_tpu_torch.train import session
    from ray_tpu_torch.train.optim import tree_leaves
    from ray_tpu_torch.train.trainer import Trainer

    ctx = session.get_context()
    model_cfg = config["model_config"]
    trainer = Trainer(model_cfg, config["train_config"], device=ctx.device,
                      process_group=ctx.process_group)
    state = trainer.init_state(seed=config.get("seed", 0))
    shard = config.get("train_shard")
    steps = config.get("steps", 10)
    batch_size = config.get("batch_size", 8)
    batch_iter = (shard.iter_torch_batches(
        batch_size=batch_size, device=trainer.device,
        dtypes={"tokens": torch.int64})
        if shard is not None else None)
    for step in range(steps):
        with session.timeit("data_wait"):
            if batch_iter is not None:
                try:
                    batch = next(batch_iter)["tokens"]
                except StopIteration:
                    break
            else:
                batch = torch.randint(
                    0, model_cfg.vocab_size,
                    (batch_size, config.get("seq_len", 128)),
                    generator=torch.Generator().manual_seed(step))
        if step == 0:
            n_params = sum(math.prod(x.shape)
                           for x in tree_leaves(state.params))
            # the rank's work: its rows (Trainer keeps them) of the batch,
            # over the processes along tp, sp and pp; the processes of one
            # line of any other spanned axis do the same work
            procs = trainer.mesh.layout.procs if trainer.mesh.layout \
                else {}
            share = math.prod(procs.get(a, 1) for a in {
                *trainer._rank_step().split_axes, "tp", "sp", "pp"})
            session.set_flops_per_step(6.0 * n_params * batch.numel()
                                       / share)
        state, metrics = trainer.train_step(state, batch)
        session.report({k: float(v) for k, v in metrics.items()})


class TorchMeshTrainer(DataParallelTrainer):
    """``ScalingConfig.num_workers`` ranks sharing the global mesh
    ``train_config.mesh_axes``, each running the mesh ``Trainer`` step on
    its places over its process group (the counterpart of
    ``JaxMeshTrainer``; reference: TorchTrainer). The world is the product
    of the processes along each spanned axis (an axis cut at the process
    boundary counts its processes, a run of its indices each): the
    layout is checked before any rank starts (``Trainer``'s
    ``_local_axes``: a mesh that does not deal into equal grid blocks
    raises). The
    configs travel in ``train_loop_config`` (``model_config``,
    ``train_config``, and ``seed``, ``steps``, ``batch_size``,
    ``seq_len``). With a dataset every rank reads the whole of it as
    global batches, and its ``Trainer`` keeps the rank's rows of each (the
    trainer's contract is the global batch; the rows it drops are token
    ids, a few kB a step)."""

    def __init__(self, model_config, train_config, **kw):
        config = dict(kw.pop("train_loop_config", None) or {})
        config.update(model_config=model_config, train_config=train_config)
        super().__init__(mesh_train_loop, train_loop_config=config, **kw)
        from ray_tpu_torch.train.trainer import _local_axes

        _local_axes(train_config.mesh_axes, self.scaling.num_workers,
                    train_config.strategy)

    def _shard(self, columns: dict, rank: int) -> DataIterator:
        return DataIterator([{k: np.asarray(v) for k, v in
                              columns.items()}])
