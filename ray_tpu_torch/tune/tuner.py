"""Tuner + trial-driving controller.

Port of ``ray_tpu/tune/tuner.py`` (reference: ``python/ray/tune/
tuner.py``, ``Tuner:59``, and ``tune/execution/tune_controller.py``,
``TuneController:80``). The controller keeps the JAX package's loop: it
starts trials up to the concurrency cap, drains every running trial's
reports and processes them round-robin, one report at a time, applies the
scheduler's decisions (ASHA halting, PBT's exploit, which restarts a trial
from its donor's checkpoint with an explored config) and writes the
experiment's state for ``Tuner.restore``.

Where it differs:

- A trial is a one-rank ``train.worker_group.BackendExecutor`` of the
  port: one spawned process over ``torch.distributed``. Its config is
  the one config of that rank.
- A trial runs on the card by default: its ``ScalingConfig(num_workers=1)``
  asks for ``use_gpu=True``, one NCCL rank (several such trials may share
  one card: each is a world of its own). ``scaling_config=ScalingConfig(
  num_workers=1, use_gpu=False)`` runs the trials on the CPU over gloo,
  as ``PPOConfig.device="cpu"`` does for RLlib.
- The trainable reaches the rank by plain ``pickle``, not cloudpickle: it
  is a module-level function or a ``functools.partial`` of one, with its
  settings in the trial's config. ``Tuner`` refuses one that cannot be
  pickled before any trial starts.
- A report is the port's ``{"rank", "metrics", "checkpoint"}`` (a
  checkpoint directory or None), or ``{"rank", "error"}`` for a rank that
  failed (``BackendExecutor.poll_reports``).
- ``RunConfig.checkpoint_config.num_to_keep`` keeps each trial's newest
  checkpoints and deletes the older ones as their successors' reports
  arrive (None, the default, keeps every one, as the JAX package's Tuner
  does): a PBT population of large models cannot hold every checkpoint
  it writes. Under it an exploit first links the donor's checkpoint into
  the exploited trial's directory (hard links; a copy where a link cannot
  be made), so the donor's retention cannot delete it while the trial
  restarts. Each trial records its exploits (``Trial.exploits``: the
  donor, its checkpoint and the one the trial restarts from).
"""

from __future__ import annotations

import json
import os
import pickle
import shutil
import time
from dataclasses import dataclass, field
from typing import Any, Callable

from ray_tpu_torch.air.config import RunConfig, ScalingConfig
from ray_tpu_torch.train.worker_group import BackendExecutor
from ray_tpu_torch.tune.schedulers import STOP, FIFOScheduler
from ray_tpu_torch.tune.search import BasicVariantGenerator


@dataclass
class TuneConfig:
    metric: str | None = None
    mode: str = "max"
    num_samples: int = 1
    max_concurrent_trials: int = 4
    scheduler: Any = None
    # adaptive searcher (Searcher: suggest/on_trial_complete); when set,
    # trials are created on demand from its suggestions instead of
    # pre-expanding the param space (reference: search_alg in TuneConfig)
    search_alg: Any = None
    seed: int | None = None
    time_attr: str = "training_iteration"
    # Callback objects with optional on_trial_start/on_trial_result/
    # on_trial_complete hooks (reference: tune/callback.py)
    callbacks: list = field(default_factory=list)


@dataclass
class Trial:
    trial_id: str
    config: dict
    status: str = "PENDING"   # PENDING | RUNNING | TERMINATED | STOPPED | ERROR
    last_result: dict = field(default_factory=dict)
    results: list = field(default_factory=list)
    iteration: int = 0
    executor: Any = None
    error: str | None = None
    checkpoint_dir: str | None = None
    # resume this trial from checkpoint_dir when (re)started
    restore_from_checkpoint: bool = False
    # the port's: the checkpoints retention keeps, oldest first, and each
    # exploit's {"donor", "checkpoint", "restored_from"}
    checkpoints: list = field(default_factory=list)
    exploits: list = field(default_factory=list)


@dataclass
class ResultGrid:
    trials: list[Trial]

    def get_best_result(self, metric: str, mode: str = "max") -> Trial:
        scored = [t for t in self.trials if metric in t.last_result]
        if not scored:
            raise ValueError(f"no trial reported metric {metric!r}")
        key = lambda t: float(t.last_result[metric])  # noqa: E731
        return max(scored, key=key) if mode == "max" else min(scored, key=key)

    def __iter__(self):
        return iter(self.trials)

    def __len__(self):
        return len(self.trials)


def _check_picklable(trainable: Callable) -> None:
    """Refuse, before any trial starts, a trainable that cannot reach a
    rank process by plain pickle."""
    try:
        pickle.dumps(trainable)
    except (pickle.PicklingError, AttributeError, TypeError) as e:
        raise TypeError(
            f"the trainable {trainable!r} cannot be pickled ({e}): a "
            "trial's rank process receives it by plain pickle, so pass a "
            "module-level function or a functools.partial of one, with "
            "its settings in param_space") from e


class Tuner:
    """``scaling_config``: the resources of each trial, one rank
    (default ``ScalingConfig(num_workers=1)``, on the card;
    ``use_gpu=False`` for the CPU). ``trainable(config)`` runs in the
    trial's rank process and reports through ``train.session.report``
    (module docstring: it must pickle)."""

    def __init__(self, trainable: Callable, *, param_space: dict | None = None,
                 tune_config: TuneConfig | None = None,
                 run_config: RunConfig | None = None,
                 scaling_config: ScalingConfig | None = None):
        _check_picklable(trainable)
        self.trainable = trainable
        self.param_space = param_space or {}
        self.tune_config = tune_config or TuneConfig()
        self.run_config = run_config or RunConfig()
        self.scaling_config = scaling_config or ScalingConfig(num_workers=1)
        if self.scaling_config.num_workers != 1:
            raise ValueError("a trial is one rank: scaling_config must have "
                             "num_workers=1")

    def fit(self) -> ResultGrid:
        if self._restored_trials is not None:
            # Tuner.restore(...).fit() continues the experiment —
            # mirrors the reference pairing; fit_restored stays as an
            # explicit alias
            return self.fit_restored()
        if self.tune_config.search_alg is not None:
            trials: list[Trial] = []  # created on demand by the controller
        else:
            variants = BasicVariantGenerator(
                self.param_space, num_samples=self.tune_config.num_samples,
                seed=self.tune_config.seed).variants()
            trials = [Trial(trial_id=f"trial_{i:05d}", config=cfg)
                      for i, cfg in enumerate(variants)]
        controller = TuneController(
            self.trainable, trials, self.tune_config, self.run_config,
            self.scaling_config)
        controller.run()
        return ResultGrid(controller.trials)

    @classmethod
    def restore(cls, path: str, trainable: Callable, *,
                tune_config: TuneConfig | None = None,
                scaling_config: ScalingConfig | None = None) -> "Tuner":
        """Resume an interrupted experiment from its state file
        (reference: ``Tuner.restore`` + ``tune/execution/
        experiment_state.py``). Finished trials keep their results;
        unfinished ones re-run, resuming from their last checkpoint."""
        state_file = os.path.join(path, "experiment_state.json")
        with open(state_file) as f:
            state = json.load(f)
        tuner = cls(trainable, tune_config=tune_config,
                    run_config=RunConfig(storage_path=path),
                    scaling_config=scaling_config)
        restored = []
        for t in state:
            trial = Trial(trial_id=t["trial_id"], config=t["config"],
                          status=t["status"],
                          last_result=t.get("last_result") or {},
                          checkpoint_dir=t.get("checkpoint_dir"))
            if trial.status in ("PENDING", "RUNNING", "ERROR"):
                trial.status = "PENDING"
                trial.restore_from_checkpoint = True
            restored.append(trial)
        tuner._restored_trials = restored
        return tuner

    _restored_trials: list | None = None

    def fit_restored(self) -> ResultGrid:
        """Continue a restored experiment (fit() for Tuner.restore)."""
        if self._restored_trials is None:
            raise RuntimeError("fit_restored needs a Tuner from "
                               "Tuner.restore")
        controller = TuneController(
            self.trainable, self._restored_trials, self.tune_config,
            self.run_config, self.scaling_config)
        controller.run(only_pending=True)
        return ResultGrid(controller.trials)


class TuneController:
    """Event loop: start trials up to the concurrency cap, drain reports,
    ask the scheduler about each result, stop/exploit accordingly."""

    def __init__(self, trainable, trials, tune_config: TuneConfig,
                 run_config: RunConfig,
                 scaling_config: ScalingConfig | None = None):
        self.trainable = trainable
        self.trials = trials
        self.cfg = tune_config
        self.run_config = run_config
        self.scaling = scaling_config or ScalingConfig(num_workers=1)
        self.scheduler = tune_config.scheduler or FIFOScheduler()
        self.exp_dir = run_config.resolved_storage_path()
        os.makedirs(self.exp_dir, exist_ok=True)

    # -- trial lifecycle -------------------------------------------------
    def _start(self, trial: Trial):
        trial.executor = BackendExecutor(self.scaling)
        trial_dir = os.path.join(self.exp_dir, trial.trial_id)
        os.makedirs(trial_dir, exist_ok=True)
        restore = (trial.checkpoint_dir
                   if trial.restore_from_checkpoint else None)
        trial.restore_from_checkpoint = False
        trial.executor.start_training(self.trainable, [dict(trial.config)],
                                      trial_dir,
                                      restore_checkpoint=restore,
                                      run_name=trial.trial_id)
        trial.status = "RUNNING"
        self._callback("on_trial_start", trial)

    def _callback(self, hook: str, trial: Trial, result: dict | None = None):
        for cb in self.cfg.callbacks:
            fn = getattr(cb, hook, None)
            if fn is not None:
                fn(trial, result) if result is not None else fn(trial)

    def _stop(self, trial: Trial, status: str):
        if trial.executor is not None:
            trial.executor.shutdown()
            trial.executor = None
        trial.status = status

    def _exploit(self, trial: Trial, donor: Trial):
        """PBT exploit: adopt donor's (explored) config + checkpoint and
        restart from it (reference: pbt.py _exploit)."""
        explored = self.scheduler.explore(dict(donor.config))
        self._stop(trial, "PENDING")
        trial.config = explored
        trial.checkpoint_dir = donor.checkpoint_dir
        if donor.checkpoint_dir is not None and self._keep():
            trial.checkpoint_dir = os.path.join(
                self.exp_dir, trial.trial_id,
                f"exploit_{len(trial.exploits)}_{donor.trial_id}")
            shutil.copytree(donor.checkpoint_dir, trial.checkpoint_dir,
                            copy_function=_link_or_copy)
            self._retain(trial, trial.checkpoint_dir)
        trial.exploits.append({"donor": donor.trial_id,
                               "checkpoint": donor.checkpoint_dir,
                               "restored_from": trial.checkpoint_dir})
        trial.restore_from_checkpoint = donor.checkpoint_dir is not None
        trial.iteration = 0

    def _keep(self) -> int | None:
        return self.run_config.checkpoint_config.num_to_keep

    def _retain(self, trial: Trial, checkpoint: str):
        """Add ``checkpoint`` to the trial's, deleting its oldest beyond
        ``num_to_keep`` (module docstring)."""
        trial.checkpoints.append(checkpoint)
        keep = self._keep()
        while keep and len(trial.checkpoints) > keep:
            shutil.rmtree(trial.checkpoints.pop(0), ignore_errors=True)

    # -- event loop ------------------------------------------------------
    def run(self, only_pending: bool = False):
        pending = [t for t in self.trials
                   if not only_pending or t.status == "PENDING"]
        running: list[Trial] = []
        try:
            self._loop(pending, running)
        finally:
            # an error in a callback or a scheduler leaves no rank running
            for trial in running:
                if trial.executor is not None:
                    trial.executor.shutdown()
        self._save_state()

    def _loop(self, pending: list, running: list):
        search = self.cfg.search_alg
        next_id = len(self.trials)
        while pending or running or search is not None:
            # adaptive search: pull new suggestions up to the cap
            while (search is not None
                   and len(running) + len(pending)
                   < self.cfg.max_concurrent_trials):
                tid = f"trial_{next_id:05d}"
                cfg = search.suggest(tid)
                if cfg is None:
                    if not running and not pending:
                        search = None  # budget exhausted: drain and exit
                    break
                next_id += 1
                t = Trial(trial_id=tid, config=cfg)
                self.trials.append(t)
                pending.append(t)
            if search is None and not pending and not running:
                break
            while pending and len(running) < self.cfg.max_concurrent_trials:
                trial = pending.pop(0)
                self._start(trial)
                running.append(trial)
            set_pop = getattr(self.scheduler, "set_population", None)
            if set_pop is not None:
                set_pop({t.trial_id for t in self.trials
                         if t.status in ("PENDING", "RUNNING")}
                        | {t.trial_id for t in running})
            time.sleep(0.02)
            # Drain every running trial's reports, then process them
            # ROUND-ROBIN one report at a time. Per-trial batch
            # processing would let a fast trial replay its whole history
            # before a sibling's first report is seen, which collapses
            # population-based scheduler decisions (HyperBand rungs, PBT
            # quantiles) to single-trial populations.
            drained: dict = {}
            for trial in list(running):
                reports, done = trial.executor.poll_reports()
                drained[trial.trial_id] = [list(reports), done]
            progressed = True
            while progressed:
                progressed = False
                for trial in list(running):
                    slot = drained.get(trial.trial_id)
                    if not slot or not slot[0]:
                        continue
                    rep = slot[0].pop(0)
                    progressed = True
                    if "error" in rep:
                        trial.error = rep["error"]
                        continue
                    trial.iteration += 1
                    result = dict(rep["metrics"])
                    result.setdefault(self.cfg.time_attr, trial.iteration)
                    trial.last_result = result
                    trial.results.append(result)
                    if rep.get("checkpoint"):
                        trial.checkpoint_dir = rep["checkpoint"]
                        self._retain(trial, rep["checkpoint"])
                    if self.cfg.search_alg is not None:
                        self.cfg.search_alg.on_trial_result(
                            trial.trial_id, result)
                    self._callback("on_trial_result", trial, result)
                    decision = self.scheduler.on_result(trial, result)
                    if decision == STOP:
                        self._stop(trial, "STOPPED")
                        running.remove(trial)
                        drained.pop(trial.trial_id, None)
                        self._trial_over(trial)
                    elif (isinstance(decision, tuple)
                          and decision[0] == "EXPLOIT"):
                        donor = next((t for t in self.trials
                                      if t.trial_id == decision[1]), None)
                        if donor is not None and donor is not trial:
                            self._exploit(trial, donor)
                            running.remove(trial)
                            drained.pop(trial.trial_id, None)
                            pending.append(trial)
            for trial in list(running):
                slot = drained.get(trial.trial_id)
                if slot and slot[1]:  # done and all reports consumed
                    self._stop(trial,
                               "ERROR" if trial.error else "TERMINATED")
                    running.remove(trial)
                    self._trial_over(trial)
            self._save_state()

    def _trial_over(self, trial: Trial):
        if self.cfg.search_alg is not None:
            self.cfg.search_alg.on_trial_complete(
                trial.trial_id, trial.last_result or None,
                error=trial.status == "ERROR")
        gone = getattr(self.scheduler, "on_trial_gone", None)
        if gone is not None:
            gone(trial.trial_id)
        self._callback("on_trial_complete", trial)

    def _save_state(self):
        state = [{"trial_id": t.trial_id, "status": t.status,
                  "config": _jsonable(t.config),
                  "last_result": _jsonable(t.last_result),
                  "checkpoint_dir": t.checkpoint_dir}
                 for t in self.trials]
        with open(os.path.join(self.exp_dir, "experiment_state.json"),
                  "w") as f:
            json.dump(state, f)


def _link_or_copy(src: str, dst: str) -> None:
    try:
        os.link(src, dst)
    except OSError:
        shutil.copy2(src, dst)


def _jsonable(d: dict) -> dict:
    out = {}
    for k, v in d.items():
        try:
            json.dumps(v)
            out[k] = v
        except TypeError:
            out[k] = repr(v)
    return out
