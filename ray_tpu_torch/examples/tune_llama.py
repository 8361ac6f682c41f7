"""Quickstart: population-based training of a Llama's learning rate.

    python -m ray_tpu_torch.examples.tune_llama

A ``Tuner`` with ``PopulationBasedTraining`` over ``learning_rate``: each
trial is one rank process (``tune/tuner.py``) that trains a Llama with
``Trainer`` on token batches keyed by the step number, and every
``report_every`` steps reports its losses with a checkpoint of its whole
state (``train/checkpoint.py``). PBT's exploit restarts a trial in a new
process from its donor's checkpoint with an explored learning rate; the
restored state and the donor's next batch give the donor's loss at that
step. No checkpoint is written after the last step: no step is left to
restart from it.

The batches draw their tokens from the first ``token_range`` ids of the
vocabulary, so a few steps of training move the loss far from a fresh
model's (a unigram the model can learn). Runs on the card;
``main(device="cpu")`` runs the trials on the CPU.

The trainable reaches its rank process by plain pickle: ``pbt_trainable``
is a module-level function, and its settings travel in the config
(``preset``, ``n_layers``, ``learning_rate``, ``steps``, ``report_every``,
``batch_size``, ``seq_len``, ``token_range``, ``seed``, and ``threads``
for torch's intra-op threads of a CPU trial).
"""

from __future__ import annotations

import dataclasses
import os
import time

import numpy as np

# PBT's settings: a decision every 2 steps (PBT's clock is the reported
# ``step``, so a restarted trial keeps its donor's), the worst quarter
# exploits the best quarter, learning rates explored by 0.8x or 1.2x
PERTURBATION_INTERVAL = 2
QUANTILE = 0.25
# trials at once: two states of a depth-2 Llama-3-8B share one card
CONCURRENT_TRIALS = 2


def model_config(config: dict):
    """The config's Llama: a preset of ``models.llama``, cut to
    ``n_layers`` when given."""
    from ray_tpu_torch.models import llama

    cfg = getattr(llama, config["preset"])()
    if config.get("n_layers"):
        cfg = dataclasses.replace(cfg, n_layers=config["n_layers"])
    return cfg


def trial_trainer(config: dict, device):
    """The trial's ``Trainer``: AdamW at the config's learning rate, no
    warmup, the fused loss."""
    from ray_tpu_torch.train.trainer import TrainConfig, Trainer

    return Trainer(model_config(config), TrainConfig(
        learning_rate=config["learning_rate"], warmup_steps=0,
        total_steps=1000, fused_loss=True, loss_chunk=1024), device=device)


def trial_batch(config: dict, step: int, device):
    """Step ``step``'s [batch_size, seq_len + 1] tokens: the same for every
    trial, drawn from ``token_range`` ids by a generator keyed by the
    config's seed and the step."""
    import torch

    rng = np.random.default_rng([config.get("seed", 0), step])
    tokens = rng.integers(0, config["token_range"],
                          (config["batch_size"], config["seq_len"] + 1))
    return torch.from_numpy(tokens.astype(np.int64)).to(device)


def trial_start(trainer, config: dict, restore_dir: str | None, device):
    """The state a trial starts from and its step: restored from
    ``restore_dir`` (a checkpoint of ``pbt_trainable``), or
    ``init_state(seed)`` at step 0."""
    from ray_tpu_torch.train.checkpoint import CheckpointManager

    if restore_dir is None:
        return trainer.init_state(seed=config.get("seed", 0))
    manager = CheckpointManager(restore_dir, async_save=False)
    try:
        return manager.restore(device=device)
    finally:
        manager.close()


def pbt_trainable(config: dict) -> None:
    """One trial: train ``steps`` steps from the restored checkpoint or
    from scratch, reporting every ``report_every`` steps ``loss`` (the
    last step's), ``losses`` (each step's since the last report, from
    ``first_step``), ``step``, the checkpoint ``saved`` with the report
    ("" after the last step), ``restored_from`` and ``restore_s``, each
    step's seconds and kernel launches (K1 ``flash_fwd``, the fused
    backward ``flash_bwd``), and ``run``, the process's id."""
    import torch

    from ray_tpu_torch.ops.flash_attention import flash_bwd, flash_fwd
    from ray_tpu_torch.train import session
    from ray_tpu_torch.train.checkpoint import CheckpointManager

    if config.get("threads"):
        torch.set_num_threads(config["threads"])
    ctx = session.get_context()
    device = torch.device(ctx.device)
    restore_dir = session.get_checkpoint_dir()
    trainer = trial_trainer(config, device)
    t0 = time.perf_counter()
    state = trial_start(trainer, config, restore_dir, device)
    restore_s = time.perf_counter() - t0 if restore_dir else None
    steps, every = config["steps"], config["report_every"]
    first = state.step
    losses, step_s, fwd, bwd = [], [], [], []
    for step in range(first, steps):
        batch = trial_batch(config, step, device)
        flash_fwd.launches = flash_bwd.launches = 0
        t0 = time.perf_counter()
        state, metrics = trainer.train_step(state, batch)
        losses.append(float(metrics["loss"]))   # waits for the step
        step_s.append(time.perf_counter() - t0)
        fwd.append(flash_fwd.launches)
        bwd.append(flash_bwd.launches)
        if state.step % every and state.step != steps:
            continue
        saved, save_s = "", None
        if state.step < steps:
            saved = os.path.join(ctx.trial_dir, f"checkpoint_{state.step:06d}"
                                 f"_{os.getpid()}")
            t0 = time.perf_counter()
            manager = CheckpointManager(saved, max_to_keep=0,
                                        async_save=False)
            manager.save(state.step, state)
            manager.close()
            save_s = time.perf_counter() - t0
        session.report({
            "loss": losses[-1], "losses": losses,
            "first_step": state.step - len(losses), "step": state.step,
            "learning_rate": config["learning_rate"], "saved": saved,
            "restored_from": restore_dir or "", "restore_s": restore_s,
            "save_s": save_s, "step_s": step_s,
            "launches": {"flash_fwd": fwd, "flash_bwd": bwd},
            "run": os.getpid(), "device": str(device)},
            checkpoint_dir=saved or None)
        losses, step_s, fwd, bwd = [], [], [], []


def pbt_tuner(base: dict, learning_rates, *, storage_path: str,
              use_gpu: bool = True,
              max_concurrent_trials: int = CONCURRENT_TRIALS, callbacks=()):
    """A ``Tuner`` of ``pbt_trainable``: one trial a learning rate (a grid,
    in order), ``base`` the rest of each trial's config, PBT minimizing
    ``loss`` (module constants), each trial one rank on the card
    (``use_gpu``) or the CPU, ``max_concurrent_trials`` at once (one at a
    time fixes the order of every report, so which trial is exploited). Each trial keeps only
    its newest checkpoint (``num_to_keep=1``): a trial at Llama-3-8B's
    widths writes 9 GB a checkpoint."""
    from ray_tpu_torch.air.config import (CheckpointConfig, RunConfig,
                                          ScalingConfig)
    from ray_tpu_torch.tune import (PopulationBasedTraining, TuneConfig,
                                    Tuner, grid_search, uniform)

    lrs = list(learning_rates)
    scheduler = PopulationBasedTraining(
        metric="loss", mode="min",
        perturbation_interval=PERTURBATION_INTERVAL,
        hyperparam_mutations={"learning_rate": uniform(min(lrs), max(lrs))},
        quantile_fraction=QUANTILE, seed=0, time_attr="step")
    return Tuner(
        pbt_trainable,
        param_space={**base, "learning_rate": grid_search(lrs)},
        tune_config=TuneConfig(metric="loss", mode="min", scheduler=scheduler,
                               max_concurrent_trials=max_concurrent_trials,
                               callbacks=list(callbacks)),
        run_config=RunConfig(storage_path=storage_path,
                             checkpoint_config=CheckpointConfig(
                                 num_to_keep=1)),
        scaling_config=ScalingConfig(num_workers=1, use_gpu=use_gpu))


def exploits(grid) -> list:
    """Each exploit of a finished experiment (``Trial.exploits``):
    ``(trial, donor, step, first loss, donor's loss at that step)``: the
    first loss the restarted process reported, and the donor's loss on
    the same step, from the donor's report after that checkpoint."""
    by_dir = {r["saved"]: (t, i) for t in grid
              for i, r in enumerate(t.results) if r["saved"]}
    out = []
    for t in grid:
        starts = {}
        for r in t.results:   # each process's first report
            if r["restored_from"]:
                starts.setdefault(r["run"], r)
        starts = {r["restored_from"]: r for r in starts.values()}
        for e in t.exploits:
            r = starts.get(e["restored_from"])
            if r is None:
                raise AssertionError(f"{t.trial_id} restarted from "
                                     f"{e['restored_from']} reported nothing")
            donor, i = by_dir[e["checkpoint"]]
            after = donor.results[i + 1]
            if r["first_step"] != after["first_step"]:
                raise AssertionError(
                    f"{t.trial_id} restarted at step {r['first_step']} from "
                    f"{donor.trial_id}, whose next report starts at step "
                    f"{after['first_step']}")
            out.append((t, donor, r["first_step"], r["losses"][0],
                        after["losses"][0]))
    return out


def main(device="cuda", storage_path: str | None = None,
         max_concurrent_trials: int = CONCURRENT_TRIALS):
    """PBT of four ``llama_tiny`` trials, ``max_concurrent_trials`` at a
    time; returns the ``ResultGrid`` and prints each exploit."""
    import tempfile

    # trials on the CPU take one thread each: two at once would contend
    base = {"preset": "llama_tiny", "n_layers": None, "steps": 6,
            "report_every": 2, "batch_size": 2, "seq_len": 64,
            "token_range": 16, "seed": 0,
            "threads": 1 if device == "cpu" else None}
    with tempfile.TemporaryDirectory() as d:
        grid = pbt_tuner(base, [1e-3, 3e-3, 1e-2, 1e-7],
                         storage_path=storage_path or d,
                         use_gpu=device != "cpu",
                         max_concurrent_trials=max_concurrent_trials).fit()
    for t in grid:
        print(t.trial_id, t.status, f"lr {t.config['learning_rate']:.3g}",
              [round(r["loss"], 4) for r in t.results])
    for t, donor, step, loss, want in exploits(grid):
        print(f"{t.trial_id} exploited {donor.trial_id} at step {step}: "
              f"loss {loss:.6f}, the donor's {want:.6f}")
    return grid


if __name__ == "__main__":
    main()
