"""Trainables of the port's Tuner tests (``tests/test_torch_tune_runs.py``).

A trial's rank process receives its trainable by plain ``pickle``, so each
one is a module-level function of a module that imports neither jax nor
any ``ray_tpu`` module (the test file imports both). Every trainable runs
with one thread. ``objective`` mirrors the JAX trainable the test file
builds, report for report.
"""

import os

import torch


def score(config: dict, i: int) -> float:
    """A deterministic objective: best at ``x`` = 1, rising with ``i``."""
    return -(config["x"] - 1.0) ** 2 + 0.25 * i * config.get("slope", 1.0)


def objective(config):
    """``iters`` reports of ``score``, each with a checkpoint directory
    holding its iteration; a resumed run starts after the checkpoint's
    iteration and reports where it resumed from (``resumed_at``)."""
    torch.set_num_threads(1)
    from ray_tpu_torch.train import session

    ckpt = session.get_checkpoint_dir()
    start = 0
    if ckpt:
        with open(os.path.join(ckpt, "iteration")) as f:
            start = int(f.read())
    trial_dir = session.get_context().get_trial_dir()
    for i in range(start + 1, config["iters"] + 1):
        d = os.path.join(trial_dir, f"ckpt_{i}")
        os.makedirs(d, exist_ok=True)
        with open(os.path.join(d, "iteration"), "w") as f:
            f.write(str(i))
        session.report({"score": score(config, i), "i": i,
                        "resumed_at": start}, checkpoint_dir=d)
