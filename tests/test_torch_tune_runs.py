"""The port's ``Tuner`` runs trials in spawned rank processes on the CPU
(``ScalingConfig(num_workers=1, use_gpu=False)``), against the JAX
package's ``Tuner`` on its runtime.

- Serial runs (``max_concurrent_trials=1``, so that both orders are
  fixed): a grid search, TPE and ASHA over a deterministic objective
  give JAX's trial ids, configs, statuses, result lists and best trial
  (the port's trainable in ``tests/torch_tune_loops.py``, JAX's built
  here, report for report). Control: the port's TPE at another seed.
- ``Tuner.restore`` after an interrupted experiment re-runs only the
  unfinished trial, from its checkpoint, as JAX's does.
- PBT on ``llama_tiny`` (``ray_tpu_torch/examples/tune_llama.py``, one
  trial at a time): every trial ends TERMINATED and at least one is
  exploited; its first loss equals its donor's at that step, bit for bit.
  Control: the same trial started at that step without the restore. Each
  trial keeps its newest checkpoint alone (``num_to_keep=1``), and an
  exploit restarts from its own link of the donor's.
- A trainable that cannot be pickled is refused before any spawn.

Every ``fit`` is joined within LIMIT_S (its ranks killed on expiry) and
leaves no child process. The JAX runtime starts once, for the module.
"""

import json
import multiprocessing
import os
import threading

import pytest

import ray_tpu
import torch_tune_loops as loops
from ray_tpu import tune as jtune
from ray_tpu.air.config import RunConfig as JaxRunConfig
from ray_tpu_torch import tune as ttune
from ray_tpu_torch.air.config import RunConfig, ScalingConfig
from ray_tpu_torch.examples import tune_llama

LIMIT_S = 120.0
CPU = ScalingConfig(num_workers=1, use_gpu=False)


@pytest.fixture(scope="module")
def rt():
    ray_tpu.shutdown()
    ray_tpu.init(num_cpus=8, num_tpus=0)
    yield
    ray_tpu.shutdown()


def _fit(fit):
    """``fit()`` within LIMIT_S: on expiry every child process is killed
    and the test fails. Afterwards no child process is left."""
    box = {}

    def run():
        try:
            box["result"] = fit()
        except BaseException as e:  # noqa: BLE001 - re-raised below
            box["error"] = e

    t = threading.Thread(target=run, daemon=True)
    t.start()
    t.join(LIMIT_S)
    if t.is_alive():
        for p in multiprocessing.active_children():
            p.kill()
        pytest.fail(f"fit() did not finish within {LIMIT_S} s")
    assert multiprocessing.active_children() == []
    if "error" in box:
        raise box["error"]
    return box["result"]


def _jax_objective():
    """JAX's counterpart of ``loops.objective``: a nested function, so the
    JAX runtime ships it by value (cloudpickle)."""

    def objective(config):
        import os

        from ray_tpu.train import session

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
            score = -(config["x"] - 1.0) ** 2 + 0.25 * i * config.get(
                "slope", 1.0)
            session.report({"score": score, "i": i, "resumed_at": start},
                           checkpoint_dir=d)

    return objective


def _case(m, name, seed=0):
    """(param_space, TuneConfig) of one serial case, from module ``m``
    (``ray_tpu.tune`` or ``ray_tpu_torch.tune``)."""
    if name == "grid":
        return ({"x": m.grid_search([0.0, 1.5]), "iters": 2},
                m.TuneConfig(metric="score", mode="max",
                             max_concurrent_trials=1))
    if name == "tpe":
        # one random trial, then one from the model of its result
        return ({}, m.TuneConfig(
            metric="score", mode="max", max_concurrent_trials=1,
            search_alg=m.TPESearcher(
                {"x": m.uniform(-2.0, 3.0), "iters": 1}, metric="score",
                mode="max", num_samples=2, n_startup=1, seed=seed)))
    # the later, weaker trials fall below the first rung's cut
    return ({"x": m.grid_search([1.0, 1.5, 0.0]), "iters": 4},
            m.TuneConfig(metric="score", mode="max",
                         max_concurrent_trials=1,
                         scheduler=m.AsyncHyperBandScheduler(
                             metric="score", mode="max", grace_period=1,
                             max_t=5, reduction_factor=2)))


def _summary(grid) -> dict:
    return {"trials": [(t.trial_id, t.config, t.status, t.results)
                       for t in grid],
            "best": grid.get_best_result("score", "max").trial_id}


@pytest.fixture(scope="module")
def serial_runs(rt, tmp_path_factory):
    """Each serial case run by JAX's Tuner and by the port's; the grid
    case's experiment directories are kept for the restore test."""
    out = {}
    for name in ("grid", "tpe", "asha"):
        jdir = str(tmp_path_factory.mktemp(f"jax_{name}"))
        tdir = str(tmp_path_factory.mktemp(f"torch_{name}"))
        space, cfg = _case(jtune, name)
        jgrid = jtune.Tuner(_jax_objective(), param_space=space,
                            tune_config=cfg,
                            run_config=JaxRunConfig(storage_path=jdir)).fit()
        space, cfg = _case(ttune, name)
        tgrid = _fit(ttune.Tuner(loops.objective, param_space=space,
                                 tune_config=cfg,
                                 run_config=RunConfig(storage_path=tdir),
                                 scaling_config=CPU).fit)
        out[name] = (jgrid, tgrid, jdir, tdir)
    return out


@pytest.mark.parametrize("name", ["grid", "tpe", "asha"])
def test_serial_tuner_matches_jax(serial_runs, name):
    jgrid, tgrid, _, _ = serial_runs[name]
    assert _summary(tgrid) == _summary(jgrid)
    statuses = {t.status for t in tgrid}
    if name == "asha":
        # the rungs halt the weak trials: both decisions occur
        assert statuses == {"TERMINATED", "STOPPED"}
    else:
        assert statuses == {"TERMINATED"}
    if name == "tpe":
        # the second trial came from the model of the first's result
        assert len(tgrid) == 2


def test_serial_tuner_control(serial_runs, tmp_path):
    """The port's TPE at another seed leaves JAX's first trial."""
    jgrid = serial_runs["tpe"][0]
    space, cfg = _case(ttune, "tpe", seed=1)
    cfg.search_alg.budget = 1
    tgrid = _fit(ttune.Tuner(loops.objective, param_space=space,
                             tune_config=cfg,
                             run_config=RunConfig(storage_path=str(tmp_path)),
                             scaling_config=CPU).fit)
    assert _summary(tgrid)["trials"][0] != _summary(jgrid)["trials"][0]


def _interrupt(exp: str, trial: int) -> None:
    """Mark one trial of a finished experiment as still running on disk,
    its last checkpoint the one after its first report."""
    path = os.path.join(exp, "experiment_state.json")
    with open(path) as f:
        state = json.load(f)
    state[trial]["status"] = "RUNNING"
    state[trial]["checkpoint_dir"] = state[trial]["checkpoint_dir"].replace(
        "ckpt_2", "ckpt_1")
    with open(path, "w") as f:
        json.dump(state, f)


def test_restore_resumes_only_unfinished_trials(serial_runs):
    """An interrupted experiment re-runs only its unfinished trial, from
    the trial's last checkpoint; finished trials keep their results and
    do not run again, as in JAX's Tuner.restore."""
    _, _, jdir, tdir = serial_runs["grid"]
    _interrupt(jdir, 0)
    _interrupt(tdir, 0)
    jgrid = jtune.Tuner.restore(jdir, _jax_objective()).fit()
    tgrid = _fit(ttune.Tuner.restore(tdir, loops.objective,
                                     scaling_config=CPU).fit)
    got = [(t.trial_id, t.config, t.status, t.last_result, t.results)
           for t in tgrid]
    assert got == [(t.trial_id, t.config, t.status, t.last_result, t.results)
                   for t in jgrid]
    resumed, kept = tgrid.trials
    assert [(r["i"], r["resumed_at"]) for r in resumed.results] == [(2, 1)]
    assert [t.status for t in tgrid] == ["TERMINATED"] * 2
    assert kept.results == [] and kept.last_result["i"] == 2


def test_pbt_exploit_restores_the_donor_bit_for_bit(tmp_path):
    # one trial at a time: the fourth (the worst) reports last, when the
    # population is whole, so its first report is exploited (two at a
    # time, a CPU trial's few seconds race its sibling's start-up)
    grid = _fit(lambda: tune_llama.main(device="cpu",
                                        storage_path=str(tmp_path),
                                        max_concurrent_trials=1))
    assert [t.status for t in grid] == ["TERMINATED"] * 4
    found = tune_llama.exploits(grid)
    assert found, [t.results for t in grid]
    # retention (num_to_keep=1): each trial's newest checkpoint alone is
    # left on disk; an exploit restarted from its own link of the donor's
    for t in grid:
        on_disk = sorted(os.path.join(str(tmp_path), t.trial_id, d)
                         for d in os.listdir(tmp_path / t.trial_id)
                         if d.startswith(("checkpoint_", "exploit_")))
        assert on_disk == t.checkpoints == [t.checkpoint_dir]
        for e in t.exploits:
            assert e["restored_from"].startswith(
                os.path.join(str(tmp_path), t.trial_id, "exploit_"))
    for trial, donor, step, loss, want in found:
        assert trial is not donor
        assert loss == want, (trial.trial_id, donor.trial_id, step)
        # control: the same trial started at that step without the
        # restore (from its init), on the same batch
        config = trial.config
        trainer = tune_llama.trial_trainer(config, "cpu")
        state = tune_llama.trial_start(trainer, config, None, "cpu")
        _, m = trainer.train_step(state,
                                  tune_llama.trial_batch(config, step, "cpu"))
        skipped = float(m["loss"])
        assert abs(skipped - want) > 1e-2 * abs(want), (skipped, want)


def _local_trainable():
    def trainable(config):
        pass

    return trainable


@pytest.mark.parametrize("make", [lambda: (lambda config: None),
                                  _local_trainable],
                         ids=["lambda", "nested_function"])
def test_unpicklable_trainable_is_refused_before_any_spawn(make, tmp_path):
    with pytest.raises(TypeError, match="pickle"):
        ttune.Tuner(make(), param_space={"x": ttune.grid_search([1, 2])},
                    run_config=RunConfig(storage_path=str(tmp_path)),
                    scaling_config=CPU)
    assert multiprocessing.active_children() == []
    assert os.listdir(tmp_path) == []


def test_trials_default_to_the_card(tmp_path):
    """A trial defaults to one rank on the card: without one, ``fit``
    raises before any rank starts."""
    import torch

    tuner = ttune.Tuner(loops.objective, param_space={"x": 1.0, "iters": 1},
                        run_config=RunConfig(storage_path=str(tmp_path)))
    assert tuner.scaling_config == ScalingConfig(num_workers=1)
    assert tuner.scaling_config.use_gpu is True
    with pytest.raises(ValueError, match="num_workers=1"):
        ttune.Tuner(loops.objective, scaling_config=ScalingConfig(
            num_workers=2, use_gpu=False))
    if torch.cuda.is_available():
        return
    with pytest.raises(RuntimeError, match="card"):
        tuner.fit()
    assert multiprocessing.active_children() == []
