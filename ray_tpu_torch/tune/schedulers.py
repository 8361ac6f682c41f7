"""Trial schedulers: early stopping + population-based training.

Port of ``ray_tpu/tune/schedulers.py``, kept as a copy of its own (the
port imports no module of ``ray_tpu``): host code on ``random.Random``,
unchanged, so the same reports and seed give the same decisions as the
JAX package's, bit for bit.

Reference analog: ``python/ray/tune/schedulers/`` —
``AsyncHyperBandScheduler`` (async_hyperband.py:19, ASHA rung-based
promotion/halting), ``MedianStoppingRule``, and ``PopulationBasedTraining``
(pbt.py:222, exploit bottom quantile from top quantile + perturb)."""

from __future__ import annotations

import math
import random
from typing import Any

CONTINUE = "CONTINUE"
STOP = "STOP"


class FIFOScheduler:
    def on_result(self, trial, result: dict) -> str:
        return CONTINUE


class AsyncHyperBandScheduler:
    """ASHA: rungs at grace_period * reduction_factor^k; a trial reaching a
    rung halts unless its metric is in the top 1/reduction_factor of
    completions at that rung."""

    def __init__(self, *, metric: str, mode: str = "max",
                 grace_period: int = 1, max_t: int = 100,
                 reduction_factor: int = 3, time_attr: str = "training_iteration"):
        self.metric = metric
        self.mode = mode
        self.time_attr = time_attr
        self.max_t = max_t
        self.rungs: list[tuple[int, list]] = []
        t = grace_period
        while t < max_t:
            self.rungs.append((t, []))
            t *= reduction_factor
        self.rf = reduction_factor

    def _val(self, result):
        v = float(result[self.metric])
        return v if self.mode == "max" else -v

    def on_result(self, trial, result: dict) -> str:
        t = int(result.get(self.time_attr, 0))
        if t >= self.max_t:
            return STOP
        for rung_t, recorded in self.rungs:
            if t == rung_t:
                value = self._val(result)
                recorded.append(value)
                k = max(1, len(recorded) // self.rf)
                threshold = sorted(recorded, reverse=True)[k - 1]
                if value < threshold:
                    return STOP
        return CONTINUE


class MedianStoppingRule:
    """Stop a trial whose best metric is below the median of running means
    of completed/ongoing trials at the same step."""

    def __init__(self, *, metric: str, mode: str = "max",
                 grace_period: int = 3,
                 time_attr: str = "training_iteration"):
        self.metric = metric
        self.mode = mode
        self.grace = grace_period
        self.time_attr = time_attr
        self._means: dict[Any, tuple[float, int]] = {}

    def _val(self, result):
        v = float(result[self.metric])
        return v if self.mode == "max" else -v

    def on_result(self, trial, result: dict) -> str:
        value = self._val(result)
        total, n = self._means.get(trial.trial_id, (0.0, 0))
        self._means[trial.trial_id] = (total + value, n + 1)
        t = int(result.get(self.time_attr, 0))
        if t < self.grace or len(self._means) < 3:
            return CONTINUE
        means = [s / max(1, c) for s, c in self._means.values()]
        means.sort()
        median = means[len(means) // 2]
        my_total, my_n = self._means[trial.trial_id]
        if my_total / my_n < median:
            return STOP
        return CONTINUE


class PopulationBasedTraining:
    """PBT: every perturbation_interval, bottom-quantile trials exploit a
    top-quantile donor (copy config + checkpoint) and explore (perturb
    hyperparams). The controller applies the returned action."""

    def __init__(self, *, metric: str, mode: str = "max",
                 perturbation_interval: int = 4,
                 hyperparam_mutations: dict | None = None,
                 quantile_fraction: float = 0.25, seed: int | None = None,
                 time_attr: str = "training_iteration",
                 max_exploits_per_trial: int = 8):
        self.metric = metric
        self.mode = mode
        self.interval = perturbation_interval
        self.mutations = hyperparam_mutations or {}
        self.quantile = quantile_fraction
        self.time_attr = time_attr
        self.rng = random.Random(seed)
        self._latest: dict[Any, float] = {}
        # exploit budget per trial: a population ALWAYS has a bottom
        # quantile, so without a cap a rerun-from-scratch function
        # trainable can be exploited forever and the experiment never
        # terminates (the reference bounds runs via stop criteria on a
        # cumulative iteration count that restarts don't reset)
        self.max_exploits = max_exploits_per_trial
        self._exploits: dict[Any, int] = {}

    def _val(self, result):
        v = float(result[self.metric])
        return v if self.mode == "max" else -v

    def on_result(self, trial, result: dict) -> str:
        self._latest[trial.trial_id] = self._val(result)
        t = int(result.get(self.time_attr, 0))
        if t == 0 or t % self.interval or len(self._latest) < 4:
            return CONTINUE
        ranked = sorted(self._latest.items(), key=lambda kv: kv[1])
        k = max(1, int(len(ranked) * self.quantile))
        bottom = {tid for tid, _ in ranked[:k]}
        top = [tid for tid, _ in ranked[-k:]]
        if (trial.trial_id in bottom
                and self._exploits.get(trial.trial_id, 0)
                < self.max_exploits):
            self._exploits[trial.trial_id] = 1 + self._exploits.get(
                trial.trial_id, 0)
            donor = self.rng.choice(top)
            return ("EXPLOIT", donor)
        return CONTINUE

    def explore(self, config: dict) -> dict:
        out = dict(config)
        for key, mutation in self.mutations.items():
            if callable(mutation):
                out[key] = mutation()
            elif isinstance(mutation, list):
                out[key] = self.rng.choice(mutation)
            elif key in out and isinstance(out[key], (int, float)):
                factor = self.rng.choice([0.8, 1.2])
                out[key] = out[key] * factor
        return out


class PB2(PopulationBasedTraining):
    """Population Based Bandits (reference: ``tune/schedulers/pb2.py``):
    PBT's exploit step, but explore proposes hyperparameters with a
    GP-UCB bandit fit to observed (config -> score-improvement) data
    instead of random perturbation — far more sample-efficient for small
    populations. ``hyperparam_bounds`` maps each tuned key to
    ``(low, high)``; proposals are drawn from the bounds and scored by a
    tiny RBF-kernel Gaussian process over past observations.
    """

    def __init__(self, *, metric: str, mode: str = "max",
                 perturbation_interval: int = 4,
                 hyperparam_bounds: dict | None = None,
                 quantile_fraction: float = 0.25, seed: int | None = None,
                 time_attr: str = "training_iteration",
                 ucb_beta: float = 1.0, n_candidates: int = 32):
        super().__init__(metric=metric, mode=mode,
                         perturbation_interval=perturbation_interval,
                         hyperparam_mutations={},
                         quantile_fraction=quantile_fraction, seed=seed,
                         time_attr=time_attr)
        self.bounds = hyperparam_bounds or {}
        self.ucb_beta = ucb_beta
        self.n_candidates = n_candidates
        # observations: (normalized config vector, score delta)
        self._obs: list[tuple[list, float]] = []
        self._prev_score: dict[Any, float] = {}

    def _norm(self, config: dict) -> list:
        vec = []
        for key, (lo, hi) in self.bounds.items():
            x = float(config.get(key, lo))
            vec.append((x - lo) / max(hi - lo, 1e-12))
        return vec

    def on_result(self, trial, result: dict) -> str:
        score = self._val(result)
        prev = self._prev_score.get(trial.trial_id)
        cfg = getattr(trial, "config", None) or {}
        if prev is not None and self.bounds:
            self._obs.append((self._norm(cfg), score - prev))
            if len(self._obs) > 256:
                self._obs.pop(0)
        self._prev_score[trial.trial_id] = score
        decision = super().on_result(trial, result)
        if isinstance(decision, tuple) and decision[0] == "EXPLOIT":
            # the trial restarts from the donor's checkpoint with a new
            # config: its next score delta is the checkpoint copy, not
            # the config — break the continuity so it isn't recorded
            self._prev_score.pop(trial.trial_id, None)
        return decision

    def _gp_ucb(self, x: list) -> float:
        """Posterior mean + beta * sd under an RBF-kernel GP with unit
        prior and fixed noise (the PB2 paper's time-varying bandit,
        simplified to a stationary kernel over the recent window)."""
        import math

        if not self._obs:
            return 0.0
        ls, noise = 0.3, 0.1
        xs = [o[0] for o in self._obs]
        ys = [o[1] for o in self._obs]
        # kernel-weighted mean/uncertainty (Nadaraya-Watson approximation
        # of the posterior: exact GP inversion is overkill at this size)
        ws = [math.exp(-sum((a - b) ** 2 for a, b in zip(x, xi))
                       / (2 * ls * ls)) for xi in xs]
        wsum = sum(ws) + noise
        mean = sum(w * y for w, y in zip(ws, ys)) / wsum
        sd = 1.0 / math.sqrt(wsum)
        return mean + self.ucb_beta * sd

    def explore(self, config: dict) -> dict:
        if not self.bounds:
            return super().explore(config)
        best, best_score = None, -float("inf")
        for _ in range(self.n_candidates):
            cand = dict(config)
            for key, (lo, hi) in self.bounds.items():
                cand[key] = lo + self.rng.random() * (hi - lo)
            s = self._gp_ucb(self._norm(cand))
            if s > best_score:
                best, best_score = cand, s
        return best


class HyperBandScheduler:
    """Synchronous HyperBand-style successive halving (reference:
    ``tune/schedulers/hyperband.py``). Simplification: one bracket sized
    by the live trial population; at each rung boundary (``r * eta^k``
    iterations) the bottom ``1 - 1/eta`` of trials AT that rung stop.

    Unlike ASHA (async, per-result decisions vs historical quantiles),
    rung cuts here wait until every live trial reaches the rung, which
    matches the original algorithm's synchronous halving semantics."""

    def __init__(self, *, metric: str, mode: str = "max", r: int = 1,
                 eta: int = 3, max_t: int = 81,
                 time_attr: str = "training_iteration"):
        self.metric = metric
        self.mode = mode
        self.eta = eta
        self.max_t = max_t
        self.time_attr = time_attr
        self.rungs = []
        t = r
        while t < max_t:
            self.rungs.append(t)
            t *= eta
        # rung level -> {trial_id: score} of trials waiting at the rung
        self._waiting: dict[int, dict] = {lvl: {} for lvl in self.rungs}
        self._decided: dict[int, set] = {lvl: set() for lvl in self.rungs}
        self._stopped: set = set()
        # expected population: set by the controller (set_population) so a
        # rung cut waits for EVERY planned trial, not just the subset that
        # happens to have reported already (a singleton cut eliminates
        # nobody and silently defeats successive halving)
        self._population: set = set()

    def _val(self, result):
        return float(result[self.metric]) * (
            1.0 if self.mode == "max" else -1.0)

    def set_population(self, trial_ids):
        """Controller hook: the full set of trials this bracket halves
        over (called whenever trials are created)."""
        self._population.update(trial_ids)

    def on_result(self, trial, result: dict) -> str:
        self._population.add(trial.trial_id)
        if trial.trial_id in self._stopped:
            return STOP
        t = result.get(self.time_attr, 0)
        if t >= self.max_t:
            return STOP
        for lvl in self.rungs:
            if t == lvl and trial.trial_id not in self._decided[lvl]:
                self._waiting[lvl][trial.trial_id] = self._val(result)
                undecided = (self._population - self._decided[lvl]
                             - self._stopped)
                if set(self._waiting[lvl]) >= undecided:
                    # everyone still running has reached the rung: cut
                    ranked = sorted(self._waiting[lvl].items(),
                                    key=lambda kv: kv[1], reverse=True)
                    keep = max(1, len(ranked) // self.eta)
                    for tid, _ in ranked[keep:]:
                        self._stopped.add(tid)
                    for tid, _ in ranked:
                        self._decided[lvl].add(tid)
                    self._waiting[lvl].clear()
                    if trial.trial_id in self._stopped:
                        return STOP
                # NOT decided yet: let the trial keep running; it will
                # be stopped at its next report if the cut rejects it
        return CONTINUE

    def on_trial_gone(self, trial_id: str):
        """A trial finished/errored outside scheduler control: it must
        not hold up future rung cuts, and its stale score must not take
        a keep slot from live trials."""
        self._population.discard(trial_id)
        for lvl in self.rungs:
            self._waiting[lvl].pop(trial_id, None)
