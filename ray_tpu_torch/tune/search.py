"""Search spaces + searchers.

Port of ``ray_tpu/tune/search.py``, kept as a copy of its own (the port
imports no module of ``ray_tpu``). Everything here is host code on
``random.Random`` and numpy, unchanged, so the same seed and the same
observations give the same suggestions as the JAX package's, bit for bit.

Reference analog: ``python/ray/tune/search/`` — the sampling primitives
(``tune.uniform/choice/...``), ``grid_search``, and
``BasicVariantGenerator`` (grid expansion × num_samples random sampling).
External searcher integrations (optuna/hyperopt/...) plug in behind the
same ``suggest`` interface."""

from __future__ import annotations

import itertools
import random
from dataclasses import dataclass
from typing import Any, Callable


@dataclass
class Domain:
    sampler: Callable[[random.Random], Any]
    # bounds for numeric domains (None for categorical): adaptive
    # searchers clamp proposals to [low, high]
    low: float | None = None
    high: float | None = None
    integer: bool = False

    def sample(self, rng: random.Random):
        return self.sampler(rng)

    def clamp(self, x):
        if self.low is not None:
            x = max(x, self.low)
        if self.high is not None:
            x = min(x, self.high)
        if self.integer:
            hi = self.high - 1 if self.high is not None else None
            x = int(round(x))
            if self.low is not None:
                x = max(x, int(self.low))
            if hi is not None:
                x = min(x, int(hi))
        return x


def uniform(low: float, high: float) -> Domain:
    return Domain(lambda rng: rng.uniform(low, high), low=low, high=high)


def loguniform(low: float, high: float) -> Domain:
    import math

    return Domain(lambda rng: math.exp(
        rng.uniform(math.log(low), math.log(high))), low=low, high=high)


def randint(low: int, high: int) -> Domain:
    """Samples from [low, high) like the reference's tune.randint."""
    return Domain(lambda rng: rng.randrange(low, high), low=low, high=high,
                  integer=True)


def choice(options: list) -> Domain:
    options = list(options)
    return Domain(lambda rng: rng.choice(options))


def grid_search(values: list) -> dict:
    return {"grid_search": list(values)}


class BasicVariantGenerator:
    """Expands grid_search axes (cartesian product) and samples Domains;
    ``num_samples`` repeats the whole expansion (reference semantics)."""

    def __init__(self, param_space: dict, num_samples: int = 1,
                 seed: int | None = None):
        self.param_space = param_space
        self.num_samples = num_samples
        self.rng = random.Random(seed)

    def variants(self) -> list[dict]:
        grid_keys = []
        grid_values = []

        def walk(prefix, node):
            for k, v in node.items():
                path = prefix + (k,)
                if isinstance(v, dict) and "grid_search" in v:
                    grid_keys.append(path)
                    grid_values.append(v["grid_search"])
                elif isinstance(v, dict):
                    walk(path, v)

        walk((), self.param_space)
        combos = list(itertools.product(*grid_values)) if grid_values else [()]
        out = []
        for _ in range(self.num_samples):
            for combo in combos:
                cfg = self._sample(self.param_space)
                for path, value in zip(grid_keys, combo):
                    _set_path(cfg, path, value)
                out.append(cfg)
        return out

    def _sample(self, node: dict) -> dict:
        cfg = {}
        for k, v in node.items():
            if isinstance(v, Domain):
                cfg[k] = v.sample(self.rng)
            elif isinstance(v, dict) and "grid_search" in v:
                cfg[k] = None  # filled by the grid combo
            elif isinstance(v, dict):
                cfg[k] = self._sample(v)
            else:
                cfg[k] = v
        return cfg


def _set_path(cfg: dict, path: tuple, value):
    node = cfg
    for k in path[:-1]:
        node = node[k]
    node[path[-1]] = value


# ---------------------------------------------------------------------------
# adaptive searchers (reference: tune/search/searcher.py Searcher interface;
# hyperopt/optuna integrations plug in behind suggest/on_trial_complete)
# ---------------------------------------------------------------------------

class Searcher:
    """suggest(trial_id) -> config | None (None = no budget left);
    on_trial_result / on_trial_complete feed observations back."""

    def suggest(self, trial_id: str) -> dict | None:
        raise NotImplementedError

    def on_trial_result(self, trial_id: str, result: dict):
        pass

    def on_trial_complete(self, trial_id: str, result: dict | None = None,
                          error: bool = False):
        pass


class TPESearcher(Searcher):
    """Tree-structured-Parzen-Estimator-style adaptive search over a
    Domain/grid-free param space (the native analog of the reference's
    hyperopt integration, ``tune/search/hyperopt/``).

    After ``n_startup`` random trials, numeric dimensions are proposed by
    sampling candidates and scoring them by the ratio of Gaussian-kernel
    densities fit to the good (top gamma quantile) vs bad observations;
    categorical dimensions are drawn from smoothed good-split counts.
    """

    def __init__(self, space: dict, *, metric: str, mode: str = "max",
                 num_samples: int = 32, n_startup: int = 8,
                 gamma: float = 0.25, n_candidates: int = 24,
                 seed: int | None = None):
        self.space = space
        self.metric = metric
        self.mode = mode
        self.budget = num_samples
        self.n_startup = n_startup
        self.gamma = gamma
        self.n_candidates = n_candidates
        self.rng = random.Random(seed)
        self._suggested = 0
        self._obs: dict[str, tuple[dict, float]] = {}  # id -> (cfg, score)
        self._configs: dict[str, dict] = {}            # id -> suggested cfg

    # -- observations ---------------------------------------------------

    def on_trial_complete(self, trial_id, result=None, error=False):
        if error or not result or self.metric not in result:
            return
        score = float(result[self.metric])
        cfg = self._configs.get(trial_id)
        if cfg is not None:
            self._obs[trial_id] = (cfg, score)

    # -- proposals ------------------------------------------------------

    def suggest(self, trial_id: str) -> dict | None:
        if self._suggested >= self.budget:
            return None
        self._suggested += 1
        if len(self._obs) < self.n_startup:
            cfg = self._random_config()
        else:
            cfg = self._tpe_config()
        self._configs[trial_id] = cfg
        return cfg

    def _random_config(self) -> dict:
        return {k: (v.sample(self.rng) if isinstance(v, Domain) else v)
                for k, v in self.space.items()}

    def _split_obs(self):
        obs = sorted(self._obs.values(), key=lambda cv: cv[1],
                     reverse=(self.mode == "max"))
        n_good = max(1, int(len(obs) * self.gamma))
        return obs[:n_good], obs[n_good:]

    def _tpe_config(self) -> dict:
        good, bad = self._split_obs()
        cfg = {}
        for k, dom in self.space.items():
            if not isinstance(dom, Domain):
                cfg[k] = dom
                continue
            gvals = [c[k] for c, _ in good if k in c]
            bvals = [c[k] for c, _ in bad if k in c]
            sample = dom.sample(self.rng)
            if isinstance(sample, (int, float)) and not isinstance(
                    sample, bool) and gvals and all(
                    isinstance(v, (int, float)) for v in gvals):
                cfg[k] = self._propose_numeric(dom, gvals, bvals,
                                               integer=isinstance(sample, int))
            elif gvals:
                cfg[k] = self._propose_categorical(dom, gvals)
            else:
                cfg[k] = sample
        return cfg

    def _kde(self, x: float, centers: list, bw: float) -> float:
        import math

        if not centers:
            return 1e-12
        return sum(math.exp(-0.5 * ((x - c) / bw) ** 2)
                   for c in centers) / (len(centers) * bw)

    def _propose_numeric(self, dom: Domain, gvals, bvals, *, integer):
        lo = min(gvals + bvals)
        hi = max(gvals + bvals)
        bw = max((hi - lo) / 4.0, 1e-9)
        best, best_ratio = None, -1.0
        for _ in range(self.n_candidates):
            # good-centered Gaussian mixture + prior samples; every
            # candidate is clamped into the domain's declared bounds
            # (a raw gauss() draw can land outside [low, high])
            if self.rng.random() < 0.75 and gvals:
                x = dom.clamp(self.rng.gauss(self.rng.choice(gvals), bw))
            else:
                x = dom.sample(self.rng)
            ratio = self._kde(x, gvals, bw) / (
                self._kde(x, bvals, bw) + 1e-12)
            if ratio > best_ratio:
                best, best_ratio = x, ratio
        if integer:
            best = dom.clamp(best)
        return best

    def _propose_categorical(self, dom: Domain, gvals):
        # smoothed counts over the good split; fall back to the prior
        # for unseen options by mixing one prior sample in
        counts: dict = {}
        for v in gvals:
            counts[v] = counts.get(v, 0) + 1
        options = list(counts) + [dom.sample(self.rng)]
        weights = [counts.get(o, 0) + 0.5 for o in options]
        return self.rng.choices(options, weights=weights, k=1)[0]


class BOHBSearcher(TPESearcher):
    """BOHB-style model-based search: TPE models fit PER TRAINING BUDGET
    (training_iteration), proposals drawn from the largest budget with
    enough observations. Pair with ``HyperBandScheduler`` — together they
    are the native analog of the reference's TuneBOHB + HpBandSter
    (``tune/search/bohb/``): HyperBand allocates budgets and promotes,
    BOHB replaces its random sampling with a model.

        tuner = Tuner(train_fn, param_space=space,
                      tune_config=TuneConfig(
                          search_alg=BOHBSearcher(space, metric="loss",
                                                  mode="min", num_samples=32),
                          scheduler=HyperBandScheduler(metric="loss",
                                                       mode="min")))
    """

    def __init__(self, space: dict, *, metric: str, mode: str = "max",
                 num_samples: int = 32, n_startup: int = 8,
                 gamma: float = 0.25, n_candidates: int = 24,
                 seed: int | None = None):
        super().__init__(space, metric=metric, mode=mode,
                         num_samples=num_samples, n_startup=n_startup,
                         gamma=gamma, n_candidates=n_candidates, seed=seed)
        # budget (training_iteration) -> {trial_id: (cfg, score)}
        self._obs_by_budget: dict[int, dict] = {}

    def _record(self, trial_id: str, result: dict):
        if not result or self.metric not in result:
            return
        cfg = self._configs.get(trial_id)
        if cfg is None:
            return
        budget = int(result.get("training_iteration", 1))
        level = self._obs_by_budget.setdefault(budget, {})
        level[trial_id] = (cfg, float(result[self.metric]))

    def on_trial_result(self, trial_id, result):
        # BOHB's point: partial results at rung boundaries feed the model
        self._record(trial_id, result)

    def on_trial_complete(self, trial_id, result=None, error=False):
        if not error and result:
            self._record(trial_id, result)

    def suggest(self, trial_id: str) -> dict | None:
        # model on the LARGEST budget with enough observations (BOHB rule)
        self._obs = {}
        for budget in sorted(self._obs_by_budget, reverse=True):
            level = self._obs_by_budget[budget]
            if len(level) >= self.n_startup:
                self._obs = dict(level)
                break
        return super().suggest(trial_id)


class BayesOptSearcher(Searcher):
    """Gaussian-process Bayesian optimization with expected improvement
    (the native analog of the reference's bayes_opt integration,
    ``tune/search/bayesopt/``). Numeric Domains only get modeled;
    categorical/static keys fall back to prior sampling.

    A full numpy GP: RBF kernel on [0,1]-normalized inputs, Cholesky
    solve, EI acquisition maximized over random candidates. No external
    optimizer dependency — the whole loop is a few dense solves, which
    is the right tool at tune-scale trial counts (tens to hundreds)."""

    def __init__(self, space: dict, *, metric: str, mode: str = "max",
                 num_samples: int = 32, n_startup: int = 6,
                 n_candidates: int = 256, length_scale: float = 0.2,
                 noise: float = 1e-4, xi: float = 0.01,
                 seed: int | None = None):
        self.space = space
        self.metric = metric
        self.mode = mode
        self.budget = num_samples
        self.n_startup = n_startup
        self.n_candidates = n_candidates
        self.length_scale = length_scale
        self.noise = noise
        self.xi = xi
        self.rng = random.Random(seed)
        self._suggested = 0
        self._configs: dict[str, dict] = {}
        self._obs: dict[str, tuple[dict, float]] = {}
        # numeric dimensions the GP models (bounded Domains)
        self._dims = [k for k, v in space.items()
                      if isinstance(v, Domain) and v.low is not None
                      and v.high is not None]

    def on_trial_complete(self, trial_id, result=None, error=False):
        if error or not result or self.metric not in result:
            return
        cfg = self._configs.get(trial_id)
        if cfg is not None:
            self._obs[trial_id] = (cfg, float(result[self.metric]))

    def _unit(self, cfg: dict):
        """Config -> [0,1]^d vector over the modeled dims (log-scale is
        approximated linearly; adequate for acquisition ranking)."""
        import numpy as np

        x = np.empty(len(self._dims))
        for i, k in enumerate(self._dims):
            dom = self.space[k]
            x[i] = (float(cfg[k]) - dom.low) / (dom.high - dom.low)
        return x

    def _random_config(self) -> dict:
        return {k: (v.sample(self.rng) if isinstance(v, Domain) else v)
                for k, v in self.space.items()}

    def suggest(self, trial_id: str) -> dict | None:
        if self._suggested >= self.budget:
            return None
        self._suggested += 1
        if len(self._obs) < self.n_startup or not self._dims:
            cfg = self._random_config()
        else:
            cfg = self._gp_config()
        self._configs[trial_id] = cfg
        return cfg

    def _gp_config(self) -> dict:
        import numpy as np

        obs = list(self._obs.values())
        X = np.stack([self._unit(c) for c, _ in obs])
        y = np.array([s for _, s in obs])
        if self.mode == "min":
            y = -y
        y_mean, y_std = y.mean(), y.std() + 1e-9
        yn = (y - y_mean) / y_std

        def kern(a, b):
            d2 = ((a[:, None, :] - b[None, :, :]) ** 2).sum(-1)
            return np.exp(-0.5 * d2 / self.length_scale ** 2)

        K = kern(X, X) + self.noise * np.eye(len(X))
        L = np.linalg.cholesky(K)
        alpha = np.linalg.solve(L.T, np.linalg.solve(L, yn))

        # candidates: prior samples + jittered best observed
        cands = [self._random_config()
                 for _ in range(self.n_candidates // 2)]
        best_cfg = obs[int(np.argmax(yn))][0]
        for _ in range(self.n_candidates - len(cands)):
            c = dict(self._random_config())
            for k in self._dims:
                dom = self.space[k]
                span = (dom.high - dom.low) * 0.1
                c[k] = dom.clamp(float(best_cfg[k])
                                 + self.rng.gauss(0.0, span))
            cands.append(c)
        Xc = np.stack([self._unit(c) for c in cands])
        Kc = kern(Xc, X)
        mu = Kc @ alpha
        v = np.linalg.solve(L, Kc.T)
        var = np.maximum(1.0 - (v ** 2).sum(0), 1e-12)
        sigma = np.sqrt(var)
        # expected improvement over the incumbent
        from math import erf

        best = yn.max()
        z = (mu - best - self.xi) / sigma
        cdf = 0.5 * (1.0 + np.vectorize(erf)(z / np.sqrt(2.0)))
        pdf = np.exp(-0.5 * z ** 2) / np.sqrt(2 * np.pi)
        ei = (mu - best - self.xi) * cdf + sigma * pdf
        pick = cands[int(np.argmax(ei))]
        # re-clamp integer dims disturbed by jitter
        return {k: (self.space[k].clamp(v)
                    if k in self._dims and isinstance(self.space[k], Domain)
                    else v)
                for k, v in pick.items()}


class ConcurrencyLimiter(Searcher):
    """Caps in-flight suggestions (reference:
    tune/search/concurrency_limiter.py)."""

    def __init__(self, searcher: Searcher, max_concurrent: int):
        self.searcher = searcher
        self.max_concurrent = max_concurrent
        self._live: set = set()

    def suggest(self, trial_id: str) -> dict | None:
        if len(self._live) >= self.max_concurrent:
            return None  # controller retries later
        cfg = self.searcher.suggest(trial_id)
        if cfg is not None:
            self._live.add(trial_id)
        return cfg

    def on_trial_result(self, trial_id, result):
        self.searcher.on_trial_result(trial_id, result)

    def on_trial_complete(self, trial_id, result=None, error=False):
        self._live.discard(trial_id)
        self.searcher.on_trial_complete(trial_id, result, error)

