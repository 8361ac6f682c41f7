"""ray_tpu_torch.tune: hyperparameter search over the port's train harness.

Port of ``ray_tpu/tune/`` (reference: Ray Tune): the searchers and the
schedulers are copies of the JAX package's host code, and each trial runs
in a rank process of ``train.worker_group`` (``tune/tuner.py``). The JAX
package's usage-stats record is host-plane telemetry the port leaves out.
"""

from ray_tpu_torch.tune.schedulers import (
    PB2,
    AsyncHyperBandScheduler,
    FIFOScheduler,
    HyperBandScheduler,
    MedianStoppingRule,
    PopulationBasedTraining,
)
from ray_tpu_torch.tune.search import (
    BOHBSearcher,
    BasicVariantGenerator,
    BayesOptSearcher,
    ConcurrencyLimiter,
    Searcher,
    TPESearcher,
    choice,
    grid_search,
    loguniform,
    randint,
    uniform,
)
from ray_tpu_torch.tune.tuner import ResultGrid, Trial, TuneConfig, Tuner

__all__ = [
    "AsyncHyperBandScheduler",
    "BOHBSearcher",
    "BayesOptSearcher",
    "BasicVariantGenerator",
    "ConcurrencyLimiter",
    "HyperBandScheduler",
    "Searcher",
    "TPESearcher",
    "FIFOScheduler",
    "MedianStoppingRule",
    "PB2",
    "PopulationBasedTraining",
    "ResultGrid",
    "Trial",
    "TuneConfig",
    "Tuner",
    "choice",
    "grid_search",
    "loguniform",
    "randint",
    "uniform",
]
