"""Off-policy evaluation (OPE) estimators for offline datasets.

Port of ``ray_tpu/rllib/estimators.py``: numpy, copied verbatim.

Reference analog: ``rllib/offline/estimators/`` — ``ImportanceSampling``
and ``WeightedImportanceSampling`` score a TARGET policy on episodes
collected by a BEHAVIOR policy, without running the target in the env.
Both take per-step action log-probabilities under each policy; episodes
come from the columnar offline dataset (split on ``dones``).
"""

from __future__ import annotations

import numpy as np


def episodes_from_dataset(dataset) -> list[dict]:
    """Split a columnar OfflineDataset (obs/actions/rewards/dones in
    collection order) into per-episode dicts. A trailing partial episode
    (no terminal ``done``) is kept — estimators discount it the same."""
    data = dataset.data if hasattr(dataset, "data") else dataset
    dones = np.asarray(data["dones"]).astype(bool)
    episodes = []
    start = 0
    for i, d in enumerate(dones):
        if d:
            episodes.append({k: np.asarray(v[start:i + 1])
                             for k, v in data.items()})
            start = i + 1
    if start < len(dones):
        episodes.append({k: np.asarray(v[start:])
                         for k, v in data.items()})
    return episodes


def _episode_stats(episodes, target_logp_fn, behavior_logp_fn, gamma):
    returns = []
    log_ratios = []
    for ep in episodes:
        obs = ep["obs"]
        actions = ep["actions"]
        rewards = np.asarray(ep["rewards"], np.float64)
        discounts = gamma ** np.arange(len(rewards))
        returns.append(float(np.sum(discounts * rewards)))
        t = np.asarray(target_logp_fn(obs, actions), np.float64)
        b = np.asarray(behavior_logp_fn(obs, actions), np.float64)
        log_ratios.append(float(np.sum(t - b)))
    return np.asarray(returns), np.asarray(log_ratios)


class ImportanceSampling:
    """Ordinary (unweighted) per-episode importance sampling
    (reference: ``estimators/importance_sampling.py``):
    ``V_target = mean_i( w_i * G_i )`` with
    ``w_i = prod_t pi(a|s) / beta(a|s)``."""

    def __init__(self, gamma: float = 0.99, clip_ratio: float = 1e4):
        self.gamma = gamma
        self.clip_ratio = clip_ratio

    def estimate(self, episodes, target_logp_fn, behavior_logp_fn) -> dict:
        returns, log_ratios = _episode_stats(
            episodes, target_logp_fn, behavior_logp_fn, self.gamma)
        weights = np.clip(np.exp(log_ratios), 0.0, self.clip_ratio)
        return {
            "v_behavior": float(returns.mean()),
            "v_target": float((weights * returns).mean()),
            "mean_weight": float(weights.mean()),
            "num_episodes": len(returns),
        }


class WeightedImportanceSampling(ImportanceSampling):
    """Self-normalized IS (reference:
    ``estimators/weighted_importance_sampling.py``): weights divide by
    their sum — biased but far lower variance on long horizons."""

    def estimate(self, episodes, target_logp_fn, behavior_logp_fn) -> dict:
        returns, log_ratios = _episode_stats(
            episodes, target_logp_fn, behavior_logp_fn, self.gamma)
        weights = np.clip(np.exp(log_ratios), 0.0, self.clip_ratio)
        denom = weights.sum()
        v_target = (float((weights * returns).sum() / denom)
                    if denom > 0 else 0.0)
        return {
            "v_behavior": float(returns.mean()),
            "v_target": v_target,
            "effective_sample_size": (
                float(denom ** 2 / np.maximum((weights ** 2).sum(), 1e-12))),
            "num_episodes": len(returns),
        }
