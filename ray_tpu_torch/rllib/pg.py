"""Vanilla Policy Gradient (REINFORCE) and A2C.

Port of ``ray_tpu/rllib/pg.py`` (reference analogs:
``rllib/algorithms/pg/pg.py``, plain REINFORCE on Monte-Carlo returns,
and ``rllib/algorithms/a2c/a2c.py``, the PPO sampling architecture with a
single unclipped update per batch). Both run on PPO's rollout workers and
module (``rllib.ppo``); only the loss differs (``a2c_loss``, the loss of
``_a2c_update``, ``pg.py:169-192``). One learner on the card (``device``,
default "cuda"), one update per iteration on the whole batch.
"""

from __future__ import annotations

import pickle
import time
from dataclasses import dataclass, replace
from functools import partial

import numpy as np
import torch

from ray_tpu_torch.rllib.env import make_env
from ray_tpu_torch.rllib.learner_group import Learner
from ray_tpu_torch.rllib.ppo import (
    _episode_mean,
    _np_forward,
    _RolloutWorker,
    adam,
    entropy_of,
    init_module,
    logp_of,
)


@dataclass
class A2CConfig:
    env: str = "CartPole-v1"
    num_rollout_workers: int = 2
    rollout_fragment_length: int = 256
    lr: float = 1e-3
    gamma: float = 0.99
    lam: float = 1.0                # MC advantages by default
    entropy_coeff: float = 0.01
    vf_coeff: float = 0.5
    hidden: int = 64
    seed: int = 0
    # the learner's device ("cpu" only when asked for)
    device: str = "cuda"

    def environment(self, env):
        return replace(self, env=env)

    def rollouts(self, *, num_rollout_workers=None,
                 rollout_fragment_length=None):
        cfg = self
        if num_rollout_workers is not None:
            cfg = replace(cfg, num_rollout_workers=num_rollout_workers)
        if rollout_fragment_length is not None:
            cfg = replace(cfg,
                          rollout_fragment_length=rollout_fragment_length)
        return cfg

    def training(self, **kw):
        return replace(self, **kw)

    def build(self):
        return A2C(self)


@dataclass
class PGConfig(A2CConfig):
    vf_coeff: float = 0.0           # no critic in the loss

    def build(self):
        return PG(self)


def a2c_loss(module, batch: dict, *, entropy_coeff: float, vf_coeff: float,
             use_critic: bool):
    """The loss of ``_a2c_update`` (``ray_tpu/rllib/pg.py:169-192``): the
    policy gradient on the advantages (A2C) or on the returns normalised
    over the batch (PG, ``use_critic=False``, which leaves the value loss
    out of the total). Returns (total, stats)."""
    logits, values = module(batch["obs"])
    logp_all = torch.log_softmax(logits, dim=-1)
    logp = logp_of(logp_all, batch["actions"])
    adv = batch["advantages"] if use_critic else batch["returns"]
    if not use_critic:
        adv = (adv - adv.mean()) / (adv.std(correction=0) + 1e-8)
    policy_loss = -torch.mean(logp * adv)
    vf_loss = torch.mean((values - batch["returns"]) ** 2)
    entropy = entropy_of(logp_all)
    total = policy_loss - entropy_coeff * entropy
    if use_critic:
        total = total + vf_coeff * vf_loss
    return total, {"policy_loss": policy_loss, "vf_loss": vf_loss,
                   "entropy": entropy}


class A2C:
    """Synchronous advantage actor-critic."""

    _use_critic = True

    def __init__(self, config):
        self.config = config
        env = make_env(config.env, seed=config.seed)
        self.obs_dim = env.obs_dim
        self.n_actions = env.n_actions
        self.learner = Learner(
            init_fn=partial(init_module, obs_dim=self.obs_dim,
                            n_actions=self.n_actions, hidden=config.hidden),
            loss_fn=partial(a2c_loss, entropy_coeff=config.entropy_coeff,
                            vf_coeff=config.vf_coeff,
                            use_critic=self._use_critic),
            tx=adam(config.lr), seed=config.seed, device=config.device)
        self.iteration = 0
        self.workers = [
            _RolloutWorker(config.env, config.seed + 1000 * (i + 1))
            for i in range(config.num_rollout_workers)
        ]

    def train(self) -> dict:
        cfg = self.config
        t0 = time.perf_counter()
        params_np = self.learner.get_params()
        batches = [w.sample(params_np, cfg.rollout_fragment_length,
                            cfg.gamma, cfg.lam) for w in self.workers]
        batch = {k: np.concatenate([b[k] for b in batches])
                 for k in ("obs", "actions", "advantages", "returns")}
        episode_returns = [r for b in batches for r in b["episode_returns"]]
        adv = batch["advantages"]
        batch["advantages"] = (adv - adv.mean()) / (adv.std() + 1e-8)
        t1 = time.perf_counter()
        stats = self.learner.update(batch)
        self.iteration += 1
        return {
            "training_iteration": self.iteration,
            "episode_return_mean": _episode_mean(episode_returns),
            "num_episodes": len(episode_returns),
            "policy_loss": stats["policy_loss"],
            "vf_loss": stats["vf_loss"],
            "entropy": stats["entropy"],
            "num_env_steps_sampled": len(batch["obs"]),
            "sample_time_s": t1 - t0,
            "learn_time_s": time.perf_counter() - t1,
        }

    def compute_action(self, obs) -> int:
        logits, _ = _np_forward(self.learner.get_params(),
                                np.asarray(obs)[None])
        return int(np.argmax(logits[0]))

    def save(self, path: str):
        with open(path, "wb") as f:
            pickle.dump(self.learner.get_params(), f)

    def restore(self, path: str):
        with open(path, "rb") as f:
            self.learner.set_params(pickle.load(f))

    def stop(self):
        self.learner.stop()


class PG(A2C):
    """REINFORCE: the A2C machinery with the critic removed from the
    loss (the value head still exists in the module but gets no
    gradient signal when ``vf_coeff == 0`` and advantages fall back to
    returns-to-go via ``lam=1`` GAE)."""

    _use_critic = False
