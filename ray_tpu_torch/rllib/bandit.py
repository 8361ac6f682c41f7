"""Contextual bandits: LinUCB and Linear Thompson Sampling.

Port of ``ray_tpu/rllib/bandit.py``, which is numpy only: this is its
copy, with the port's ``make_env``, so actions, arm statistics and save
files equal JAX's for the same seed. Reference analog: ``rllib/algorithms/bandit/`` (``BanditLinUCB``,
``BanditLinTS`` over ``DiscreteLinearModel``). Per-arm Bayesian linear
regression on the context: LinUCB picks the arm maximizing the upper
confidence bound ``theta_a @ x + alpha * sqrt(x' A_a^-1 x)``; LinTS
samples ``theta ~ N(mean, A^-1)`` per arm and exploits greedily.

These are exact closed-form updates (rank-1 Sherman–Morrison), no
gradient step — host numpy is the right tool, and the driver interacts
with the env directly (bandits are one-step, there is nothing to fan
out).
"""

from __future__ import annotations

from dataclasses import dataclass, replace

import numpy as np

from ray_tpu_torch.rllib.env import make_env


@dataclass
class BanditLinUCBConfig:
    env: str = "Bandit-v0"
    alpha: float = 1.0              # exploration width
    lambda_reg: float = 1.0         # ridge prior precision
    steps_per_iteration: int = 100
    seed: int = 0

    def environment(self, env):
        return replace(self, env=env)

    def training(self, **kw):
        return replace(self, **kw)

    def build(self):
        return BanditLinUCB(self)


@dataclass
class BanditLinTSConfig(BanditLinUCBConfig):
    def build(self):
        return BanditLinTS(self)


class _LinearArmModel:
    """Ridge regression per arm with incrementally maintained inverse."""

    def __init__(self, dim: int, lambda_reg: float):
        self.a_inv = np.eye(dim) / lambda_reg
        self.b = np.zeros(dim)
        self.theta = np.zeros(dim)
        self.pulls = 0

    def update(self, x: np.ndarray, reward: float):
        # Sherman–Morrison rank-1 update of A^-1
        av = self.a_inv @ x
        self.a_inv -= np.outer(av, av) / (1.0 + x @ av)
        self.b += reward * x
        self.theta = self.a_inv @ self.b
        self.pulls += 1


class BanditLinUCB:
    def __init__(self, config):
        self.config = config
        self.env = make_env(config.env, seed=config.seed)
        self.rng = np.random.default_rng(config.seed)
        self.arms = [_LinearArmModel(self.env.obs_dim, config.lambda_reg)
                     for _ in range(self.env.n_actions)]
        self.iteration = 0
        self.total_steps = 0

    def _score(self, arm: _LinearArmModel, x: np.ndarray) -> float:
        ucb = np.sqrt(max(float(x @ arm.a_inv @ x), 0.0))
        return float(arm.theta @ x) + self.config.alpha * ucb

    def compute_action(self, obs) -> int:
        x = np.asarray(obs, dtype=np.float64)
        return int(np.argmax([self._score(a, x) for a in self.arms]))

    def train(self) -> dict:
        rewards = []
        obs = self.env.reset()
        for _ in range(self.config.steps_per_iteration):
            x = np.asarray(obs, dtype=np.float64)
            action = self.compute_action(x)
            obs, reward, done, _ = self.env.step(action)
            self.arms[action].update(x, float(reward))
            rewards.append(reward)
            if done:
                obs = self.env.reset()
        self.iteration += 1
        self.total_steps += len(rewards)
        return {
            "training_iteration": self.iteration,
            "episode_return_mean": float(np.mean(rewards)),
            "num_env_steps_sampled": self.total_steps,
            "arm_pulls": [a.pulls for a in self.arms],
        }

    def save(self, path: str):
        np.savez(path,
                 **{f"ainv{i}": a.a_inv for i, a in enumerate(self.arms)},
                 **{f"b{i}": a.b for i, a in enumerate(self.arms)})

    def restore(self, path: str):
        if not path.endswith(".npz"):
            path += ".npz"
        with np.load(path) as z:
            for i, a in enumerate(self.arms):
                a.a_inv = z[f"ainv{i}"]
                a.b = z[f"b{i}"]
                a.theta = a.a_inv @ a.b

    def stop(self):
        pass


class BanditLinTS(BanditLinUCB):
    """Thompson sampling: draw theta from the posterior, act greedily."""

    def _score(self, arm: _LinearArmModel, x: np.ndarray) -> float:
        cov = self.config.alpha ** 2 * arm.a_inv
        cov = 0.5 * (cov + cov.T)  # keep SM-updated inverse symmetric
        theta = self.rng.multivariate_normal(arm.theta, cov)
        return float(theta @ x)
