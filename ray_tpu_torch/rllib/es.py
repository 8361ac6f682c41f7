"""Evolution Strategies (ES) and Augmented Random Search (ARS).

Port of ``ray_tpu/rllib/es.py``, which is numpy only and stays numpy
only here: neither algorithm backpropagates, so the policy is a numpy
MLP evaluated on the host and the update is a couple of dense
reductions. Reference analogs: ``rllib/algorithms/es/es.py`` (OpenAI-ES:
antithetic gaussian perturbations scored by fitness, centered-rank
gradient estimate, shared noise table) and ``rllib/algorithms/ars/
ars.py`` (top-k directions, reward-std step normalization, V2
observation normalization).

The fitness workers are objects of this process, stepped one after
another with JAX's seeds (``seed + 7*(i+1)``), and share the one noise
table the driver holds (JAX places it in its object store once and maps
it into every worker): each worker's returns depend only on its seed,
the table and ``theta``, so an iteration's ``theta`` equals JAX's.
"""

from __future__ import annotations

from dataclasses import dataclass, replace

import numpy as np

from ray_tpu_torch.rllib.env import make_env


# ---------------------------------------------------------------------------
# Shared noise table + flat linear/MLP policy
# ---------------------------------------------------------------------------

NOISE_TABLE_SIZE = 4_000_000  # floats; ~16 MB, plenty for small policies


def make_noise_table(seed: int = 1234, size: int = NOISE_TABLE_SIZE):
    return np.random.default_rng(seed).standard_normal(
        size, dtype=np.float32)


def _policy_shapes(obs_dim: int, n_out: int, hidden: int):
    if hidden <= 0:  # linear policy (ARS default)
        return [(obs_dim, n_out)]
    return [(obs_dim, hidden), (hidden, hidden), (hidden, n_out)]


def _flat_size(shapes):
    return sum(int(np.prod(s)) for s in shapes)


def _forward_flat(theta, shapes, obs):
    """Evaluate the flat-parameter MLP; tanh torso, linear head."""
    x = obs
    off = 0
    for i, shape in enumerate(shapes):
        n = int(np.prod(shape))
        w = theta[off:off + n].reshape(shape)
        off += n
        x = x @ w
        if i < len(shapes) - 1:
            x = np.tanh(x)
    return x


class _FitnessWorker:
    """Evaluates perturbed policies; one episode (or step budget) each.

    Holds the env and a view of the shared noise table.
    """

    def __init__(self, env_name, seed, noise, shapes, discrete,
                 action_low=None, action_high=None):
        self.env = make_env(env_name, seed=seed)
        # the driver's table itself (no copy)
        self.noise = np.asarray(noise)
        self.shapes = list(map(tuple, shapes))
        self.dim = _flat_size(self.shapes)
        self.discrete = discrete
        self.low, self.high = action_low, action_high
        self.rng = np.random.default_rng(seed)
        # ARS-style per-dimension observation statistics, pooled by the
        # driver across workers: (count, sum, sum-of-squares)
        obs_dim = self.env.obs_dim
        self.obs_count = 0
        self.obs_sum = np.zeros(obs_dim)
        self.obs_sumsq = np.zeros(obs_dim)

    def _act(self, theta, obs):
        out = _forward_flat(theta, self.shapes, obs)
        if self.discrete:
            return int(np.argmax(out))
        a = np.tanh(out)
        if self.low is not None:
            a = self.low + (a + 1.0) * 0.5 * (self.high - self.low)
        return a

    def _episode(self, theta, max_steps, ob_mean, ob_std):
        obs = self.env.reset()
        total, steps = 0.0, 0
        for _ in range(max_steps):
            o = np.asarray(obs, dtype=np.float64)
            self.obs_count += 1
            self.obs_sum += o
            self.obs_sumsq += o * o
            if ob_std is not None:
                o = (o - ob_mean) / ob_std
            obs, reward, done, _ = self.env.step(self._act(theta, o))
            total += reward
            steps += 1
            if done:
                break
        return total, steps

    def _fitness(self, theta, episodes, max_steps, ob_mean, ob_std):
        """Mean return over ``episodes`` episodes (averaging smooths
        noisy one-step envs; full-episode envs keep episodes=1)."""
        total, steps = 0.0, 0
        for _ in range(episodes):
            r, s = self._episode(theta, max_steps, ob_mean, ob_std)
            total += r
            steps += s
        return total / episodes, steps

    def do_rollouts(self, theta, num_pairs, sigma, max_steps,
                    ob_stats=None, episodes_per_direction=1):
        """Antithetic evaluation of ``num_pairs`` noise directions.

        Returns (noise_indices, returns+, returns-, steps, obs_stats).
        """
        theta = np.asarray(theta, dtype=np.float32)
        ob_mean = ob_std = None
        if ob_stats is not None:
            ob_mean, ob_std = ob_stats
        idxs, pos, neg, steps = [], [], [], 0
        for _ in range(num_pairs):
            i = int(self.rng.integers(0, len(self.noise) - self.dim))
            eps = self.noise[i:i + self.dim]
            r_pos, s1 = self._fitness(theta + sigma * eps,
                                      episodes_per_direction, max_steps,
                                      ob_mean, ob_std)
            r_neg, s2 = self._fitness(theta - sigma * eps,
                                      episodes_per_direction, max_steps,
                                      ob_mean, ob_std)
            idxs.append(i)
            pos.append(r_pos)
            neg.append(r_neg)
            steps += s1 + s2
        return (np.asarray(idxs), np.asarray(pos), np.asarray(neg),
                steps, (self.obs_count, self.obs_sum, self.obs_sumsq))

    def eval_policy(self, theta, episodes, max_steps, ob_stats=None):
        theta = np.asarray(theta, dtype=np.float32)
        ob_mean = ob_std = None
        if ob_stats is not None:
            ob_mean, ob_std = ob_stats
        return [self._episode(theta, max_steps, ob_mean, ob_std)[0]
                for _ in range(episodes)]


def _centered_ranks(x):
    """Map fitness values to centered ranks in [-0.5, 0.5] (ES trick that
    makes the estimator invariant to reward scaling)."""
    flat = x.ravel()
    ranks = np.empty(len(flat), dtype=np.float32)
    ranks[flat.argsort()] = np.arange(len(flat), dtype=np.float32)
    ranks = ranks.reshape(x.shape)
    if len(flat) > 1:
        ranks = ranks / (len(flat) - 1) - 0.5
    return ranks


# ---------------------------------------------------------------------------
# ES
# ---------------------------------------------------------------------------

@dataclass
class ESConfig:
    env: str = "CartPole-v1"
    num_rollout_workers: int = 2
    episodes_per_batch: int = 16     # antithetic pairs per iteration
    sigma: float = 0.1               # perturbation stddev
    lr: float = 0.02
    l2_coeff: float = 0.005
    hidden: int = 32                 # <=0 -> linear policy
    max_episode_steps: int = 500
    episodes_per_direction: int = 1  # fitness = mean over this many eps
    seed: int = 0

    def environment(self, env):
        return replace(self, env=env)

    def rollouts(self, *, num_rollout_workers=None):
        if num_rollout_workers is None:
            return self
        return replace(self, num_rollout_workers=num_rollout_workers)

    def training(self, **kw):
        return replace(self, **kw)

    def build(self):
        return ES(self)


class ES:
    """OpenAI-style Evolution Strategies driver."""

    _normalize_obs = False

    def __init__(self, config):
        self.config = config
        env = make_env(config.env, seed=config.seed)
        self.discrete = hasattr(env, "n_actions")
        n_out = env.n_actions if self.discrete else env.action_dim
        self.low = getattr(env, "action_low", -1.0)
        self.high = getattr(env, "action_high", 1.0)
        self.shapes = _policy_shapes(env.obs_dim, n_out, config.hidden)
        self.dim = _flat_size(self.shapes)
        rng = np.random.default_rng(config.seed)
        self.theta = (rng.standard_normal(self.dim) /
                      np.sqrt(env.obs_dim)).astype(np.float32) * 0.1
        self.noise = make_noise_table(seed=config.seed + 99)
        self.workers = [
            _FitnessWorker(config.env, config.seed + 7 * (i + 1),
                           self.noise, self.shapes, self.discrete,
                           None if self.discrete else self.low,
                           None if self.discrete else self.high)
            for i in range(config.num_rollout_workers)
        ]
        self.iteration = 0
        self.total_steps = 0
        # Adam state for the gradient step
        self._m = np.zeros(self.dim, dtype=np.float32)
        self._v = np.zeros(self.dim, dtype=np.float32)
        self._obs_stats = None

    def _gradient(self, idxs, pos, neg):
        ranks = _centered_ranks(np.stack([pos, neg], axis=1))
        weights = ranks[:, 0] - ranks[:, 1]
        grad = np.zeros(self.dim, dtype=np.float32)
        for w, i in zip(weights, idxs):
            grad += w * self.noise[i:i + self.dim]
        grad /= (len(idxs) * self.config.sigma)
        return grad - self.config.l2_coeff * self.theta

    def _adam_step(self, grad):
        cfg = self.config
        t = self.iteration + 1
        self._m = 0.9 * self._m + 0.1 * grad
        self._v = 0.999 * self._v + 0.001 * grad * grad
        mhat = self._m / (1 - 0.9 ** t)
        vhat = self._v / (1 - 0.999 ** t)
        self.theta = self.theta + cfg.lr * mhat / (np.sqrt(vhat) + 1e-8)

    def train(self) -> dict:
        cfg = self.config
        per = max(1, cfg.episodes_per_batch // len(self.workers))
        outs = [
            w.do_rollouts(self.theta, per, cfg.sigma, cfg.max_episode_steps,
                          self._obs_stats if self._normalize_obs else None,
                          cfg.episodes_per_direction)
            for w in self.workers
        ]
        idxs = np.concatenate([o[0] for o in outs])
        pos = np.concatenate([o[1] for o in outs])
        neg = np.concatenate([o[2] for o in outs])
        self.total_steps += sum(o[3] for o in outs)
        if self._normalize_obs:
            count = sum(o[4][0] for o in outs)
            if count > 1:
                total = np.sum([o[4][1] for o in outs], axis=0)
                sumsq = np.sum([o[4][2] for o in outs], axis=0)
                mean = total / count
                var = np.maximum(sumsq / count - mean * mean, 1e-8)
                self._obs_stats = (mean, np.sqrt(var))
        self._update(idxs, pos, neg)
        self.iteration += 1
        rets = np.concatenate([pos, neg])
        return {
            "training_iteration": self.iteration,
            "episode_return_mean": float(rets.mean()),
            "episode_return_max": float(rets.max()),
            "num_env_steps_sampled": self.total_steps,
            "theta_norm": float(np.linalg.norm(self.theta)),
        }

    def _update(self, idxs, pos, neg):
        self._adam_step(self._gradient(idxs, pos, neg))

    def evaluate(self, num_episodes: int = 8) -> dict:
        per = max(1, num_episodes // len(self.workers))
        rets = [r for w in self.workers
                for r in w.eval_policy(self.theta, per,
                                       self.config.max_episode_steps,
                                       self._obs_stats)]
        return {"episode_return_mean": float(np.mean(rets))}

    def compute_action(self, obs):
        o = np.asarray(obs, dtype=np.float64)
        if self._obs_stats is not None:
            o = (o - self._obs_stats[0]) / self._obs_stats[1]
        out = _forward_flat(self.theta, self.shapes, o)
        if self.discrete:
            return int(np.argmax(out))
        # same squash+rescale the rollout workers act with
        a = np.tanh(out)
        return self.low + (a + 1.0) * 0.5 * (self.high - self.low)

    def save(self, path: str):
        np.savez(path, theta=self.theta)

    def restore(self, path: str):
        if not path.endswith(".npz"):
            path += ".npz"
        self.theta = np.load(path)["theta"]

    def stop(self):
        pass


# ---------------------------------------------------------------------------
# ARS
# ---------------------------------------------------------------------------

@dataclass
class ARSConfig(ESConfig):
    hidden: int = 0            # ARS default: linear policy
    top_k: int = 8             # directions kept for the update
    lr: float = 0.05

    def build(self):
        return ARS(self)


class ARS(ES):
    """Augmented Random Search (V2: top-k directions + reward-std step
    normalization; observation normalization via pooled worker stats)."""

    _normalize_obs = True

    def _update(self, idxs, pos, neg):
        cfg = self.config
        k = min(cfg.top_k, len(idxs))
        best = np.argsort(-np.maximum(pos, neg))[:k]
        r_std = np.concatenate([pos[best], neg[best]]).std() + 1e-8
        step = np.zeros(self.dim, dtype=np.float32)
        for j in best:
            step += (pos[j] - neg[j]) * self.noise[idxs[j]:idxs[j] + self.dim]
        self.theta = self.theta + cfg.lr / (k * r_std) * step
