"""Offline RL: logged-experience IO + algorithms that train from it.

Port of ``ray_tpu/rllib/offline.py`` (reference analog: ``rllib/offline/``:
JsonWriter/JsonReader sample-batch IO, BC/CQL/MARWIL offline algorithms).
The IO is numpy, copied verbatim, so each package reads the other's
``.npz`` shards and ``meta.json``. The learners step their module on the
card (``device``, default "cuda") unless the config asks for the CPU.

- :class:`DatasetWriter` / :class:`OfflineDataset` — shard transitions
  to a directory / load + minibatch them.
- ``collect_dataset`` — roll a behavior policy in an env and persist.
- :class:`BC` — behavior cloning (maximize log pi(a|s) on the data).
- :class:`CQL` — discrete conservative Q-learning: DQN TD loss plus the
  CQL(H) regularizer alpha * (logsumexp_a Q(s,a) - Q(s, a_data)) that
  penalizes out-of-distribution action values.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass, replace
from functools import partial

import numpy as np
import torch

from ray_tpu_torch._device import resolve_device
from ray_tpu_torch.rllib.dqn import (adam_step, copy_into, frozen_copy,
                                     init_qnet, q_forward, to_device)
from ray_tpu_torch.rllib.env import make_env
from ray_tpu_torch.rllib.ppo import adam, init_module, logp_of

_FIELDS = ("obs", "actions", "rewards", "next_obs", "dones")


class DatasetWriter:
    """Append transition batches as columnar .npz shards."""

    def __init__(self, path: str, shard_size: int = 4096):
        self.path = path
        self.shard_size = shard_size
        os.makedirs(path, exist_ok=True)
        self._buf: dict[str, list] = {k: [] for k in _FIELDS}
        self._buffered = 0
        self._n_shards = 0

    def write(self, batch: dict):
        n = len(batch["obs"])
        for k in _FIELDS:
            self._buf[k].append(np.asarray(batch[k]))
        self._buffered += n
        while self._buffered >= self.shard_size:
            self._flush_shard()

    def _cat(self):
        return {k: np.concatenate(v) if v else np.zeros((0,))
                for k, v in self._buf.items()}

    def _flush_shard(self):
        cat = self._cat()
        head = {k: v[:self.shard_size] for k, v in cat.items()}
        rest = {k: [v[self.shard_size:]] for k, v in cat.items()}
        self._write_file(head)
        self._buf = rest
        self._buffered = len(rest["obs"][0])

    def _write_file(self, arrays: dict):
        fname = os.path.join(self.path, f"shard-{self._n_shards:05d}.npz")
        np.savez_compressed(fname, **arrays)
        self._n_shards += 1

    def close(self):
        if self._buffered:
            self._write_file(self._cat())
            self._buf = {k: [] for k in _FIELDS}
            self._buffered = 0
        meta = {"num_shards": self._n_shards, "fields": list(_FIELDS)}
        with open(os.path.join(self.path, "meta.json"), "w") as f:
            json.dump(meta, f)


class OfflineDataset:
    """Load every shard in a directory into columnar arrays."""

    def __init__(self, path: str):
        shards = sorted(
            f for f in os.listdir(path) if f.endswith(".npz"))
        if not shards:
            raise FileNotFoundError(f"no .npz shards under {path}")
        cols: dict[str, list] = {k: [] for k in _FIELDS}
        for s in shards:
            with np.load(os.path.join(path, s)) as z:
                for k in _FIELDS:
                    cols[k].append(z[k])
        self.data = {k: np.concatenate(v) for k, v in cols.items()}
        self.size = len(self.data["obs"])

    def minibatches(self, batch_size: int, rng: np.random.Generator):
        idx = rng.permutation(self.size)
        for start in range(0, self.size - batch_size + 1, batch_size):
            sel = idx[start:start + batch_size]
            yield {k: v[sel] for k, v in self.data.items()}


def collect_dataset(env_name, path: str, *, num_steps: int,
                    policy=None, seed: int = 0) -> str:
    """Roll a behavior policy (default: uniform random) and persist the
    transitions — the offline-RL input fixture (reference:
    ``rllib/offline/json_writer.py`` usage in offline examples)."""
    env = make_env(env_name, seed=seed)
    rng = np.random.default_rng(seed)
    if policy is None:
        def policy(obs):
            return int(rng.integers(env.n_actions))
    writer = DatasetWriter(path)
    obs = env.reset()
    rows = {k: [] for k in _FIELDS}
    for _ in range(num_steps):
        action = policy(obs)
        next_obs, reward, done, _ = env.step(action)
        rows["obs"].append(obs)
        rows["actions"].append(action)
        rows["rewards"].append(reward)
        rows["next_obs"].append(next_obs)
        rows["dones"].append(float(done))
        obs = env.reset() if done else next_obs
    writer.write({k: np.asarray(v) for k, v in rows.items()})
    writer.close()
    return path


# ---------------------------------------------------------------------------
# Behavior cloning
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class BCConfig:
    env: str = "CartPole-v1"      # only for obs/action space + evaluation
    input_path: str = ""
    lr: float = 1e-3
    train_batch_size: int = 256
    hidden: int = 64
    seed: int = 0
    # the learner's device ("cpu" only when asked for)
    device: str = "cuda"

    def environment(self, env) -> "BCConfig":
        return replace(self, env=env)

    def offline_data(self, input_path: str) -> "BCConfig":
        return replace(self, input_path=input_path)

    def training(self, **kw) -> "BCConfig":
        return replace(self, **kw)

    def build(self) -> "BC":
        return BC(self)


def _bc_update(params, opt_state, batch, *, tx) -> torch.Tensor:
    """Behavior cloning's step (``ray_tpu/rllib/offline.py:171-181``), in
    place: the negative log-likelihood of the logged actions."""
    logits, _ = params(batch["obs"])
    loss = -logp_of(torch.log_softmax(logits, dim=-1),
                    batch["actions"]).mean()
    adam_step(tx, opt_state, list(params.parameters()), loss)
    return loss.detach()


def _greedy(params, obs, device) -> int:
    """The greedy action of the module's first head at ``obs``."""
    with torch.no_grad():
        logits, _ = params(torch.as_tensor(
            np.asarray(obs, np.float32)[None], device=device))
    return int(torch.argmax(logits[0]))


def _evaluate(algo, num_episodes: int) -> dict:
    env = make_env(algo.config.env, seed=algo.config.seed + 999)
    returns = []
    for _ in range(num_episodes):
        obs, done, total = env.reset(), False, 0.0
        while not done:
            obs, r, done, _ = env.step(algo.compute_action(obs))
            total += r
        returns.append(total)
    return {"episode_return_mean": float(np.mean(returns))}


class BC:
    """Behavior cloning: supervised log-likelihood on logged actions
    (reference: ``rllib/algorithms/bc``)."""

    def __init__(self, config: BCConfig):
        self.config = config
        self.device = resolve_device(config.device)
        env = make_env(config.env, seed=config.seed)
        self.params = init_module(config.seed, env.obs_dim, env.n_actions,
                                  config.hidden, device=self.device)
        self.tx = adam(config.lr)
        self.opt_state = self.tx.init(dict(self.params.named_parameters()))
        self.dataset = OfflineDataset(config.input_path)
        self.rng = np.random.default_rng(config.seed)
        self.iteration = 0
        self._update = partial(_bc_update, tx=self.tx)

    def train(self) -> dict:
        """One epoch over the dataset."""
        losses = [self._update(self.params, self.opt_state,
                               to_device(batch, self.device))
                  for batch in self.dataset.minibatches(
                      self.config.train_batch_size, self.rng)]
        losses = torch.stack(losses).tolist() if losses else []
        self.iteration += 1
        return {"training_iteration": self.iteration,
                "loss": float(np.mean(losses)) if losses else float("nan"),
                "num_samples_trained": self.dataset.size}

    def compute_action(self, obs) -> int:
        return _greedy(self.params, obs, self.device)

    def evaluate(self, num_episodes: int = 10) -> dict:
        return _evaluate(self, num_episodes)

    def stop(self):
        pass


# ---------------------------------------------------------------------------
# Conservative Q-learning (discrete)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class CQLConfig:
    env: str = "CartPole-v1"
    input_path: str = ""
    lr: float = 1e-3
    gamma: float = 0.99
    train_batch_size: int = 256
    cql_alpha: float = 1.0        # weight of the conservative regularizer
    target_update_every: int = 8  # minibatches between target syncs
    hidden: int = 64
    seed: int = 0
    # the learner's device ("cpu" only when asked for)
    device: str = "cuda"

    def environment(self, env) -> "CQLConfig":
        return replace(self, env=env)

    def offline_data(self, input_path: str) -> "CQLConfig":
        return replace(self, input_path=input_path)

    def training(self, **kw) -> "CQLConfig":
        return replace(self, **kw)

    def build(self) -> "CQL":
        return CQL(self)


def _cql_update(params, opt_state, target_params, batch, *, tx, gamma,
                alpha) -> tuple:
    """CQL(H)'s step (``ray_tpu/rllib/offline.py:273-293``), in place: the
    TD(0) loss against the target network plus ``alpha *
    (logsumexp_a Q(s,a) - Q(s, a_data))``. Returns (loss, td, cql)."""
    q = q_forward(params, batch["obs"])                       # [B, A]
    q_data = q.gather(1, batch["actions"].long()[:, None])[:, 0]
    with torch.no_grad():
        q_next = q_forward(target_params, batch["next_obs"])
        target = batch["rewards"] + gamma * (
            1.0 - batch["dones"]) * q_next.max(dim=1).values
    td = torch.mean((q_data - target) ** 2)
    conservative = torch.mean(torch.logsumexp(q, dim=1) - q_data)
    loss = td + alpha * conservative
    adam_step(tx, opt_state, list(params.parameters()), loss)
    return loss.detach(), td.detach(), conservative.detach()


class CQL:
    """Discrete CQL(H) (reference: ``rllib/algorithms/cql``): standard
    TD(0) target plus ``alpha * (logsumexp_a Q(s,a) - Q(s, a_data))`` —
    Q-values of actions the dataset never took are pushed down, so the
    greedy policy stays inside the data distribution. The target network
    syncs every ``target_update_every`` minibatches, counted across
    epochs."""

    def __init__(self, config: CQLConfig):
        self.config = config
        self.device = resolve_device(config.device)
        env = make_env(config.env, seed=config.seed)
        self.params = init_qnet(config.seed, env.obs_dim, env.n_actions,
                                config.hidden, device=self.device)
        self.target_params = frozen_copy(self.params)
        self.tx = adam(config.lr)
        self.opt_state = self.tx.init(dict(self.params.named_parameters()))
        self.dataset = OfflineDataset(config.input_path)
        self.rng = np.random.default_rng(config.seed)
        self.iteration = 0
        self._updates = 0
        self._update = partial(_cql_update, tx=self.tx, gamma=config.gamma,
                               alpha=config.cql_alpha)

    def train(self) -> dict:
        stats = []
        for batch in self.dataset.minibatches(
                self.config.train_batch_size, self.rng):
            stats.append(torch.stack(self._update(
                self.params, self.opt_state, self.target_params,
                to_device(batch, self.device))))
            self._updates += 1
            if self._updates % self.config.target_update_every == 0:
                copy_into(self.target_params, self.params)
        losses, tds, conss = (zip(*torch.stack(stats).tolist()) if stats
                              else ([], [], []))
        self.iteration += 1
        return {"training_iteration": self.iteration,
                "loss": float(np.mean(losses)) if losses else float("nan"),
                "td_loss": float(np.mean(tds)) if tds else float("nan"),
                "cql_loss": float(np.mean(conss)) if conss else
                float("nan"),
                "num_samples_trained": self.dataset.size}

    def compute_action(self, obs) -> int:
        return _greedy(self.params, obs, self.device)

    def evaluate(self, num_episodes: int = 10) -> dict:
        return _evaluate(self, num_episodes)

    def stop(self):
        pass


# re-exported field list for writers built outside collect_dataset
FIELDS = _FIELDS
